"""Port decoder (lexicon, hypothesis unit step, CTC prefix-beam search) vs
the JAX package, on the CPU.

Both packages expand the same beams with the same per-frame log-probs
(made with numpy from a seed) over the same lexicon and bigram LM.
Per frame, the integer state (hash, node, tokens, words, counts) must
be equal exactly; pb/pnb are allclose at rtol 1e-5 (exp/log differ by an
ulp across frameworks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.tds_asr import DecoderConfig as JaxDecoderConfig  # noqa: E402
from repro.core import decoder as jdec  # noqa: E402
from repro.core import hypothesis as jhyp  # noqa: E402
from repro.core import lexicon as jlx  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.configs.tds_asr import DecoderConfig  # noqa: E402
from repro_torch.core import decoder as tdec  # noqa: E402
from repro_torch.core import hypothesis as thyp  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402

torch.set_num_threads(1)

WORDS = {f"w{i}": [1 + (i * 3 + j) % 30 for j in range(2 + i % 3)]
         for i in range(12)}
EXACT = ("hash", "node", "lm_state", "last_token", "tokens", "n_tokens",
         "words", "n_words")


def _systems(beam, k, lm_counts=None):
    jlex = jlx.build_lexicon(WORDS, max_children=16)
    tlex = tlx.build_lexicon(WORDS, max_children=16)
    if lm_counts is None:
        jlm, tlm = jlx.uniform_bigram(len(WORDS)), tlx.uniform_bigram(len(WORDS))
    else:
        jlm = jlx.bigram_from_counts(lm_counts)
        tlm = tlx.bigram_from_counts(lm_counts)
    jcfg = JaxDecoderConfig(beam_size=k, beam_threshold=beam)
    tcfg = DecoderConfig(beam_size=k, beam_threshold=beam)
    return (jlex, jlm, jcfg), (tlex, tlm, tcfg)


def _log_probs(seed, *shape):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


def _assert_state_equal(got, want, where=""):
    for name in EXACT:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{where} {name}")
    for name in ("pb", "pnb"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=0,
                                   err_msg=f"{where} {name}")


def test_lexicon_and_bigram_match_jax():
    (jlex, jlm, _), (tlex, tlm, _) = _systems(25.0, 16)
    for f in ("children", "child_token", "word_id"):
        np.testing.assert_array_equal(getattr(tlex, f).numpy(),
                                      np.asarray(getattr(jlex, f)))
    assert (tlex.n_nodes, tlex.max_children) == (jlex.n_nodes,
                                                 jlex.max_children)
    np.testing.assert_array_equal(tlm.table.numpy(), np.asarray(jlm.table))
    counts = np.random.RandomState(0).randint(0, 5, (13, 12))
    np.testing.assert_array_equal(tlx.bigram_from_counts(counts).table.numpy(),
                                  np.asarray(jlx.bigram_from_counts(counts).table))
    moved = tlx.Lexicon.from_numpy(*(np.asarray(getattr(jlex, f)) for f in
                                     ("children", "child_token", "word_id")),
                                   jlex.n_nodes, jlex.max_children)
    assert torch.equal(moved.children, tlex.children)
    with pytest.raises(ValueError, match="fanout"):
        tlx.build_lexicon({f"x{i}": [i + 1] for i in range(5)}, max_children=4)


def test_mix_matches_int32_wraparound():
    r = np.random.RandomState(0)
    h = r.randint(0, 2**31 - 1, 4096).astype(np.int32)
    x = r.randint(0, 20000, 4096).astype(np.int32)
    want = np.asarray(jdec._mix(jnp.asarray(h), jnp.asarray(x)))
    got = tdec._mix(torch.from_numpy(h), torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,k", [(30, 8), (6, 12)])
def test_hypothesis_unit_step_batched_matches_jax(n, k):
    """Payload gathering around the fused op, with padding when k > N."""
    r = np.random.RandomState(n)
    h = r.randint(0, n // 2 + 1, (2, n)).astype(np.int32)
    pb = (r.randn(2, n) * 3).astype(np.float32)
    pnb = (r.randn(2, n) * 3).astype(np.float32)
    node = np.arange(2 * n, dtype=np.int32).reshape(2, n)
    hist = r.randint(0, 9, (2, n, 3)).astype(np.int32)
    want = jhyp.hypothesis_unit_step_batched(
        jhyp.Candidates(jnp.asarray(h), jnp.asarray(pb), jnp.asarray(pnb),
                        {"node": jnp.asarray(node), "hist": jnp.asarray(hist)}),
        k, 5.0, JaxPolicy("ref"))
    got = thyp.hypothesis_unit_step_batched(
        thyp.Candidates(torch.from_numpy(h), torch.from_numpy(pb),
                        torch.from_numpy(pnb),
                        {"node": torch.from_numpy(node),
                         "hist": torch.from_numpy(hist)}), k, 5.0)
    for key in ("hash", "node", "hist", "valid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    for key in ("pb", "pnb"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=0, err_msg=key)


@pytest.mark.parametrize("batch,k,beam,lm", [(1, 16, 25.0, False),
                                             (3, 24, 8.0, True)])
def test_expand_step_batched_per_frame_matches_jax(batch, k, beam, lm):
    counts = (np.random.RandomState(1).randint(0, 6, (13, 12))
              if lm else None)
    (jlex, jlm, jcfg), (tlex, tlm, tcfg) = _systems(beam, k, counts)
    step = jax.jit(lambda s, lp: jdec.expand_step_batched(
        s, lp, jlex, jlm, jcfg, JaxPolicy("ref")))
    js = jdec.init_batched_state(batch, k, jlm)
    ts = tdec.init_batched_state(batch, k, tlm)
    _assert_state_equal(ts, js, "init")
    lps = _log_probs(batch * 7 + k, 14, batch, 32)
    for t, lp in enumerate(lps):
        js = step(js, jnp.asarray(lp))
        ts = tdec.expand_step_batched(ts, torch.from_numpy(lp), tlex, tlm,
                                      tcfg)
        _assert_state_equal(ts, js, f"frame {t}")
    assert int(np.asarray(js.n_words).max()) > 0       # words were committed
    jfin = jax.vmap(lambda s: jdec.finalize(s, jlex, jlm, jcfg))(js)
    tfin = tdec.finalize(ts, tlex, tlm, tcfg)
    _assert_state_equal(tfin, jfin, "finalize")
    for b in range(batch):
        want = jdec.materialize_best(jdec.best(jdec.slot_state(jfin, b)))
        got = tdec.materialize_best(tdec.best(tdec.slot_state(tfin, b)))
        np.testing.assert_array_equal(got["words"], want["words"])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["score"] == pytest.approx(want["score"], rel=1e-5)


def test_decode_matches_decode_batched_and_slot_reset():
    _, (tlex, tlm, tcfg) = _systems(25.0, 16)
    lps = torch.from_numpy(_log_probs(3, 2, 10, 32))
    batched = tdec.decode_batched(lps, tlex, tlm, tcfg)
    for b in range(2):
        single = tdec.decode(lps[b], tlex, tlm, tcfg)
        for name in EXACT + ("pb", "pnb"):
            assert torch.equal(getattr(single, name),
                               getattr(tdec.slot_state(batched, b), name)), name
    reset = tdec.reset_slot(batched, 1, tlm)
    fresh = tdec.init_state(16, tlm)
    for name in EXACT + ("pb", "pnb"):
        assert torch.equal(getattr(reset, name)[1], getattr(fresh, name))
        assert torch.equal(getattr(reset, name)[0],
                           getattr(batched, name)[0])
