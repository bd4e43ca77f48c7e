"""The port's ASR-core functions off the serving path vs the JAX package,
on the CPU: the legacy hypothesis-unit stages (`merge_duplicates`,
`select`), the decoder readouts (`greedy_decode`, `finalize_batched`,
`best_hypothesis`), the dynamic features (`deltas`, `mfcc_with_deltas`)
and `tds.state_bytes`.

Inputs are made with numpy from a seed and fed to both packages.
Tolerances:
  * hypothesis stages: hash/valid/payload exact, pb/pnb rtol 1e-5 (exp
    and log differ by an ulp across frameworks);
  * greedy_decode: exact;
  * decoder readouts: words and tokens equal, scores rtol 1e-4 (the
    beam's scores are sums over every frame of the decode);
  * deltas, mfcc_with_deltas: rtol 1e-4, atol 1e-3, as for mfcc (two FFT
    libraries, then a log domain).
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.tds_asr import FEATURE_CONFIG, TDS_CONFIG  # noqa: E402
from repro.core import decoder as jdec  # noqa: E402
from repro.core import features as jfeat  # noqa: E402
from repro.core import hypothesis as jhyp  # noqa: E402
from repro.data.pipeline import SyntheticASR  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro.launch.serve import asr_demo_system  # noqa: E402
from repro.models import tds as jtds  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import decoder as tdec  # noqa: E402
from repro_torch.core import features as tfeat  # noqa: E402
from repro_torch.core import hypothesis as thyp  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402

torch.set_num_threads(1)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# legacy hypothesis-unit stages
# ---------------------------------------------------------------------------
def _candidates(seed, n, dup_rate=0.5, dead_rate=0.2):
    """One candidate row with forced duplicate hashes and dead entries
    (the generator of tests/test_hypothesis_unit.py) and a payload."""
    r = np.random.RandomState(seed)
    n_hash = max(1, int(n * (1.0 - dup_rate)))
    h = r.randint(0, n_hash, n).astype(np.int32)
    pb = (r.randn(n) * 3).astype(np.float32)
    pnb = (r.randn(n) * 3).astype(np.float32)
    dead = r.rand(n) < dead_rate
    pb = np.where(dead, NEG_INF, pb).astype(np.float32)
    pnb = np.where(dead, NEG_INF, pnb).astype(np.float32)
    node = np.arange(n, dtype=np.int32)
    return (jhyp.Candidates(jnp.asarray(h), jnp.asarray(pb), jnp.asarray(pnb),
                            {"node": jnp.asarray(node)}),
            thyp.Candidates(torch.from_numpy(h), torch.from_numpy(pb),
                            torch.from_numpy(pnb),
                            {"node": torch.from_numpy(node)}))


def _assert_sets_equal(got, want, exact=("hash", "node", "valid")):
    for key in exact:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("pb", "pnb"):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   rtol=1e-5, atol=0, err_msg=key)


CASES = [(0, 30, 8, 5.0), (1, 50, 12, 2.0), (2, 6, 12, 1e9)]


@pytest.mark.parametrize("seed,n,k,beam", CASES)
def test_merge_duplicates_matches_jax(seed, n, k, beam):
    jc, tc = _candidates(seed, n)
    want = jhyp.merge_duplicates(jc)
    got = thyp.merge_duplicates(tc)
    assert torch.equal(got.hash, tc.hash) and got.fields is tc.fields
    for name in ("pb", "pnb"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=0, err_msg=name)
    # one representative per live hash: its first occurrence
    live = thyp.total_score(got.pb, got.pnb) > NEG_INF / 2
    h = tc.hash.numpy()
    valid_in = (thyp.total_score(tc.pb, tc.pnb) > NEG_INF / 2).numpy()
    firsts = {int(x): i for i, x in reversed(list(enumerate(h)))
              if valid_in[i]}
    assert sorted(np.flatnonzero(live.numpy()).tolist()) == \
        sorted(firsts.values())


@pytest.mark.parametrize("seed,n,k,beam", CASES)
def test_select_matches_jax(seed, n, k, beam):
    jc, tc = _candidates(seed, n)
    want = jhyp.select(jhyp.merge_duplicates(jc), k, beam)
    got = thyp.select(thyp.merge_duplicates(tc), k, beam)
    assert got["valid"].dtype == torch.bool and got["hash"].shape == (k,)
    _assert_sets_equal({key: v.numpy() for key, v in got.items()}, want)


@pytest.mark.parametrize("seed,n,k,beam", CASES)
def test_fused_step_matches_legacy_pipeline(seed, n, k, beam):
    """hypothesis_unit_step (fused) == merge_duplicates -> select (legacy)
    on the valid slots, up to the float error of the merge order."""
    _, tc = _candidates(seed, n)
    fused = thyp.hypothesis_unit_step(tc, k, beam)
    legacy = thyp.select(thyp.merge_duplicates(tc), k, beam)
    assert torch.equal(fused["valid"], legacy["valid"])
    v = fused["valid"].numpy()
    _assert_sets_equal({key: a.numpy()[v] for key, a in fused.items()},
                       {key: a.numpy()[v] for key, a in legacy.items()},
                       exact=("hash", "node"))


def test_valid_candidate_with_sentinel_hash_survives_merge():
    """A live candidate whose 31-bit hash equals 2**31 - 1 is merged with
    its duplicate, not keyed onto the dead candidates' sentinel."""
    h = torch.tensor([2**31 - 1, 5, 2**31 - 1], dtype=torch.int32)
    pb = torch.tensor([-1.0, -2.0, NEG_INF])
    pnb = torch.tensor([-0.5, NEG_INF, -3.0])
    c = thyp.Candidates(h, pb, pnb, {})
    m = thyp.merge_duplicates(c)
    tot = thyp.total_score(m.pb, m.pnb).numpy()
    live = tot > NEG_INF / 2
    assert live.sum() == 2
    want = np.logaddexp(np.logaddexp(-1.0, -0.5), -3.0)
    assert abs(tot[live & (h.numpy() == 2**31 - 1)][0] - want) < 1e-4
    sel = thyp.hypothesis_unit_step(c, 2, 1e9)
    assert sel["valid"].all()
    assert set(sel["hash"].tolist()) == {2**31 - 1, 5}
    legacy = thyp.select(m, 2, 1e9)
    assert set(legacy["hash"].tolist()) == {2**31 - 1, 5}


def test_dead_candidates_never_merge_with_sentinel_hash():
    h = torch.full((6,), 2**31 - 1, dtype=torch.int32)
    pb = torch.tensor([-1.0] + [NEG_INF] * 5)
    pnb = torch.full((6,), NEG_INF)
    c = thyp.Candidates(h, pb, pnb, {})
    for sel in (thyp.hypothesis_unit_step(c, 3, 1e9),
                thyp.select(thyp.merge_duplicates(c), 3, 1e9)):
        assert sel["valid"].tolist() == [True, False, False]
        assert abs(float(sel["pb"][0]) - (-1.0)) < 1e-5


# ---------------------------------------------------------------------------
# decoder readouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,t,v", [(0, 40, 6), (1, 1, 4), (2, 200, 32),
                                      (3, 25, 2)])
def test_greedy_decode_matches_jax(seed, t, v):
    r = np.random.RandomState(seed)
    # runs of repeated best tokens and blanks, as a CTC output has
    ids = np.repeat(r.randint(0, v, t), r.randint(1, 4, t))[:t]
    lp = r.randn(t, v).astype(np.float32)
    lp[np.arange(t), ids] += 5.0
    want = np.asarray(jdec.greedy_decode(jnp.asarray(lp)))
    got = tdec.greedy_decode(torch.from_numpy(lp))
    assert got.dtype == torch.int32 and got.shape == (t,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tdec.greedy_decode(torch.from_numpy(lp), blank_id=1).numpy(),
        np.asarray(jdec.greedy_decode(jnp.asarray(lp), blank_id=1)))


@pytest.fixture(scope="module")
def demo_decode():
    """Two streams of the JAX demo system decoded by both packages from
    the same log-probs: the demo acoustic model's on two SyntheticASR
    utterances, cut to a common length."""
    tds_cfg, words, lex, lm, params, dec = asr_demo_system()
    dec = replace(dec, beam_threshold=25.0)
    data = SyntheticASR(words)
    lps = []
    for u in range(2):
        feats = jfeat.mfcc(jnp.asarray(data.utterance(u)["audio"]),
                           FEATURE_CONFIG)
        feats = feats[:feats.shape[0] // 8 * 8]
        lp, _ = jtds.forward(params, tds_cfg, feats, kernels=JaxPolicy("ref"))
        lps.append(np.asarray(lp))
    t = min(a.shape[0] for a in lps)
    lps = np.stack([a[:t] for a in lps])
    jstate = jdec.decode_batched(jnp.asarray(lps), lex, lm, dec,
                                 kernels=JaxPolicy("ref"))
    t_lex = tlx.Lexicon.from_numpy(np.asarray(lex.children),
                                   np.asarray(lex.child_token),
                                   np.asarray(lex.word_id), lex.n_nodes,
                                   lex.max_children)
    t_lm = tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words)
    t_dec = tcfg.DecoderConfig(**dec.__dict__)
    tstate = tdec.decode_batched(torch.from_numpy(lps), t_lex, t_lm, t_dec)
    return (jstate, lex, lm, dec), (tstate, t_lex, t_lm, t_dec)


def test_finalize_batched_matches_jax(demo_decode):
    (js, jlex, jlm, jcfg), (ts, tlex, tlm, tc) = demo_decode
    want = jdec.finalize_batched(js, jlex, jlm, jcfg)
    got = tdec.finalize_batched(ts, tlex, tlm, tc)
    for name in ("hash", "node", "lm_state", "last_token", "tokens",
                 "n_tokens", "words", "n_words"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("pb", "pnb"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=0, err_msg=name)
    # the utterances end inside a word: finalize commits something
    assert not torch.equal(got.n_words, ts.n_words)


@pytest.mark.parametrize("final", [False, True])
def test_best_hypothesis_matches_jax(demo_decode, final):
    (js, jlex, jlm, jcfg), (ts, tlex, tlm, tc) = demo_decode
    for b in range(ts.hash.shape[0]):
        want = jdec.best_hypothesis(jdec.slot_state(js, b), jlex, jlm, jcfg,
                                    final=final)
        before = ts.pb.clone()
        got = tdec.best_hypothesis(tdec.slot_state(ts, b), tlex, tlm, tc,
                                   final=final)
        assert torch.equal(ts.pb, before)          # the state is unchanged
        assert got["words"].dtype == np.int32
        np.testing.assert_array_equal(got["words"], want["words"])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["score"] == pytest.approx(want["score"], rel=1e-4)


# ---------------------------------------------------------------------------
# dynamic features and stream-state size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t,c,window", [(10, 80, 2), (1, 5, 2), (33, 7, 3)])
def test_deltas_match_jax(t, c, window):
    x = np.random.RandomState(t).randn(t, c).astype(np.float32)
    want = jfeat.deltas(jnp.asarray(x), window)
    got = tfeat.deltas(torch.from_numpy(x), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("n", [400, 1520, 4000])
def test_mfcc_with_deltas_matches_jax(n):
    sig = (np.random.RandomState(n).randn(n) * 0.3).astype(np.float32)
    want = jfeat.mfcc_with_deltas(jnp.asarray(sig), FEATURE_CONFIG)
    got = tfeat.mfcc_with_deltas(torch.from_numpy(sig), tcfg.FEATURE_CONFIG)
    assert tuple(got.shape) == tuple(want.shape) == \
        (tfeat.frames_producible(n, tcfg.FEATURE_CONFIG), 240)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("bytes_per_el", [1, 4])
def test_state_bytes_matches_jax(bytes_per_el):
    jdemo = asr_demo_system()[0]
    tdemo = tserve.asr_demo_system()[0]
    assert ttds.state_bytes(tcfg.TDS_CONFIG, bytes_per_el) == \
        jtds.state_bytes(TDS_CONFIG, bytes_per_el)
    assert ttds.state_bytes(tdemo, bytes_per_el) == \
        jtds.state_bytes(jdemo, bytes_per_el) > 0
