"""The port's CTC loss (`repro_torch.core.ctc`) vs the JAX package's, vs a
brute-force path enumeration, vs `F.ctc_loss`, and the port's own
end-to-end ASR training.

Inputs are made from a seed with numpy and fed to both packages.
Tolerances: brute force 1e-3 (the reference test's); `ctc_loss_batch`
against JAX rtol 1e-5 (fp32, one logaddexp recursion each, XLA's and
torch's exp/log1p round apart); its gradient against `jax.grad` atol
1e-5; `F.ctc_loss` (reduction='none', per utterance) rtol 1e-5 on the
rows with a possible alignment.  An impossible alignment gives ~1e30 in
both packages, not inf.  float64 `gradcheck` (torch's defaults) of the
loss alone and of the TDS forward + loss on the plain path (the
training path) at a tiny size: autograd's gradients of the port's own
functions are the functions' derivatives.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ctc as jctc  # noqa: E402
from repro_torch.configs.tds_asr import (DecoderConfig,  # noqa: E402
                                         FeatureConfig, TDSConfig, TDSStage)
from repro_torch.core import ctc  # noqa: E402
from repro_torch.core.treeutil import value_and_grad  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402

torch.set_num_threads(1)
PLAIN = KernelPolicy("ref")


def _brute_force_ctc(logp, labels, blank=0):
    """Sum probability over all alignments that collapse to `labels`."""
    T, V = logp.shape
    total = -np.inf
    for path in itertools.product(range(V), repeat=T):
        out, prev = [], -1
        for t in path:
            if t != blank and t != prev:
                out.append(t)
            prev = t
        if out == list(labels):
            total = np.logaddexp(total, sum(logp[i, path[i]]
                                            for i in range(T)))
    return -total


def _log_softmax(x):
    x = x - x.max(-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed,T,labels", [
    (0, 3, [1]), (1, 4, [1, 2]), (2, 5, [2, 2]), (3, 4, [3, 1, 2]),
    (4, 5, []),
])
def test_ctc_matches_brute_force_and_jax(seed, T, labels):
    r = np.random.RandomState(seed)
    logp = _log_softmax(r.randn(T, 4).astype(np.float32))
    lab = np.pad(np.asarray(labels, np.int32), (0, 5 - len(labels)),
                 constant_values=-1)
    got = float(ctc.ctc_loss(torch.from_numpy(logp), torch.from_numpy(lab)))
    want = _brute_force_ctc(logp, labels)
    ref = float(jctc.ctc_loss(jnp.asarray(logp), jnp.asarray(lab)))
    if np.isinf(want):   # impossible (e.g. repeated label, T too short)
        assert got > 1e10 and ref > 1e10
    else:
        assert abs(got - want) < 1e-3, (got, want)
        assert got == pytest.approx(ref, rel=1e-5), (got, ref)


def _batch(seed=0, B=6, T=12, V=7, L=5):
    """Random log-probs and -1-padded labels: an empty row, a repeated
    label, a full row, and a row too long for T (impossible)."""
    r = np.random.RandomState(seed)
    logp = _log_softmax(r.randn(B, T, V).astype(np.float32) * 2.0)
    lab = np.full((B, L), -1, np.int32)
    rows = [[], [3, 3], [1, 2, 3, 4, 5], [6], [2, 5, 2]]
    for i, row in enumerate(rows[:B]):
        lab[i, :len(row)] = row
    if B > len(rows):
        lab[len(rows)] = [1, 1, 1, 1, 1]   # needs 9 frames
    return logp, lab


@pytest.mark.parametrize("T", [12, 6])
def test_ctc_loss_batch_and_grad_match_jax(T):
    """At T = 12 every row has an alignment; at T = 6 the last row has
    none: its loss is ~1e30 in both packages, and its gradient is the
    one place they part (`core/ctc.py`'s docstring; ROADMAP Queue 3): the
    reference's doubles at every frame back in time, 2^(T-2)/B = 16/6 at
    the second frame, the port's halves, from 1/2/B at the last.  Every other
    row's gradient (each row's depends on its own log-probs only) is
    held to the reference's."""
    logp, lab = _batch(T=T)
    want, jg = jax.value_and_grad(
        lambda lp: jctc.ctc_loss_batch(lp, jnp.asarray(lab)))(
        jnp.asarray(logp))
    got, grads = value_and_grad(
        lambda p: ctc.ctc_loss_batch(p["lp"], torch.from_numpy(lab)),
        {"lp": torch.from_numpy(logp)})
    tg, jg = grads["lp"].numpy(), np.asarray(jg)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    possible = slice(None) if T == 12 else slice(0, -1)
    np.testing.assert_allclose(tg[possible], jg[possible], rtol=0, atol=1e-5)
    assert np.isfinite(tg).all()
    # per utterance: impossible rows give ~1e30 in both
    per = [float(ctc.ctc_loss(torch.from_numpy(logp[i]),
                              torch.from_numpy(lab[i])))
           for i in range(len(lab))]
    ref = [float(jctc.ctc_loss(jnp.asarray(logp[i]), jnp.asarray(lab[i])))
           for i in range(len(lab))]
    np.testing.assert_allclose(per, ref, rtol=1e-5)
    if T == 6:
        B = len(lab)
        assert per[-1] > 1e29 and np.isfinite(per[-1])
        assert np.abs(jg[-1]).max() == pytest.approx(2 ** (T - 2) / B)
        assert np.abs(tg[-1]).max() == pytest.approx(0.5 / B)


def test_ctc_agrees_with_torch_ctc_loss():
    """F.ctc_loss (a third opinion, not the port) per utterance, on the
    rows with a possible alignment."""
    import torch.nn.functional as F
    logp, lab = _batch(T=6)
    lp = torch.from_numpy(logp)
    n = (lab >= 0).sum(1)
    want = F.ctc_loss(lp.transpose(0, 1), torch.from_numpy(np.where(
        lab >= 0, lab, 0)), torch.full((len(lab),), lp.shape[1]),
        torch.from_numpy(n), reduction="none", zero_infinity=False)
    got = torch.stack([ctc.ctc_loss(lp[i], torch.from_numpy(lab[i]))
                       for i in range(len(lab))])
    ok = torch.isfinite(want)
    assert ok.sum() == len(lab) - 1
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-5, atol=1e-5)
    assert not bool(ok[-1]) and float(got[-1]) > 1e29


def test_ctc_gradcheck_float64():
    """Every row with an alignment (at T = 12): a ~1e30 loss would hide
    any finite difference."""
    logp, lab = _batch(T=12)
    lp = torch.from_numpy(logp.astype(np.float64)).requires_grad_()
    lab_t = torch.from_numpy(lab)
    assert torch.autograd.gradcheck(
        lambda x: ctc.ctc_loss_batch(torch.log_softmax(x, -1), lab_t), (lp,))


def _tiny_tds():
    return TDSConfig(n_mfcc=4, stages=(TDSStage(1, 2, 4, 3, 2),),
                     sub_kernel=3, vocab_size=5)


def test_tds_ctc_gradcheck_float64():
    """The training path, TDS forward (plain versions) + CTC, in float64:
    every parameter's autograd gradient against finite differences."""
    from repro_torch.models import tds
    cfg = _tiny_tds()
    params = tds.init_tds(torch.Generator().manual_seed(0), cfg,
                          dtype=torch.float64)
    # random biases and LN affines: with zero biases a ReLU would sit
    # exactly on its kink, where finite differences are meaningless
    g = torch.Generator().manual_seed(1)
    params = {k: {n: t.double() + 0.3 * torch.randn(
        t.shape, generator=g, dtype=torch.float64) for n, t in v.items()}
        for k, v in params.items()}
    r = np.random.RandomState(0)
    feats = torch.from_numpy(r.randn(2, 8, 4))
    labels = torch.tensor([[1, 2], [3, -1]])
    state = tds.init_batched_stream_state(cfg, 2)
    names = [(k, n) for k in params for n in params[k]]

    def f(*leaves):
        p = {k: dict(v) for k, v in params.items()}
        for (k, n), t in zip(names, leaves):
            p[k][n] = t
        lps, _ = tds.forward_batched(p, cfg, feats, state, kernels=PLAIN)
        return ctc.ctc_loss_batch(lps, labels)
    leaves = [params[k][n].clone().requires_grad_() for k, n in names]
    assert torch.autograd.gradcheck(f, leaves)


def test_edit_distance_and_wer():
    cases = [([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 3]), ([], [1, 2]),
             ([4, 1], [1, 4, 4]), ([2], [])]
    for a, b in cases:
        assert ctc.edit_distance(a, b) == jctc.edit_distance(a, b)
    assert ctc.edit_distance([1, 2, 3], [1, 3]) == 1
    assert ctc.wer([[1, 2], [3]], [[1, 2], [4]]) == pytest.approx(1 / 3)
    assert ctc.wer([[1, 2], [3]], [[1, 2], [4]]) == jctc.wer(
        [[1, 2], [3]], [[1, 2], [4]])
    assert ctc.wer([], []) == jctc.wer([], []) == 0.0


def test_train_tds_ctc_end_to_end():
    """The paper's full loop on the port: synthetic utterances -> MFCC ->
    TDS -> CTC training (autograd, AdamW) -> beam decode -> the WER
    improves on the untrained model's (the reference test's bounds)."""
    from repro_torch.core import decoder, features, lexicon as lx
    from repro_torch.data.pipeline import SyntheticASR
    from repro_torch.models import tds
    from repro_torch.optim import adamw

    feat_cfg = FeatureConfig(n_mels=16, n_mfcc=16)
    tds_cfg = TDSConfig(
        stages=(TDSStage(1, 3, 16, 5, 2), TDSStage(1, 3, 16, 5, 2),
                TDSStage(1, 4, 16, 5, 2)),
        sub_kernel=6, vocab_size=8)
    words = {"a": [1], "bc": [2, 3], "d": [4]}
    lex = lx.build_lexicon(words, max_children=8)
    lm = lx.uniform_bigram(len(words))
    data = SyntheticASR(words, tok_ms=200.0)

    # pad AUDIO to the longest (silence -> blanks), never truncate
    utts = [data.utterance(i, n_words=2) for i in range(6)]
    max_audio = max(len(u["audio"]) for u in utts)
    audio = np.zeros((len(utts), max_audio), np.float32)
    labels = np.full((len(utts), 8), -1, np.int32)
    for i, u in enumerate(utts):
        audio[i, :len(u["audio"])] = u["audio"]
        labels[i, :len(u["tokens"])] = u["tokens"]
    refs = [list(u["words"]) for u in utts]
    X = features.mfcc(torch.from_numpy(audio), feat_cfg, kernels=PLAIN)
    X = X[:, :(X.shape[1] // 8) * 8]
    Y = torch.from_numpy(labels)
    state0 = tds.init_batched_stream_state(tds_cfg, len(utts))

    params = tds.init_tds(torch.Generator().manual_seed(0), tds_cfg)

    def loss_fn(p):
        lps, _ = tds.forward_batched(p, tds_cfg, X, state0, kernels=PLAIN)
        return ctc.ctc_loss_batch(lps, Y)

    ocfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    opt = adamw.init(params, ocfg)

    def decode_wer(p):
        dcfg = DecoderConfig(beam_size=16, beam_threshold=1e9,
                             lm_weight=0.5, word_score=0.0)
        hyps = []
        with torch.no_grad():
            lps, _ = tds.forward_batched(p, tds_cfg, X, state0,
                                         kernels=PLAIN)
        for i in range(X.shape[0]):
            st = decoder.decode(lps[i], lex, lm, dcfg)
            st = decoder.finalize(st, lex, lm, dcfg)
            b = decoder.best(st)
            hyps.append(list(b["words"].numpy()[:int(b["n_words"])]))
        return ctc.wer(refs, hyps)

    l0 = float(loss_fn(params))
    wer0 = decode_wer(params)
    for _ in range(60):
        _, grads = value_and_grad(loss_fn, params)
        params, opt = adamw.update(grads, opt, params, ocfg)
    l1 = float(loss_fn(params))
    wer1 = decode_wer(params)
    assert l1 < 0.5 * l0, (l0, l1)
    assert wer1 <= wer0, (wer0, wer1)
    assert wer1 < 0.5, f"trained WER {wer1} (untrained {wer0})"
