"""LM training on the port (`LM.loss_fn`, `LM.param_shapes`,
`launch.steps.make_train_step`, `launch.train`, `data.pipeline`) vs the
JAX package, and the gradient guard of the CUDA wrappers.

Weights: the reference's own parameters (`repro.models.LM(cfg).init`),
carried across with `params_from_numpy`; data made from a seed with
numpy.  Tiny configs of the families the port serves, cast to fp32:
h2o-danube-1.8b (dense, sliding window), mamba2-1.3b (SSM),
qwen2-moe-a2.7b (MoE, shared expert), jamba-v0.1-52b (hybrid: 7 Mamba
and 1 attention layer a period, MoE every 2nd layer).

Tolerances: the loss atol 1e-5; each gradient leaf's max |port - JAX|
within 1e-4 of that leaf's max |g| (fp32, two frameworks' summation
orders), jamba's within 3e-3: its 16 random tiny layers amplify the
forward's ~1e-6 roundings (tests/test_torch_lm.py holds its logits to
1e-3 for the same reason), and the backward compounds them again from
the loss down to the embedding (measured 1.1e-3 there).  One
`make_train_step` step: each leaf's update (new - old) within 1e-3 of the
reference's in L2 norm, relative.  Element by element the first Adam
step is g/(|g| + eps), nearly the sign of g: an element whose gradient
lies within the two frameworks' rounding of 0 can step either way, so
no elementwise bound short of 2·lr holds.  The loss metric atol 1e-5.  `SyntheticLM` batches bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticASR as JSyntheticASR  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.treeutil import leaves_with_paths  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticASR,  # noqa: E402
                                       SyntheticLM)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import LM, params_from_numpy  # noqa: E402

torch.set_num_threads(1)
PLAIN = KernelPolicy("ref")
LOSS_ATOL = 1e-5
GRAD_REL = {"jamba-v0.1-52b": 3e-3}


def _cfgs(arch, **kw):
    jc = dataclasses.replace(jget(arch).tiny(), dtype="float32", **kw)
    tc = dataclasses.replace(get_config(arch).tiny(), dtype="float32", **kw)
    return jc, tc


def _batch(vocab, B=2, S=64, seed=1):
    r = np.random.default_rng(seed)
    tok = r.integers(0, vocab, (B, S)).astype(np.int32)
    lab = r.integers(0, vocab, (B, S)).astype(np.int32)
    lab[0, :5] = -1                       # masked labels
    return tok, lab


def _check_grads(tg, jg, rel, what):
    jl = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    for path, g in leaves_with_paths(tg):
        j = jl[path]
        d = float(np.abs(g.numpy() - j).max())
        assert d <= rel * max(float(np.abs(j).max()), 1e-30), (what, path, d)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(vocab_size=100, seq_len=16,
                                     global_batch=8, seed=3),
                                dict(vocab_size=32000, seq_len=64,
                                     global_batch=4, seed=0, n_shards=2,
                                     shard=1)])
def test_synthetic_lm_batches_equal_the_reference(kw):
    t, j = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
    for step in (0, 5, 1000):
        a, b = t.batch(step), j.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_synthetic_asr_utterances_equal_the_reference():
    words = {"ab": [1, 2], "cd": [3, 4], "e": [5]}
    t, j = SyntheticASR(words, seed=2), JSyntheticASR(words, seed=2)
    for i in range(3):
        a, b = t.utterance(i, n_words=i + 1), j.utterance(i, n_words=i + 1)
        for k in ("audio", "words", "tokens"):
            np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    np.testing.assert_array_equal(d1.batch(5)["tokens"], d2.batch(5)["tokens"])
    assert not np.array_equal(d1.batch(5)["tokens"], d1.batch(6)["tokens"])
    it = iter(d1)
    np.testing.assert_array_equal(next(it)["tokens"], d2.batch(0)["tokens"])


def test_data_sharding_partitions_global_batch():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=8, seed=0)
    full = SyntheticLM(cfg).batch(2)["tokens"]
    parts = [SyntheticLM(DataConfig(100, 8, 8, 0, n_shards=4, shard=s)
                         ).batch(2)["tokens"] for s in range(4)]
    np.testing.assert_array_equal(full, np.concatenate(parts, axis=0))
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(100, 8, 6, 0, n_shards=4))


def test_data_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab_size=50, seq_len=12,
                               global_batch=2)).batch(0)
    assert b["tokens"].shape == (2, 12) and b["labels"].shape == (2, 12)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_synthetic_asr_utterance():
    utt = SyntheticASR({"ab": [1, 2], "cd": [3, 4]}).utterance(0)
    assert utt["audio"].ndim == 1 and len(utt["audio"]) > 1000
    assert len(utt["tokens"]) >= len(utt["words"])


# ---------------------------------------------------------------------------
# LM.loss_fn and its gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,chunks", [
    ("h2o-danube-1.8b", 0), ("h2o-danube-1.8b", 4), ("mamba2-1.3b", 0),
    ("qwen2-moe-a2.7b", 0), ("jamba-v0.1-52b", 0)])
def test_loss_and_grads_match_jax(arch, chunks):
    jc, tc = _cfgs(arch)
    jlm, tlm = JLM(jc), LM(tc, PLAIN)
    jp = jlm.init(jax.random.PRNGKey(0))
    tok, lab = _batch(tc.vocab_size)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, {"tokens": jnp.asarray(tok),
                                  "labels": jnp.asarray(lab)},
                              loss_chunks=chunks), has_aux=True)(jp)
    from repro_torch.core.treeutil import value_and_grad
    (tl, tm), tg = value_and_grad(
        lambda p: tlm.loss_fn(p, {"tokens": torch.from_numpy(tok),
                                  "labels": torch.from_numpy(lab)},
                              loss_chunks=chunks),
        params_from_numpy(jp), has_aux=True)
    assert float(tl) == pytest.approx(float(jl), abs=LOSS_ATOL)
    for k in ("loss", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), abs=LOSS_ATOL), k
    assert int(tm["ntok"]) == int(jm["ntok"]) == tok.size - 5
    _check_grads(tg, jg, GRAD_REL.get(arch, 1e-4), arch)


def test_moe_aux_sums_each_periods_last_layer_as_the_reference():
    """jamba's period holds 4 MoE layers; the reference's scan body adds
    only the last one's aux value per repeat (ROADMAP Queue 3), and so
    does the port: aux ~= R = 2 balanced layers' worth, not 8."""
    jc, tc = _cfgs("jamba-v0.1-52b")
    jp = JLM(jc).init(jax.random.PRNGKey(0))
    tok, lab = _batch(tc.vocab_size, S=16)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    lm = LM(tc, PLAIN)
    with torch.no_grad():
        _, m = lm.loss_fn(params_from_numpy(jp), batch, remat=False)
    assert 1.5 < float(m["aux"]) < 3.0, float(m["aux"])


def test_remat_changes_no_number():
    _, tc = _cfgs("qwen2-moe-a2.7b")
    lm = LM(tc, PLAIN)
    p = lm.init(torch.Generator().manual_seed(0))
    tok, lab = _batch(tc.vocab_size, S=32)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    from repro_torch.core.treeutil import value_and_grad
    out = [value_and_grad(lambda q, r=r: lm.loss_fn(q, batch, remat=r)[0], p)
           for r in (True, False)]
    assert float(out[0][0]) == float(out[1][0])
    for (_, a), (_, b) in zip(leaves_with_paths(out[0][1]),
                              leaves_with_paths(out[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b"])
def test_param_shapes_match_the_reference(arch):
    jc = jget(arch).tiny()
    want = dict(leaves_with_paths(jax.tree.map(
        lambda a: f"{tuple(a.shape)} {a.dtype}", JLM(jc).param_shapes())))
    got = LM(get_config(arch).tiny()).param_shapes()
    assert {p for p, _ in leaves_with_paths(got)} == set(want)
    for path, t in leaves_with_paths(got):
        assert t.device.type == "meta"
        assert f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}" \
            == want[path], path


def test_full_width_param_shapes_allocate_nothing():
    lm = LM(get_config("h2o-danube-1.8b"))
    shapes = lm.param_shapes()
    n = sum(t.numel() for _, t in leaves_with_paths(shapes))
    assert n == 1_832_512_000
    assert {t.device.type for _, t in leaves_with_paths(shapes)} == {"meta"}


# ---------------------------------------------------------------------------
# the train step and the launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(accum):
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import adamw as jadamw
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    jc, tc = _cfgs("qwen2-moe-a2.7b")
    jlm, tlm = JLM(jc), LM(tc, PLAIN)
    jp = jlm.init(jax.random.PRNGKey(0))
    tok, lab = _batch(tc.vocab_size, B=4, S=32)
    jo, to = jadamw.AdamWConfig(lr=1e-3), adamw.AdamWConfig(lr=1e-3)
    jstate = {"params": jp, "opt": jadamw.init(jp, jo),
              "step": jnp.zeros((), jnp.int32)}
    tp = params_from_numpy(jp)
    tstate = {"params": tp, "opt": adamw.init(tp, to),
              "step": torch.zeros((), dtype=torch.int32)}
    jnew, jmet = jmake(jlm, jo, accum=accum)(
        jstate, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)})
    tnew, tmet = make_train_step(tlm, to, accum=accum)(
        tstate, {"tokens": torch.from_numpy(tok),
                 "labels": torch.from_numpy(lab)})
    assert int(tnew["step"]) == int(jnew["step"]) == 1
    assert int(tmet["step"]) == 1
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                abs=LOSS_ATOL)
    old = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    jl = dict(leaves_with_paths(jax.tree.map(np.asarray, jnew["params"])))
    for path, t in leaves_with_paths(tnew["params"]):
        dj = jl[path] - old[path]
        d = np.linalg.norm(t.numpy() - old[path] - dj)
        assert d <= 1e-3 * np.linalg.norm(dj), (path, d / np.linalg.norm(dj))
    # the step writes into none of the tensors it was given
    for (_, a), (_, b) in zip(leaves_with_paths(tstate["params"]),
                              leaves_with_paths(params_from_numpy(jp))):
        assert torch.equal(a, b)


def test_train_launcher_tiny(tmp_path):
    """What the reference's own (failing, ROADMAP Queue 3)
    `test_launchers.py::test_train_launcher_tiny` asserts, on the port's
    launcher: 30 losses, the last below the first, then a 5-step resume
    from the step-30 checkpoint with 5 finite losses."""
    from repro_torch.launch import train
    losses = train.main(["--arch", "mamba2-1.3b", "--tiny", "--steps", "30",
                         "--batch", "4", "--seq", "32", "--lr", "3e-3",
                         "--ckpt", str(tmp_path), "--ckpt-every", "10",
                         "--log-every", "100", "--device", "cpu"])
    assert len(losses) == 30
    assert losses[-1] < losses[0]
    from repro_torch.ckpt.checkpoint import Checkpointer
    assert Checkpointer(tmp_path).all_steps() == [10, 20, 30]
    losses2 = train.main(["--arch", "mamba2-1.3b", "--tiny", "--steps", "5",
                          "--batch", "4", "--seq", "32", "--ckpt",
                          str(tmp_path), "--resume", "--log-every", "100",
                          "--device", "cpu"])
    assert len(losses2) == 5
    assert np.isfinite(losses2).all()


def test_train_launcher_refuses_the_mesh_flags(monkeypatch):
    """The mesh flags a world of one rank cannot serve: a mesh name the
    reference lacks, a production mesh (256 or 512 ranks), a 'model'
    axis of 2; and no card without `--device cpu`.  (Training under a
    mesh of more than one rank: `test_torch_train_mesh.py`.)"""
    from repro_torch.launch import train
    tiny = ["--arch", "mamba2-1.3b", "--tiny", "--steps", "1", "--device",
            "cpu"]
    with pytest.raises(SystemExit):
        train.main(tiny + ["--mesh", "ring"])
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train.main(tiny + ["--mesh", "production"])
    with pytest.raises(ValueError, match="'model' axes of 2"):
        train.main(tiny + ["--model-parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-1.3b", "--tiny", "--steps", "1"])


# ---------------------------------------------------------------------------
# the gradient guard
# ---------------------------------------------------------------------------
def test_gradient_guard_refuses_tensors_that_require_grad():
    w = torch.ones(3, requires_grad=True)
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match=r"KernelPolicy\('ref'\) to train"):
        _build.refuse_grad("tds_conv", x, None, w)
    _build.refuse_grad("tds_conv", x, None, x)          # nothing requires grad
    with torch.no_grad():
        _build.refuse_grad("tds_conv", x, w)            # grad mode off
    with pytest.raises(RuntimeError, match="layernorm"):
        _build.refuse_grad("layernorm", w.detach() * 2, w * 2)
