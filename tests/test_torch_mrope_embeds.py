"""M-RoPE, frontend embeddings and the LM's LayerNorm in the port, against
the JAX package on the same numpy inputs.

`qwen2-vl-7b` (M-RoPE over (B, S, 3) positions, QKV bias, patch
embeddings from the stub frontend) and `musicgen-medium` (no rotary,
LayerNorm, GELU, frame embeddings) at their tiny configs in fp32; the
JAX package initialises the parameters and `params_from_numpy` carries
them across.  Tolerances: `apply_rope` atol 1e-5 (tests/test_torch_layers.py's
fp32 bound; angles stay below 100 rad); logits atol 1e-4 and caches
1e-5 (tests/test_torch_lm.py's); `loss_fn` atol 1e-5 and gradients 1e-4
of each leaf's max (tests/test_torch_train.py's); decode against prefill
at the relative 2e-2 of tests/test_models.py::test_decode_matches_prefill;
bf16 LayerNorm rows within one bf16 ulp of the JAX oracle and of
`norm_pallas(kind="layernorm", interpret=True)` (fp32 statistics, one
rounding: the sums may differ in order, so a value near a rounding
boundary may land one ulp away).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.layernorm import norm_pallas  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.treeutil import leaves_with_paths, value_and_grad  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import LM, pad_vocab, params_from_numpy  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

torch.set_num_threads(1)

ARCHS = ["qwen2-vl-7b", "musicgen-medium"]
ROPE_ATOL = 1e-5
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4
DECODE_REL = 2e-2
PLAIN = KernelPolicy("ref")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _cmp_tree(t, j, atol, path=""):
    if isinstance(j, dict):
        assert set(t) == set(j), (path, set(t), set(j))
        for k in j:
            _cmp_tree(t[k], j[k], atol, f"{path}/{k}")
        return
    assert tuple(t.shape) == tuple(np.shape(j)), (path, t.shape, np.shape(j))
    np.testing.assert_allclose(_np(t), _np(j), rtol=atol, atol=atol,
                               err_msg=path)


_MODELS = {}


def _models(arch, dtype="float32"):
    """(jax LM, jax params, port LM, port params) of the tiny config."""
    key = (arch, dtype)
    if key not in _MODELS:
        jc = dataclasses.replace(jget(arch).tiny(), dtype=dtype)
        tc = dataclasses.replace(get_config(arch).tiny(), dtype=dtype)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        jlm = JLM(jc)
        jp = jlm.init(jax.random.PRNGKey(0))
        _MODELS[key] = (jlm, jp, LM(tc), params_from_numpy(jp))
    return _MODELS[key]


def _embeds(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _image_positions(B, S, seed=0):
    """(B, S, 3) positions shaped like an image: one temporal index a
    row over an h x w grid of the rest, then text after it."""
    r = np.random.default_rng(seed)
    pos = np.zeros((B, S, 3), np.int32)
    for b in range(B):
        hw = 4 + b
        n = min(S, hw * hw)
        t0 = int(r.integers(0, 5))
        pos[b, :n, 0] = t0
        pos[b, :n, 1] = t0 + np.arange(n) // hw
        pos[b, :n, 2] = t0 + np.arange(n) % hw
        nxt = t0 + hw
        pos[b, n:] = (nxt + np.arange(S - n))[:, None]
    return pos


def _batches(arch, B, S, seed, positions=False):
    """(jax batch, port batch) of embeddings (and positions: (B, S, 3) for
    M-RoPE, else their temporal component (B, S), under which an image's
    tokens share one position and see each other)."""
    cfg = _models(arch)[2].cfg
    e = _embeds(seed, B, S, cfg.d_model)
    jb, tb = {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    if positions:
        pos = _image_positions(B, S, seed)
        if cfg.rope != "mrope":
            pos = np.ascontiguousarray(pos[..., 0])
        jb["positions"] = jnp.asarray(pos)
        tb["positions"] = torch.from_numpy(pos)
    return jb, tb


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,sections", [(128, (42, 42, 44)), (16, (4, 4, 8))])
@pytest.mark.parametrize("given", [False, True])
def test_apply_mrope_matches_jax(d, sections, given):
    """Default (text) positions broadcast to (B, S, 3), and random (B, S,
    3) ones; precomputed tables give the same bits as fresh ones."""
    assert tl.mrope_sections(d) == sections
    B, S, H = 2, 9, 3
    x = np.random.default_rng(d).standard_normal((B, S, H, d)).astype(
        np.float32)
    if given:
        pos = np.random.default_rng(d + 1).integers(0, 64, (B, S, 3))
    else:
        pos = np.broadcast_to((np.arange(S)[None, :] + np.array([[0], [40]])
                               )[..., None], (B, S, 3))
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    theta = 1e6
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), "mrope", theta)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    got = tl.apply_rope(tx, tp, "mrope", theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROPE_ATOL,
                               atol=ROPE_ATOL)
    tables = tl.rope_tables_for(tp, d, "mrope", theta)
    assert len(tables) == 3
    assert torch.equal(tl.apply_rope(tx, tp, "mrope", theta, tables=tables),
                       got)


@pytest.mark.parametrize("window", [None, 5])
def test_position_masked_attention_matches_jax(window):
    """The plain attention that batch-given positions take: GQA 4/2, the
    reference's mask on random non-monotone positions, a row that sees
    no key (-1 everywhere) giving 0 as in the reference."""
    r = np.random.default_rng(3)
    B, S, H, K, D = 2, 24, 4, 2, 8
    q = r.standard_normal((B, S, H, D)).astype(np.float32)
    k = r.standard_normal((B, S, K, D)).astype(np.float32)
    v = r.standard_normal((B, S, K, D)).astype(np.float32)
    pos = r.integers(0, 12, (B, S)).astype(np.int32)
    kpos = pos.copy()
    kpos[1] = -1
    want = jl.attention_chunked(*map(jnp.asarray, (q, k, v, pos, kpos)),
                                causal=True, window=window, chunk_q=8,
                                chunk_kv=8)
    got = tl.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                               qpos=torch.from_numpy(pos),
                               kpos=torch.from_numpy(kpos), causal=True,
                               window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert not got[1].any()


# ---------------------------------------------------------------------------
# the two architectures against the reference
# ---------------------------------------------------------------------------
def test_both_architectures_build_at_full_width():
    for arch in ARCHS:
        lm = LM(get_config(arch))
        shapes = lm.param_shapes()
        assert "embed" not in shapes
        assert shapes["lm_head"]["w"].shape == (lm.cfg.d_model, lm.Vp)


@pytest.mark.parametrize("arch", ARCHS)
def test_token_batch_raises_for_an_embedding_architecture(arch):
    _, _, tlm, tp = _models(arch)
    with pytest.raises(ValueError, match="embed_inputs=False"):
        tlm.prefill(tp, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})


@pytest.mark.parametrize("mode", ["plain", "masked", "positions"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, mode):
    """fp32 prefill logits and caches: the default positions (the flash
    path), the bucketed path with `lengths`, and batch-given positions
    (the plain position-masked attention; musicgen has no rotary, so
    there only the mask moves)."""
    jlm, jp, tlm, tp = _models(arch)
    B, S = 3, 64
    jb, tb = _batches(arch, B, S, seed=7, positions=mode == "positions")
    kw, tkw = {}, {}
    if mode == "masked":
        lens = np.array([64, 9, 30], np.int32)
        kw = dict(lengths=jnp.asarray(lens), cache_len=40)
        tkw = dict(lengths=torch.from_numpy(lens), cache_len=40)
    jl_, jc = jlm.prefill(jp, jb, **kw)
    tl_, tc = tlm.prefill(tp, tb, **tkw)
    assert tuple(tl_.shape) == (B, pad_vocab(jlm.cfg.vocab_size))
    np.testing.assert_allclose(_np(tl_), _np(jl_), rtol=0, atol=LOGIT_ATOL)
    _cmp_tree(tc["layers"], jc["layers"], CACHE_ATOL)
    assert tc["kpos"].tolist() == np.asarray(jc["kpos"]).tolist()
    assert np.asarray(tc["offset"]).tolist() == \
        np.asarray(jc["offset"]).tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_and_prefill(arch):
    """One decode step of each row's next embedding against the cache of
    an (S-1)-long prefill equals the reference's step and the S-long
    prefill's last logits."""
    jlm, jp, tlm, tp = _models(arch)
    B, S = 2, 24
    V = jlm.cfg.vocab_size
    e = _embeds(11, B, S, jlm.cfg.d_model)
    full, _ = tlm.prefill(tp, {"embeds": torch.from_numpy(e)})
    _, c1 = tlm.prefill(tp, {"embeds": torch.from_numpy(e[:, :S - 1])})
    cache = tlm.init_cache(B, S)
    for name, lay in cache["layers"].items():
        for leaf, dst in lay.items():
            dst[:, :, :S - 1] = c1["layers"][name][leaf]
    cache["kpos"][:S - 1] = c1["kpos"]
    cache["offset"] = c1["offset"]
    jcache = jax.tree.map(lambda a: jnp.asarray(np.array(a.numpy())), cache)
    step = e[:, S - 1:]
    dec, tok, new = tlm.decode_step(tp, cache,
                                    {"embeds": torch.from_numpy(step)})
    jdec, jtok, jnew = jlm.decode_step(jp, jcache,
                                       {"embeds": jnp.asarray(step)})
    np.testing.assert_allclose(_np(dec)[:, :V], _np(jdec)[:, :V], rtol=0,
                               atol=LOGIT_ATOL)
    assert (_np(dec)[:, V:] == -np.inf).all()
    assert tok.tolist() == np.asarray(jtok).tolist()
    lf, ld = _np(full)[:, :V], _np(dec)[:, :V]
    assert np.abs(lf - ld).max() / (np.abs(lf).max() + 1e-9) < 1e-5
    _cmp_tree(new["layers"], jnew["layers"], CACHE_ATOL)
    assert new["kpos"].tolist() == np.asarray(jnew["kpos"]).tolist()
    assert int(new["offset"]) == int(jnew["offset"]) == S


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """tests/test_models.py::test_decode_matches_prefill's case on the
    port: the config's own dtype (bf16), the reference's parameters,
    bf16 embeddings; prefill of S == prefill of S-1 + one decode step,
    relative 2e-2."""
    jlm, jp, tlm, tp = _models(arch, "bfloat16")
    B, S = 2, 32
    V = jlm.cfg.vocab_size
    e = torch.from_numpy(_embeds(1, B, S, jlm.cfg.d_model)).to(torch.bfloat16)
    full, _ = tlm.prefill(tp, {"embeds": e})
    _, c1 = tlm.prefill(tp, {"embeds": e[:, :S - 1]})
    cache = tlm.init_cache(B, S)
    for name, lay in cache["layers"].items():
        for leaf, dst in lay.items():
            dst[:, :, :S - 1] = c1["layers"][name][leaf]
    cache["kpos"][:S - 1] = c1["kpos"]
    cache["offset"] = c1["offset"]
    dec, _, _ = tlm.decode_step(tp, cache, {"embeds": e[:, S - 1:]})
    lf, ld = _np(full)[:, :V], _np(dec)[:, :V]
    assert np.abs(lf - ld).max() / (np.abs(lf).max() + 1e-9) < DECODE_REL


def test_decode_takes_batch_given_positions():
    """A (B, 1, 3) position given to the decode step rotates q and k as the
    reference's does; the cache offset still counts token indices."""
    jlm, jp, tlm, tp = _models("qwen2-vl-7b")
    B, S = 2, 16
    jb, tb = _batches("qwen2-vl-7b", B, S, seed=5, positions=True)
    jl_, jc = jlm.prefill(jp, jb)
    _, tc = tlm.prefill(tp, tb)
    e = _embeds(6, B, 1, jlm.cfg.d_model)
    pos = np.array([[[9, 3, 7]], [[12, 12, 12]]], np.int32)
    jdec, _, _ = jlm.decode_step(jp, jc, {"embeds": jnp.asarray(e),
                                          "positions": jnp.asarray(pos)})
    tdec, _, tnew = tlm.decode_step(tp, tc, {"embeds": torch.from_numpy(e),
                                             "positions": torch.from_numpy(pos)})
    V = jlm.cfg.vocab_size
    np.testing.assert_allclose(_np(tdec)[:, :V], _np(jdec)[:, :V], rtol=0,
                               atol=LOGIT_ATOL)
    assert int(tnew["offset"]) == S + 1


def _check_grads(tg, jg, what):
    jl_ = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    assert {p for p, _ in leaves_with_paths(tg)} == set(jl_), what
    for path, g in leaves_with_paths(tg):
        j = jl_[path]
        d = float(np.abs(g.numpy() - j).max())
        assert d <= GRAD_REL * max(float(np.abs(j).max()), 1e-30), \
            (what, path, d)


@pytest.mark.parametrize("arch,positions", [("qwen2-vl-7b", False),
                                            ("qwen2-vl-7b", True),
                                            ("musicgen-medium", False)])
def test_loss_and_grads_match_jax(arch, positions):
    """`loss_fn` and every gradient leaf on an embeddings batch (masked
    labels), at tests/test_torch_train.py's tolerances."""
    jlm, jp, _, _ = _models(arch)
    tlm = LM(_models(arch)[2].cfg, PLAIN)
    B, S = 2, 32
    jb, tb = _batches(arch, B, S, seed=3, positions=positions)
    lab = np.random.default_rng(4).integers(0, jlm.cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    lab[0, :5] = -1
    jb["labels"], tb["labels"] = jnp.asarray(lab), torch.from_numpy(lab)
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jb), has_aux=True)(jp)
    (tloss, tm), tg = value_and_grad(lambda p: tlm.loss_fn(p, tb),
                                     params_from_numpy(jp), has_aux=True)
    assert float(tloss) == pytest.approx(float(jloss), abs=LOSS_ATOL)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              abs=LOSS_ATOL)
    assert int(tm["ntok"]) == int(jm["ntok"]) == lab.size - 5
    _check_grads(tg, jg, arch)


# ---------------------------------------------------------------------------
# the launcher's frontend stub
# ---------------------------------------------------------------------------
def test_stub_embeds_are_the_references_bitwise():
    """launch/train.py's embeddings batch: the reference's numpy formula
    (`default_rng(step).normal`, fp32, then bf16), bit for bit."""
    from repro_torch.launch.train import stub_embeds
    for step, (b, s, d) in ((0, (2, 8, 64)), (7, (3, 5, 48))):
        got = stub_embeds(step, b, s, d)
        rng = np.random.default_rng(step)
        emb = rng.normal(0, 1, (b, s, d)).astype(np.float32)
        want = np.asarray(jnp.asarray(emb, jnp.bfloat16))
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, d)
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              want.view(np.uint16))


def test_train_launcher_musicgen_tiny():
    from repro_torch.launch import train
    losses = train.main(["--arch", "musicgen-medium", "--tiny", "--steps",
                         "3", "--batch", "2", "--seq", "16", "--log-every",
                         "100", "--device", "cpu"])
    assert len(losses) == 3 and np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# the LM's LayerNorm: bf16 rows through the norm kernel's wrapper
# ---------------------------------------------------------------------------
def _bf16_ulp(a):
    a = np.abs(np.asarray(a, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(a, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("t,d", [(37, 1536), (16, 100)])
def test_layernorm_bf16_rows_match_jax_ref_and_interpret(t, d):
    """The port's plain `ref.layernorm` on bf16 rows (the musicgen width,
    and a ragged one), eps 1e-6 as the LM passes it: within one bf16 ulp
    of the JAX oracle and of the Pallas kernel in interpret mode."""
    r = np.random.default_rng(d)
    x = (r.standard_normal((t, d)) * 3 + 1).astype(np.float32)
    s = (1 + 0.1 * r.standard_normal(d)).astype(np.float32)
    b = (0.1 * r.standard_normal(d)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = ref.layernorm(xt, torch.from_numpy(s), torch.from_numpy(b),
                        eps=1e-6)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    for want in (jref.layernorm(xj, jnp.asarray(s), jnp.asarray(b), eps=1e-6),
                 norm_pallas(xj, jnp.asarray(s), jnp.asarray(b),
                             kind="layernorm", eps=1e-6, interpret=True)):
        w = np.asarray(want, np.float32)
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), np.abs(g - w).max()


def test_apply_norm_layernorm_counts_one_launch_per_call(monkeypatch):
    """`apply_norm(kind="layernorm")` calls the LayerNorm kernel's wrapper
    once per call with the rows as (R, D) in their own dtype, fp32 scale
    and bias and the LM's eps; on a CPU tensor the wrapper runs its plain
    version and counts nothing, and the kernel policy raises."""
    from repro_torch.kernels import layernorm as tln
    calls = []
    real = tln.layernorm

    def spy(x, scale, bias, eps=1e-5):
        calls.append((tuple(x.shape), x.dtype, scale.dtype, bias.dtype, eps))
        return real(x, scale, bias, eps=eps)
    x = torch.from_numpy(_embeds(2, 2, 5, 32)).to(torch.bfloat16)
    p = {"scale": torch.ones(32), "bias": torch.zeros(32)}
    ops.reset_launch_counts()
    monkeypatch.setattr(tln, "layernorm", spy)
    monkeypatch.setattr(ops, "resolve", lambda policy, t: "kernel")
    for _ in range(3):
        y = tl.apply_norm(p, x, "layernorm")
        assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert calls == [((10, 32), torch.bfloat16, torch.float32, torch.float32,
                      1e-6)] * 3
    counts = ops.launch_counts()
    assert counts["layernorm"] == 0 and counts["rmsnorm"] == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        tl.apply_norm(p, x, "layernorm", policy=KernelPolicy("kernel"))
