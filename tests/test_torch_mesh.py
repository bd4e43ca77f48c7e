"""The port's serving mesh vs the JAX package's, on the CPU.

`launch/mesh.py` (ranks, axes, groups, the backend choice),
`parallel/sharding.py` (the serving specs against the reference's
`PartitionSpec`s, `shard_tree`), the mesh helpers of `kernels/ops.py`
and the sharded `tds.forward_batched(axis=)`.

The ranks are spawned processes on a gloo world (`_torch_mesh_ranks`),
one module-scoped run per world size; the reference's sharded functions
run in one subprocess on 4 forced host devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=4`), since this
process sees one JAX device.  Both packages get the JAX demo system's
parameters and the same numpy inputs.

Tolerances:
  * sharded fp32 forward against JAX's unsharded and sharded forward:
    atol 1e-5 on log-probs and state (the reference's own bound for
    sharded against unsharded; measured 2.4e-6);
  * the overlapped all-reduce against the synchronous one: 1e-6 (the
    reference's bound; the chunks' products may be blocked differently);
  * the int8 sharded product against JAX's sharded product: bitwise on 2
    ranks (exact integer partials, rescaled in the same order, summed
    a + b); on 4 ranks the two all-reduces may add the partials in
    other orders, and against the unsharded product each partial is
    rescaled on its own: 1e-5 (a few ulps of partials up to ~40; measured
    1.9e-6);
  * the int8 sharded forward: atol 1e-4, the unsharded int8 forward's
    bound in tests/test_torch_tds.py, on its shapes (no activation
    at a quantization boundary there).
"""
import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs.tds_asr import TDS_CONFIG  # noqa: E402
from repro.core import decoder as jdec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro.launch.serve import asr_demo_system  # noqa: E402
from repro.models import tds as jtds  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import decoder as tdec  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.device import rank_device  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models import tds as ttds  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD_SHAPES = ((1, 8), (4, 16))          # (B, T), as test_torch_tds's
WORLDS = (2, 4)


def _t_cfg(cfg):
    return tcfg.TDSConfig(
        stages=tuple(tcfg.TDSStage(s.n_blocks, s.channels, s.feat, s.kernel,
                                   s.subsample) for s in cfg.stages),
        vocab_size=cfg.vocab_size)


def _inputs(tds_cfg):
    """{"BxT": (feats, mid-utterance state)} as numpy, from seeds."""
    out = {}
    for b, t in FORWARD_SHAPES:
        r = np.random.RandomState(10 + b)
        feats = (r.randn(b, t, 80) * 0.3).astype(np.float32)
        st = jtds.init_batched_stream_state(tds_cfg, b)
        rng = np.random.RandomState(3)
        out[f"{b}x{t}"] = (feats, {k: rng.randn(*v.shape).astype(np.float32)
                                   for k, v in st.items()})
    return out


@pytest.fixture(scope="module")
def demo():
    tds_cfg, _, _, _, params, _ = asr_demo_system()
    rng = np.random.RandomState(0)
    payload = {
        "stages": [(s.n_blocks, s.channels, s.feat, s.kernel, s.subsample)
                   for s in tds_cfg.stages],
        "vocab": tds_cfg.vocab_size,
        "params": jax.tree.map(np.asarray, params),
        "inputs": _inputs(tds_cfg),
        "x": rng.randn(4, 32).astype(np.float32),
        "w": rng.randn(32, 24).astype(np.float32),
        "x8": rng.randn(16, 320).astype(np.float32),
        "w8": rng.randn(320, 96).astype(np.float32)}
    return tds_cfg, params, payload


@pytest.fixture(scope="module")
def port_ranks(demo, tmp_path_factory):
    """{world: [rank 0's results, ...]} of the `forward` job."""
    return {w: ranks.run(w, tmp_path_factory.mktemp(f"forward{w}"),
                         "forward", demo[2]) for w in WORLDS}


JAX_SHARDED = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.kernels import ops
    from repro.kernels.policy import KernelPolicy
    from repro.launch.serve import asr_demo_system
    from repro.models import tds
    from repro.parallel import sharding as shlib

    src, dst = sys.argv[1], sys.argv[2]
    inp = dict(np.load(src))
    cfg, _, _, _, params, _ = asr_demo_system()
    prep = tds.quantize_params(params, cfg)
    ref = KernelPolicy("ref")
    out = {}
    for n in (2, 4):
        mesh = jax.make_mesh((n,), ("model",))
        psp = shlib.tds_param_specs(cfg, mesh)
        qsp = shlib.tds_prepared_specs(cfg, mesh)
        pp = shlib.place_tree(params, psp, mesh)
        qq = shlib.place_tree(prep, qsp, mesh)
        for key in inp["keys"].tolist():
            f = jnp.asarray(inp[key + "/feats"])
            st = {k[len(key) + 7:]: jnp.asarray(v) for k, v in inp.items()
                  if k.startswith(key + "/state/")}
            def fp32(p, f, s):
                return tds.forward_batched(p, cfg, f, s, kernels=ref,
                                           axis="model")
            def int8(p, q, f, s):
                return tds.forward_batched(p, cfg, f, s, use_int8=True,
                                           kernels=ref, prepared=q,
                                           axis="model")[0]
            lp, ns = jax.jit(compat.shard_map(
                fp32, mesh=mesh, in_specs=(psp, P(), P()),
                out_specs=(P(), P()), check_vma=False))(pp, f, st)
            out[f"{n}/fp32/{key}"] = np.asarray(lp)
            for k, v in ns.items():
                out[f"{n}/state/{key}/{k}"] = np.asarray(v)
            out[f"{n}/int8/{key}"] = np.asarray(jax.jit(compat.shard_map(
                int8, mesh=mesh, in_specs=(psp, qsp, P(), P()),
                out_specs=P(), check_vma=False))(pp, qq, f, st))
        wq, ws = ops.prepare_int8_weights(jnp.asarray(inp["w8"]))
        for ovl in (False, True):
            def prod(x, wql, ws):
                return ops.int8_matmul_prepared(x, wql, ws, policy=ref,
                                                axis="model", overlap=ovl)
            out[f"{n}/int8 product/{ovl}"] = np.asarray(jax.jit(
                compat.shard_map(prod, mesh=mesh,
                                 in_specs=(P(), P("model", None), P()),
                                 out_specs=P(), check_vma=False))(
                    jnp.asarray(inp["x8"]), wq, ws))
        def psum(x, wl):
            xl = ops.shard_local_cols(x, wl.shape[0], "model")
            return ops.psum_overlap_matmul(xl, wl, "model")
        out[f"{n}/psum overlap"] = np.asarray(jax.jit(compat.shard_map(
            psum, mesh=mesh, in_specs=(P(), P("model", None)),
            out_specs=P(), check_vma=False))(jnp.asarray(inp["x"]),
                                             jnp.asarray(inp["w"])))
    np.savez(dst, **out)
    print("JAX_SHARDED_OK")
""")


@pytest.fixture(scope="module")
def jax_sharded(demo, tmp_path_factory):
    """The reference's sharded forward, int8 products and overlapped
    contraction on 2 and 4 forced host devices (a subprocess)."""
    payload = demo[2]
    d = tmp_path_factory.mktemp("jax_sharded")
    arrays = {"keys": np.array(list(payload["inputs"])),
              **{k: payload[k] for k in ("x", "w", "x8", "w8")}}
    for key, (feats, st) in payload["inputs"].items():
        arrays[f"{key}/feats"] = feats
        arrays.update({f"{key}/state/{k}": v for k, v in st.items()})
    np.savez(d / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SHARDED, str(d / "in.npz"),
                        str(d / "out.npz")], env=env, capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert "JAX_SHARDED_OK" in r.stdout, r.stdout + r.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def _stub(names, shape):
    """What the spec functions of both packages read of a mesh."""
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _norm(spec, ndim):
    """A PartitionSpec as the port's spec: one entry per dimension."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


MESHES = [(("model",), (m,)) for m in (1, 2, 3, 4)] + [
    (("data", "model"), (2, m)) for m in (1, 2, 3, 4)] + [
    (("data",), (2,))]
CONFIGS = {"demo": lambda: asr_demo_system()[0], "TDS_CONFIG": lambda: TDS_CONFIG}


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("names,shape", MESHES)
def test_tds_specs_match_reference(cfg_name, names, shape):
    """`tds_param_specs` / `tds_prepared_specs` give the reference's
    PartitionSpecs: FC/head weights on 'model' where n_in divides it
    (of 1200/1520/1840 and the demo's 320/480, 3 divides 1200 and 480
    only), the rest whole."""
    cfg = CONFIGS[cfg_name]()
    mesh = _stub(names, shape)
    t_cfg = _t_cfg(cfg)
    ndims = {"w": {"conv": 3, "fc": 2, "head": 2}, "b": 1, "scale": 1,
             "bias": 1}
    want = jsh.tds_param_specs(cfg, mesh)
    got = tsh.tds_param_specs(t_cfg, mesh)
    assert got.keys() == want.keys()
    kinds = {s.name: s.kind for s in ttds.build_kernel_specs(t_cfg)}
    n_split = 0
    for name, leaves in want.items():
        assert got[name].keys() == leaves.keys(), name
        for leaf, spec in leaves.items():
            nd = ndims[leaf] if leaf != "w" else ndims["w"][kinds[name]]
            assert got[name][leaf] == _norm(spec, nd), (name, leaf)
            n_split += got[name][leaf][0] == "model"
    wantq = jsh.tds_prepared_specs(cfg, mesh)
    gotq = tsh.tds_prepared_specs(t_cfg, mesh)
    assert gotq.keys() == wantq.keys()
    for name in wantq:
        assert gotq[name] == {"wq": _norm(wantq[name]["wq"], 2),
                              "ws": _norm(wantq[name]["ws"], 1)}, name
    nm = dict(zip(names, shape)).get("model")
    assert n_split == sum(s.kind in ("fc", "head") and nm is not None
                          and s.n_in % nm == 0
                          for s in ttds.build_kernel_specs(t_cfg))


@pytest.mark.parametrize("names,shape", MESHES)
def test_asr_state_specs_match_reference(names, shape):
    """The pool's stream and beam state split on the slot axis over
    'data' where it divides (4 slots; 3 would not), else whole."""
    cfg, _, lex, lm, _, dec = asr_demo_system()
    mesh = _stub(names, shape)
    t_lm = tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words)
    for n in (4, 3):
        for want_tree, got_tree in (
                (jtds.init_batched_stream_state(cfg, n),
                 ttds.init_batched_stream_state(_t_cfg(cfg), n)),
                (jdec.init_batched_state(n, dec.beam_size, lm),
                 tdec.init_batched_state(n, dec.beam_size, t_lm))):
            want = jax.tree.leaves(jsh.asr_state_specs(want_tree, mesh),
                                   is_leaf=lambda x: isinstance(
                                       x, jax.sharding.PartitionSpec))
            leaves = jax.tree.leaves(want_tree)
            specs = tsh.asr_state_specs(got_tree, mesh)
            got = ([specs[k] for k in sorted(specs)]     # jax's dict order
                   if isinstance(specs, dict) else list(specs))
            assert got == [_norm(s, x.ndim) for s, x in zip(want, leaves)]


def _axes(**index):
    """A Mesh of MeshAxis records at the given indices (no world)."""
    names = tuple(index)
    sizes = {"data": 2, "model": 2}
    axes = {a: meshlib.MeshAxis(a, sizes[a], i, tuple(range(sizes[a])))
            for a, i in index.items()}
    return meshlib.Mesh(names, {a: sizes[a] for a in names}, axes)


@pytest.mark.parametrize("index", [0, 1])
def test_shard_tree_keeps_each_ranks_block_in_its_layout(index):
    """`shard_tree` cuts the rank's row block of each FC weight and of
    each int8 `wq`, whose (K, N) view over (N, K) storage stays
    K-contiguous (the int8 kernel's layout: no copy per call)."""
    cfg = asr_demo_system()[0]
    t_cfg = _t_cfg(cfg)
    params = ttds.init_tds(torch.Generator().manual_seed(0), t_cfg)
    mesh = _axes(data=1 - index, model=index)
    got = tsh.shard_tree(params, tsh.tds_param_specs(t_cfg, mesh), mesh)
    prep = ttds.quantize_params(params, t_cfg)
    gotq = tsh.shard_tree(prep, tsh.tds_prepared_specs(t_cfg, mesh), mesh)
    for s in ttds.build_kernel_specs(t_cfg):
        full = params[s.name]
        if s.kind in ("fc", "head"):
            k = s.n_in // 2
            torch.testing.assert_close(
                got[s.name]["w"], full["w"][index * k:(index + 1) * k],
                rtol=0, atol=0)
            assert got[s.name]["w"].is_contiguous()
            wq = gotq[s.name]["wq"]
            assert torch.equal(wq, prep[s.name]["wq"][index * k:
                                                      (index + 1) * k])
            assert wq.stride() == (1, k) and wq.t().is_contiguous()
            assert torch.equal(gotq[s.name]["ws"], prep[s.name]["ws"])
        for leaf in full:
            if not (leaf == "w" and s.kind in ("fc", "head")):
                assert torch.equal(got[s.name][leaf], full[leaf])
    with pytest.raises(ValueError, match="does not split"):
        tsh.local_block(torch.zeros(3, 4), ("model", None), mesh)


# ---------------------------------------------------------------------------
# ops mesh helpers and the sharded forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,chunks", [(24, 2), (9000, 2), (1840, 3), (1, 2),
                                      (5, 8), (7, 1)])
def test_overlap_splits_match_reference(n, chunks):
    assert tops.overlap_splits(n, chunks) == jops.overlap_splits(n, chunks)


def test_shard_local_cols_slices_the_ranks_columns():
    x = torch.arange(24.0).reshape(2, 12)
    for i in range(3):
        ax = meshlib.MeshAxis("model", 3, i, (0, 1, 2))
        assert torch.equal(tops.shard_local_cols(x, 4, ax),
                           x[:, 4 * i:4 * (i + 1)])


@pytest.mark.parametrize("world", WORLDS)
def test_psum_overlap_matmul_matches_sync_and_numpy(demo, port_ranks,
                                                    jax_sharded, world):
    payload = demo[2]
    want = payload["x"] @ payload["w"]
    for r in port_ranks[world]:
        np.testing.assert_allclose(r["psum overlap"], r["psum sync"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["psum sync"], want, atol=1e-5)
    np.testing.assert_allclose(port_ranks[world][0]["psum overlap"],
                               jax_sharded[f"{world}/psum overlap"],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("key", [f"{b}x{t}" for b, t in FORWARD_SHAPES])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_forward_matches_jax(demo, port_ranks, jax_sharded, world,
                                     key):
    """`forward_batched(axis=)` at 2 and 4 model ranks: within 1e-5 of
    JAX's unsharded forward and of JAX's sharded one, log-probs and
    state; every rank holds the same bits; the overlapped contraction
    within 1e-6 of the synchronous one."""
    tds_cfg, params, payload = demo
    feats, st = payload["inputs"][key]
    want_lp, want_st = jtds.forward_batched(
        params, tds_cfg, jnp.asarray(feats),
        {k: jnp.asarray(v) for k, v in st.items()}, kernels=JaxPolicy("ref"))
    lp, ns = port_ranks[world][0][f"fp32 {key}"]
    assert lp.shape == np.asarray(want_lp).shape
    np.testing.assert_allclose(lp, np.asarray(want_lp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lp, jax_sharded[f"{world}/fp32/{key}"],
                               rtol=1e-5, atol=1e-5)
    for k in want_st:
        np.testing.assert_allclose(ns[k], np.asarray(want_st[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(
            ns[k], jax_sharded[f"{world}/state/{key}/{k}"], rtol=1e-5,
            atol=1e-5, err_msg=k)
    for r in port_ranks[world]:
        np.testing.assert_array_equal(r[f"fp32 {key}"][0], lp)
        np.testing.assert_allclose(r[f"overlap {key}"], lp, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_sharded_product_matches_jax_sharded(demo, port_ranks,
                                                  jax_sharded, world):
    """`int8_matmul_prepared(axis=)` quantizes the full rows, so its
    scales are the unsharded ones: its partial products equal JAX's
    sharded path's (bitwise on 2 ranks), with and without the overlap."""
    payload = demo[2]
    x8, w8 = payload["x8"], payload["w8"]
    wq, ws = jops.prepare_int8_weights(jnp.asarray(w8))
    unsharded = np.asarray(jops.int8_matmul_prepared(
        jnp.asarray(x8), wq, ws, policy=JaxPolicy("ref")))
    tol = dict(rtol=0, atol=0) if world == 2 else dict(rtol=1e-5, atol=1e-5)
    for r in port_ranks[world]:
        for ovl, key in ((False, "int8 product"),
                         (True, "int8 product overlap")):
            np.testing.assert_allclose(
                r[key], jax_sharded[f"{world}/int8 product/{ovl}"], **tol)
            np.testing.assert_allclose(r[key], unsharded, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("key", [f"{b}x{t}" for b, t in FORWARD_SHAPES])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_sharded_forward_matches_jax(demo, port_ranks, jax_sharded,
                                          world, key):
    """The sharded int8 forward (prepared weights cut to the rank's
    rows) against JAX's sharded and unsharded int8 forwards."""
    tds_cfg, params, payload = demo
    feats, st = payload["inputs"][key]
    want = jtds.forward_batched(
        params, tds_cfg, jnp.asarray(feats),
        {k: jnp.asarray(v) for k, v in st.items()}, use_int8=True,
        kernels=JaxPolicy("ref"),
        prepared=jtds.quantize_params(params, tds_cfg))[0]
    got = port_ranks[world][0][f"int8 {key}"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(got, jax_sharded[f"{world}/int8/{key}"],
                               atol=1e-4)
    for r in port_ranks[world]:
        np.testing.assert_array_equal(r[f"int8 {key}"], got)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_only_their_weight_rows(port_ranks, world):
    """The demo's 320-wide FC weights: 320 / world rows a rank, and the
    int8 shard K-contiguous."""
    for r in port_ranks[world]:
        assert r["fc_rows"] == 320 // world
        assert r["wq_stride"] == (1, 320 // world)


# ---------------------------------------------------------------------------
# ranks, axes and the backend
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def layout4(tmp_path_factory):
    return ranks.run(4, tmp_path_factory.mktemp("layout"), "layout", None)


def test_mesh_layout_is_row_major_with_one_group_per_axis_line(layout4):
    """rank = d * 2 + m on a 2x2 mesh, as jax.make_mesh lays devices
    out; an all-reduce over 'model' sums the two ranks of a data row, a
    broadcast over 'data' reaches down a model column; a mesh over ranks
    (0, 1) gives the others None."""
    for rank, r in enumerate(layout4):
        d, m = divmod(rank, 2)
        assert r["coords"] == {"data": d, "model": m}
        assert r["shape"] == {"data": 2, "model": 2} and r["size"] == 4
        assert r["ranks"] == {"data": (m, 2 + m), "model": (2 * d, 2 * d + 1)}
        assert r["sub"] == ({"model": rank} if rank < 2 else None)
        row = 2 * d
        np.testing.assert_array_equal(r["model_sum"],
                                      np.full((3,), (row + 1) + (row + 2),
                                              np.float32))
        assert r["data_bcast"] == {"from": 2 + m}


@pytest.mark.parametrize("device_type,local,cards,want", [
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 8, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 1, "gloo"), ("cuda", 2, 1, "gloo"), ("cpu", 4, 0, "gloo"),
    ("cpu", 1, 8, "gloo")])
def test_choose_backend(device_type, local, cards, want):
    """nccl only when every rank of the host has a card of its own."""
    assert meshlib.choose_backend(device_type, local, cards) == want


def test_one_rank_mesh_needs_no_world_and_bad_meshes_raise():
    m = meshlib.make_mesh((1, 1), ("data", "model"))
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.coords == {"data": 0, "model": 0}
    t = torch.ones(3)
    assert m.axis("model").all_reduce(t) is None and torch.equal(
        t, torch.ones(3))
    assert m.axis("model").all_reduce(t, async_op=True).wait()
    assert m.axis("data").broadcast_object({"a": 1}, 0) == {"a": 1}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        meshlib.make_mesh((2,), ("model",))
    with pytest.raises(RuntimeError, match="init_ranks"):
        meshlib.make_mesh((2,), ("model",), ranks=(0, 1))
    with pytest.raises(ValueError, match="shape"):
        meshlib.make_mesh((2,), ("data", "model"))
    with pytest.raises(ValueError, match="'model' axes of 2"):
        meshlib.make_local_mesh(model=2)


def test_init_ranks_without_torchrun_env_names_torchrun(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node"):
        meshlib.init_ranks("cpu")
    with pytest.raises(ValueError, match="rank and world_size"):
        meshlib.init_ranks("cpu", init_method="file:///nonexistent")
    assert not torch.distributed.is_initialized()


def test_rank_device(monkeypatch):
    assert rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device("cuda")


def test_mesh_repr_names_its_axes():
    m = meshlib.make_mesh((1,), ("model",))
    assert json.dumps(m.shape) == '{"model": 1}'
    assert "'model': 1" in repr(m) and "rank 0" in repr(m)
