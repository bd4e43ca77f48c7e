"""The port's LM mesh against the JAX package's, on the CPU: the serving
cells of `launch/steps.build_cell` (prefill, then one decode step) on a
('data', 'model') mesh of gloo ranks, `moe.apply_moe_ep` and
`layers.attention_decode_sharded`.

The ranks are spawned processes (`_torch_mesh_ranks`), one module-scoped
world of 2 and one of 4.  The reference's sharded functions run in one
subprocess on 4 forced host devices, beside the ranks, on meshes built
with `axis_types=(AxisType.Auto,) * 2`: jax 0.9's `make_mesh` defaults
to Explicit axes, under which the reference's GSPMD `Sharder` raises
(its own slow tests fail so; ROADMAP Queue 3).  Both packages get the
same numpy parameters (drawn here, tiny configs) and tokens.  The cells run on int8
serving weights, as `build_cell` serves by default; the port's
quantization is bitwise the reference's (`test_torch_int8_lm.py`).

Tolerances:
  * fp32 prefill logits, decode logits and caches (each rank's blocks
    against the blocks of the reference's sharded cache and of the
    port's unsharded model's): atol 1e-5, the sharded functions' own
    bound (measured up to ~4e-6: row-parallel partials summed in another
    order); jamba-v0.1-52b 1e-3, its existing bound in
    `test_torch_lm.py` (its SSD chains amplify the summation order);
    decode tokens equal;
  * `apply_moe_ep`: y and aux atol 1e-5, on local capacities that drop
    nothing and on ones that drop (the dropped tokens must be the
    reference's: any other drop moves y by O(1)); and the GSPMD path
    with experts that do not divide the mesh (tensor parallel within
    each expert);
  * `attention_decode_sharded`, with and without a window: 1e-5;
  * one bf16 cell (h2o-danube-1.8b, 2x2): prefill logits within 2e-2 of
    max |logit| of the reference's sharded cell's (bf16 roundings in
    another order).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.moe import local_capacity  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
         "jamba-v0.1-52b")
# each arch on 2 ranks and on 4: h2o-danube's 4/2 heads at 'model' = 4
# take the query-row split, qwen2-moe's 4 experts split 4 ways, mamba2's
# 8 heads 4 ways; 2x2 splits the batch (and the FSDP weight blocks)
CELLS = {"1x2": ARCHS, "1x4": ARCHS[:3],
         "2x2": ("h2o-danube-1.8b", "jamba-v0.1-52b"),
         # 3 divides no head count nor S = 64: the attention on every rank
         # whole, Mamba whole on every rank, weights the rules keep whole
         "1x3": ("h2o-danube-1.8b", "mamba2-1.3b")}
WORLD = {"1x2": 2, "1x4": 4, "2x2": 4, "1x3": 4}
B, S = 4, 64
ATOL = {"jamba-v0.1-52b": 1e-3}
BF16_CASE = ("h2o-danube-1.8b", "2x2")
# a batch of 3 does not split over 'data' = 2: every rank holds the whole
# batch and the cache's sequence splits over ('data', 'model')
ODD_BATCH = ("h2o-danube-1.8b", "2x2", 3)


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_config(arch).tiny(), dtype=dtype)


def _cases():
    """(name, arch, mesh, dtype) of every cell."""
    out = [(f"{a} {m}", a, m, "float32") for m, archs in CELLS.items()
           for a in archs]
    a, m = BF16_CASE
    a2, m2, b2 = ODD_BATCH
    return out + [(f"{a} {m} bf16", a, m, "bfloat16"),
                  (f"{a2} {m2} B={b2}", a2, m2, "float32")]


def _batch(name) -> int:
    return ODD_BATCH[2] if name.endswith(f"B={ODD_BATCH[2]}") else B


JAX_SHARDED = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import MoESpec, ShapeSpec
    from repro.launch.steps import build_cell
    from repro.models import layers, moe
    from repro.models.transformer import LM
    from repro.parallel.sharding import Sharder

    cases, moe_cases, attn_cases = pickle.load(open(sys.argv[1], "rb"))
    tree = lambda t: jax.tree.map(jnp.asarray, t)

    def mesh_of(spec):
        r, c = (int(v) for v in spec.split("x"))
        return jax.make_mesh((r, c), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:r * c])

    out = {"cells": {}, "moe": {}, "attn": {}}
    for c in cases:
        cfg = dataclasses.replace(get_config(c["arch"]).tiny(),
                                  dtype=c["dtype"])
        params = layers.quantize_params_for_serving(jax.tree.map(
            lambda a, d: jnp.asarray(a).astype(jnp.dtype(d)), c["params"],
            c["dtypes"]))
        tok, nxt, name = c["tokens"], c["next"], c["name"]
        b, s = tok.shape
        mesh = mesh_of(c["mesh"])
        with mesh:
            fp, _ = build_cell(cfg, ShapeSpec("p", s, b, "prefill"), mesh)
            fd, _ = build_cell(cfg, ShapeSpec("d", s, b, "decode"), mesh)
            logits, cache = fp(params, {"tokens": tok})
            cache_np = jax.tree.map(np.asarray, cache)
            tk, cache = fd(params, cache, {"tokens": nxt[:, None]})
        out["cells"][name] = {
            "logits": np.asarray(logits.astype(jnp.float32)),
            "cache_prefill": cache_np,
            "dec_tok": np.asarray(tk),
            "cache_decode": jax.tree.map(np.asarray, cache)}
    for c in moe_cases:
        ms = MoESpec(**c["spec"])
        mesh = mesh_of(c["mesh"])
        with mesh:
            y, aux = jax.jit(lambda p, x: moe.apply_moe(
                p, x, ms, "silu", sharder=Sharder(mesh)))(
                    tree(c["params"]), jnp.asarray(c["x"]))
        out["moe"][c["name"]] = {"y": np.asarray(y), "aux": float(aux)}
    for c in attn_cases:
        name, window = c["name"], c["window"]
        mesh = mesh_of(c["mesh"])
        from repro.models.layers import attention_decode_sharded
        a = {k: jnp.asarray(v) for k, v in c["inputs"].items()}
        with mesh:
            y = jax.jit(lambda a: attention_decode_sharded(
                a["q"], a["k"], a["v"], a["qpos"], a["kpos"], window=window,
                k_new=a["k_new"], v_new=a["v_new"],
                sharder=Sharder(mesh)))(a)
        out["attn"][name] = np.asarray(y)
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_LM_MESH_OK")
""")

MOE_CASES = [  # (name, mesh, spec, seed): capacity factor 8 drops nothing
    (f"{m} cf{cf}", m, dict(n_experts=4, top_k=2, expert_d_ff=32,
                            capacity_factor=cf), 5)
    for m in ("1x2", "1x4", "2x2") for cf in (8.0, 1.0)] + [
    # 3 experts do not split over 2 ranks: the GSPMD path, each rank its
    # block of every expert's d_ff, global capacity
    ("1x2 E3", "1x2", dict(n_experts=3, top_k=2, expert_d_ff=32,
                           capacity_factor=1.0), 6)]


def _attn_inputs(seed, Sc=32, H=4, K=2, D=16):
    r = np.random.RandomState(seed)
    f = np.float32
    kpos = np.arange(Sc, dtype=np.int32) + 40
    kpos[5] = -1                                   # an empty slot
    return {"q": r.randn(B, 1, H, D).astype(f),
            "k": r.randn(B, Sc, K, D).astype(f),
            "v": r.randn(B, Sc, K, D).astype(f),
            "qpos": np.full((B,), 40 + Sc, np.int32),
            "kpos": kpos,
            "k_new": r.randn(B, 1, K, D).astype(f),
            "v_new": r.randn(B, 1, K, D).astype(f)}


ATTN_CASES = [(f"{m} w{w}", m, w, _attn_inputs(7)) for m in ("1x2", "1x4",
                                                              "2x2")
              for w in (None, 24)]


def _np_tree(tree):
    """(fp32 numpy leaves, dtype names) of a parameter tree."""
    if isinstance(tree, dict):
        pairs = {k: _np_tree(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: d for k, (_, d) in pairs.items()})
    return tree.float().numpy(), str(tree.dtype).replace("torch.", "")


def _varied(tree, gen=None):
    """`init`'s tree with its constant per-channel vectors (norm scales,
    A_log, D, dt_bias, biases: ones or zeros at init) made random, so a
    rank taking the wrong slice of one shows."""
    gen = torch.Generator().manual_seed(11) if gen is None else gen
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _varied(v, gen)
        elif k in ("scale", "bias", "b", "A_log", "D", "dt_bias"):
            out[k] = (v.float() + 0.2 * torch.randn(v.shape, generator=gen)
                      ).to(v.dtype)
        else:
            out[k] = v
    return out


def _params_of(arrays, dtypes):
    """The tensors of `_np_tree`'s output, in their dtypes."""
    if isinstance(arrays, dict):
        return {k: _params_of(arrays[k], dtypes[k]) for k in arrays}
    return torch.from_numpy(arrays).to(getattr(torch, dtypes))


@pytest.fixture(scope="module")
def inputs():
    """Every cell's, MoE case's and attention case's inputs: the
    parameters drawn by the port's `init` from a seed, tokens from
    numpy seeds."""
    from repro_torch.configs.base import MoESpec
    from repro_torch.models import moe
    cells, params = [], {}
    for name, arch, mesh, dtype in _cases():
        cfg = _cfg(arch, dtype)
        if (arch, dtype) not in params:
            params[arch, dtype] = _np_tree(_varied(
                LM(cfg).init(torch.Generator().manual_seed(3))))
        arrays, dtypes = params[arch, dtype]
        rng = np.random.RandomState(3)
        cells.append({
            "name": name, "arch": arch, "mesh": mesh, "dtype": dtype,
            "world": _world(mesh),
            "cfg": {**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(cfg)},
                    "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
                    "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None},
            "params": arrays, "dtypes": dtypes,
            "tokens": rng.randint(0, cfg.vocab_size,
                                  (_batch(name), S)).astype(np.int32),
            "next": rng.randint(0, cfg.vocab_size,
                                (_batch(name),)).astype(np.int32)})
    moes = []
    for name, mesh, spec, seed in MOE_CASES:
        p = moe.init_moe(torch.Generator().manual_seed(seed), 16,
                         MoESpec(**spec), dtype=torch.float32)
        moes.append({"name": name, "mesh": mesh, "spec": spec,
                     "params": _np_tree(p)[0],
                     "x": np.random.RandomState(seed).randn(
                         B, S, 16).astype(np.float32)})
    attns = [{"name": n, "mesh": m, "window": w, "inputs": inp}
             for n, m, w, inp in ATTN_CASES]
    return {"lm_cells": {"cases": cells}, "moe_ep": {"cases": moes},
            "decode_attn": {"cases": attns}}


@pytest.fixture(scope="module")
def jax_proc(inputs, tmp_path_factory):
    """The reference's sharded cells, EP MoE and flash-decoding: one
    subprocess on 4 forced host devices, started before the ranks and
    running beside them."""
    import pickle
    d = tmp_path_factory.mktemp("jax_lm_mesh")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump((inputs["lm_cells"]["cases"], inputs["moe_ep"]["cases"],
                     inputs["decode_attn"]["cases"]), f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SHARDED, str(d / "in.pkl"),
         str(d / "out.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def port_ranks(inputs, jax_proc, tmp_path_factory):
    """{world: {job: [rank 0's results, ...]}}: one world of 2 ranks and
    one of 4, each running the three jobs."""
    out = {}
    for world in (2, 4):
        res = ranks.run(world, tmp_path_factory.mktemp(f"lm_mesh{world}"),
                        "lm_mesh", inputs)
        out[world] = {job: [r[job] for r in res] for job in res[0]}
    return out


@pytest.fixture(scope="module")
def jax_ref(jax_proc, port_ranks):
    import pickle
    proc, d = jax_proc
    out, err = proc.communicate(timeout=900)
    assert "JAX_LM_MESH_OK" in out, out + err[-3000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _world(mesh: str) -> int:
    """The world of ranks a mesh's cases run in."""
    return WORLD[mesh]


def _ranks(mesh: str) -> int:
    r, c = (int(v) for v in mesh.split("x"))
    return r * c


class _View:
    """A rank's coordinates as `sharding.local_block` reads a mesh."""

    def __init__(self, mesh, coords):
        r, c = (int(v) for v in mesh.split("x"))
        self.shape = {"data": r, "model": c}
        self.coords = coords

    def axis(self, entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        size, index = 1, 0
        for n in names:
            size, index = (size * self.shape[n],
                           index * self.shape[n] + self.coords[n])
        return SimpleNamespace(size=size, index=index)


def _blocks_close(got, want, specs, view, atol, what):
    """Every leaf of a rank's cache blocks against the block of a whole
    cache (`want`: numpy or tensors) under `specs`."""
    if isinstance(got, dict):
        assert got.keys() == want.keys(), what
        for k in got:
            _blocks_close(got[k], want[k], specs[k], view, atol,
                          f"{what}/{k}")
        return
    blk = tsh.local_block(torch.as_tensor(np.asarray(want)), specs, view)
    np.testing.assert_allclose(got, blk.numpy(), rtol=0, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's one-device model on each arch's int8 serving weights:
    (prefill logits, prefill cache, decode logits, decode token)."""
    out = {}
    for c in inputs["lm_cells"]["cases"]:
        lm = LM(_cfg(c["arch"], c["dtype"]), KernelPolicy("ref"))
        params = layers.quantize_params_for_serving(
            _params_of(c["params"], c["dtypes"]))
        logits, cache = lm.prefill(params, {"tokens": torch.from_numpy(
            c["tokens"])})
        pre = {p: {k: v.float().numpy().copy() for k, v in t.items()}
               for p, t in cache["layers"].items()}
        lg, tk, _ = lm.decode_step(params, cache, {"tokens": torch.from_numpy(
            c["next"])[:, None]})
        out[c["name"]] = (logits.float().numpy(), pre, lg.numpy(),
                          tk.numpy())
    return out


def _finite(a):
    return np.where(np.isfinite(a), a, 0.0)


@pytest.mark.parametrize("name,arch,mesh,dtype", _cases())
def test_cells_match_reference_and_unsharded(name, arch, mesh, dtype,
                                             jax_ref, port_ranks, unsharded):
    """Every rank: the whole prefill logits and decode tokens equal on
    all ranks and against the reference's sharded cells and the port's
    one-device model; each rank's cache blocks (after prefill, after the
    step) against the reference's sharded cache; the argument shapes
    build_cell reports are the rank's blocks'."""
    ref = jax_ref["cells"][name]
    outs = [o[name] for o in port_ranks[_world(mesh)]["lm_cells"]
            if name in o]
    assert len(outs) == _ranks(mesh)
    u_logits, u_cache, u_dec, u_tok = unsharded[name]
    if dtype == "bfloat16":
        scale = np.abs(ref["logits"]).max()
        for o in outs:
            assert np.abs(o["logits"] - ref["logits"]).max() <= 2e-2 * scale
        return
    atol = ATOL.get(arch, 1e-5)
    for o in outs:
        assert o["shapes"], "build_cell's local shapes"
        np.testing.assert_allclose(o["logits"], ref["logits"], rtol=0,
                                   atol=atol)
        np.testing.assert_allclose(o["logits"], u_logits, rtol=0, atol=atol)
        np.testing.assert_allclose(_finite(o["dec_logits"]), _finite(u_dec),
                                   rtol=0, atol=atol)
        np.testing.assert_array_equal(o["dec_tok"], ref["dec_tok"])
        np.testing.assert_array_equal(o["dec_tok"], u_tok)
        np.testing.assert_array_equal(o["dec_tok2"], u_tok)
        view = _View(mesh, o["coords"])
        sp = o["cache_specs"]
        _blocks_close(o["cache_prefill"]["layers"],
                      ref["cache_prefill"]["layers"], sp["layers"], view,
                      atol, f"{name} prefill cache")
        _blocks_close(o["cache_prefill"]["layers"], u_cache, sp["layers"],
                      view, atol, f"{name} vs unsharded")
        _blocks_close(o["cache_decode"]["layers"],
                      ref["cache_decode"]["layers"], sp["layers"], view,
                      atol, f"{name} decode cache")
        for when in ("cache_prefill", "cache_decode"):
            np.testing.assert_array_equal(
                o[when]["kpos"], tsh.local_block(torch.from_numpy(
                    np.asarray(ref[when]["kpos"])), sp["kpos"], view).numpy())
            assert int(o[when]["offset"]) == int(ref[when]["offset"])


@pytest.mark.parametrize("name,mesh,spec,seed", MOE_CASES)
def test_apply_moe_ep_matches_reference(name, mesh, spec, seed, jax_ref,
                                        port_ranks):
    """Expert parallelism on the rank's tokens with the local capacity:
    y (each rank's batch rows) and aux against the reference's; with a
    capacity factor of 1 tokens are dropped, the reference's."""
    ref = jax_ref["moe"][name]
    outs = [o[name] for o in port_ranks[_world(mesh)]["moe_ep"]]
    nd = int(mesh.split("x")[0])
    for o in outs:
        rows = ref["y"].shape[0] // nd
        d = o["coords"]["data"]
        np.testing.assert_allclose(o["y"], ref["y"][d * rows:(d + 1) * rows],
                                   rtol=0, atol=1e-5)
        assert abs(o["aux"] - ref["aux"]) <= 1e-5
    drops = sum(sum(o["drops"]) for o in outs)
    ep = spec["n_experts"] % int(mesh.split("x")[1]) == 0
    assert (drops > 0) == (ep and spec["capacity_factor"] == 1.0), drops


def test_local_capacity_is_the_references():
    """Cl = the multiple of 8 at or above int(Tl·k·cf / E), at least 8."""
    from repro_torch.configs.base import MoESpec
    for tl in (1, 7, 64, 100, 1024, 2048, 4095):
        for cf in (1.0, 1.25, 8.0):
            s = MoESpec(n_experts=60, top_k=4, expert_d_ff=8,
                        capacity_factor=cf)
            want = max(8, -(-int(tl * 4 * cf / 60) // 8) * 8)
            assert local_capacity(tl, s) == want


@pytest.mark.parametrize("name,mesh,window,attn_in", ATTN_CASES)
def test_attention_decode_sharded_matches_reference(name, mesh, window,
                                                    attn_in, jax_ref,
                                                    port_ranks):
    """Flash-decoding over the rank's sequence block (and batch rows)
    against the reference's, and the one-device attention."""
    ref = jax_ref["attn"][name]
    t = {k: torch.from_numpy(v) for k, v in attn_in.items()}
    one = layers.attention_decode(t["q"], t["k"], t["v"], t["qpos"],
                                  t["kpos"], window=window, k_new=t["k_new"],
                                  v_new=t["v_new"]).numpy()
    np.testing.assert_allclose(ref, one, rtol=0, atol=1e-5)
    nd = int(mesh.split("x")[0])
    for o in (r[name] for r in port_ranks[_world(mesh)]["decode_attn"]):
        rows = B // nd
        d = o["coords"]["data"]
        np.testing.assert_allclose(o["y"], ref[d * rows:(d + 1) * rows],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_axis_collectives(world, port_ranks):
    """All-gather along a dimension, all-to-all of equal dim-0 blocks,
    the MAX all-reduce over 'model', and an all-gather
    over the combined ('data', 'model') axis in row-major order."""
    outs = port_ranks[world]["collectives"]
    nm = 2
    for me, o in enumerate(outs):
        d, m = o["coords"]["data"], o["coords"]["model"]
        line = [d * nm + j for j in range(nm)]            # the model axis
        base = np.arange(3.0)
        np.testing.assert_array_equal(o["gather"], np.concatenate(
            [np.full((2, 3), float(r)) + base for r in line], 1))
        np.testing.assert_array_equal(o["to_all"], np.stack(
            [np.arange(4.0).reshape(2, 2)[m] + 10 * r for r in line]))
        np.testing.assert_array_equal(o["max"], np.full((2, 3), float(
            line[-1])) + base)
        np.testing.assert_array_equal(o["both"], np.arange(float(world)))
        assert "needs 256 ranks" in o["production"], o["production"]
