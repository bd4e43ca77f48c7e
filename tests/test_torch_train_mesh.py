"""LM training on the port's ('data', 'model') mesh against the JAX
package's, on the CPU: `LM.loss_fn` under a `Sharder`, its gradients,
`launch/steps.build_cell`'s train cell, the differentiable collectives
of `launch/mesh.py`, the int8 moments' blocks, and `launch/train.py
--mesh` under torchrun.

The ranks are spawned processes (`_torch_mesh_ranks`): one world of 4
runs every mesh case (a mesh of 2 over the world's first two ranks),
and one world of 2 the collectives.  The reference runs in three
subprocesses on 4 forced host devices, beside the ranks, with
`axis_types=(AxisType.Auto,) * 2` (its `Sharder` raises under jax 0.9's
default Explicit axes; ROADMAP Queue 3).  Both packages get the same
numpy parameters (the port's `init`, its constant per-channel vectors
made random so that a wrong slice shows) and batch (tiny configs in
fp32, B = 4, S = 64, labels with -1 pads).

What is held, and the tolerances:
  * the loss and the metrics of `loss_fn` under the mesh against the
    reference's sharded `loss_fn` (atol 1e-5; ntok exactly), on every
    rank alike;
  * every leaf's gradient, completed and gathered whole on the ranks,
    against the reference's `jax.grad` of that `loss_fn`: max |Δ| within
    1e-4 of the leaf's max |g| (jamba-v0.1-52b 3e-3), the bounds of
    `test_torch_train.py`.  Gradients are compared directly: AdamW's
    update is per element invariant to a constant factor in that
    element's gradient, so a gradient n times too large would leave the
    parameters nearly unchanged;
  * the state after one and after two steps of the train cell (each
    rank's blocks) against the reference's cell: the update (new - old)
    within 1e-3 of the reference's in L2 norm over the tree, relative
    (jamba and int8 moments 2e-2; 0.5 a leaf: see UPDATE_REL), and each
    moment within twice the gradients' bound in L2 norm, relative.
    int8 moments: the scales within that bound; a q element one step
    from the reference's at most, on at most Q_FLIPS of a block, each
    new one where the reference's unrounded moment over its scale
    (rebuilt from the reference's gradients of the step) lies within
    Q_EDGE of a rounding boundary.  The first step's Adam update is
    nearly the sign of g, so no elementwise bound short of 2·lr holds
    (see `test_torch_train.py`), and the moments hold the gradients'
    values.  jamba's second step is held to the reference's one-device
    step (a JAX subprocess) from the mesh's own first-step state: after
    one step its 16 random tiny layers and top-2 routers turn the two
    frameworks' roundings into different routes (its moments ~0.3
    apart in L2 against the reference cell's, its first step's within
    1.6e-3);
  * the int8 moments' quantization of a leaf whose 128-wide rows split
    over 'model' (64 a rank, half a quantization block): bitwise the
    reference's `quant.quantize` of the whole rows;
  * each differentiable collective's backward against the same
    computation done whole in one process (atol 1e-5), and the serving
    collectives' refusal of a tensor that requires grad;
  * `apply_moe`'s GSPMD path at 2x2 (a batch gathered over 'data',
    experts split on d_ff, a whole shared expert added by one rank):
    value and gradients against the one-device function (1e-5);
  * the launcher at --model-parallel 2: in a world of 2 on the tiny
    config in fp32, every loss of 3 steps within 1e-5 relative of the
    one-device launcher's; under torchrun with `--tiny` (bf16), its
    first loss within 1e-5, the next two within 5e-4.  In bf16 the two
    runs' gradients differ in one bf16 rounding here and there (sums of
    partials in another order), so after a step some bf16 parameters
    sit an ulp apart: the losses moved by 2.1e-5 and 7.9e-5 relative,
    and by 5.4e-5 and 1.9e-4 when the mesh's column-parallel products
    were made to round their input gradients once, as one device does:
    rounding noise either way, not a fault.
"""
import dataclasses
import json
import os
import pickle
import re
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
from repro.core import quant as jquant  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.core.treeutil import (leaves_with_paths,  # noqa: E402
                                       tree_map)
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O, MOE, SSM, HYB = ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                      "jamba-v0.1-52b")
# (name, arch, mesh, moment dtype).  h2o-danube's 4/2 heads at 'model' = 4
# take the query-row split; qwen2-moe's 4 experts split over 'model'
# (expert parallel), and at 2x2 the cell's default 4 microbatches of one
# row do not split over 'data' = 2 (whole on every data rank: the GSPMD
# path); jamba's cell is 4 one-row microbatches too.  The int8 case's
# w_gate/w_up rows (d_ff = 128) split over 'model' = 2
CASES = [(f"{H2O} 1x2", H2O, "1x2", "float32"),
         (f"{H2O} 1x4", H2O, "1x4", "float32"),
         (f"{H2O} 2x2", H2O, "2x2", "float32"),
         (f"{MOE} 1x4", MOE, "1x4", "float32"),
         (f"{MOE} 2x2", MOE, "2x2", "float32"),
         (f"{SSM} 1x2", SSM, "1x2", "float32"),
         (f"{HYB} 2x2", HYB, "2x2", "float32"),
         (f"{H2O} 1x2 int8", H2O, "1x2", "int8")]
NAMES = [c[0] for c in CASES]
# the reference's cells in three subprocesses that run together (jamba
# alone takes ~70 s, most of it compiling)
JAX_GROUPS = ([c for c in NAMES if c.startswith(HYB)],
              [c for c in NAMES if c.startswith((MOE, SSM))],
              [c for c in NAMES if c.startswith(H2O)])
B, S = 4, 64
LOSS_ATOL = 1e-5
# jamba: its 16 random tiny layers amplify the two frameworks' roundings
# (`test_torch_lm_mesh.py` holds its logits to 1e-3); its loss was
# 1.3e-5 from the reference's sharded loss
LOSS_ATOL_ARCH = {HYB: 1e-4}
GRAD_REL = {HYB: 3e-3}
# a step's update (new - old), relative in L2: the first Adam step is
# nearly lr·sign(g), so an element whose |g| lies within the two
# frameworks' roundings of 0 can step the other way (2·lr apart): over
# the whole tree within UPDATE_REL (fp32 moments: measured at most
# 2.2e-4, mamba2-1.3b; jamba's gradient bound lets more elements flip,
# 9.8e-3 measured; int8 moments one quantization step apart, 1/127 of
# a block's largest, 7.4e-3 measured), each leaf within LEAF_UPDATE_REL
# (one such element in a leaf of 128 is 0.125), which a leaf updated
# wrongly or not at all misses.  The moments within the gradients'
# bound, relative (m is 0.1·g after the first step; v, g², twice it)
UPDATE_REL = {"fp32": 1e-3, "jamba": 2e-2, "int8": 2e-2}
LEAF_UPDATE_REL, MOMENT_REL = 0.5, 1e-4
# int8 moments: a q element may differ from the reference's by one step,
# on at most Q_FLIPS of a rank's block, and a new difference only where
# the reference's unrounded m / scale (or v / scale) lies within Q_EDGE
# steps of a rounding boundary (read: at most 1.53e-4 of a step, and
# 2.44e-4 of a block flipped, of which some carried from the first step)
Q_EDGE, Q_FLIPS = 1e-3, 1e-3

JAX_TRAIN = textwrap.dedent("""
    import dataclasses, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch.steps import build_cell, build_lm
    from repro.optim import adamw

    cases = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for c in cases:
        cfg = dataclasses.replace(get_config(c["arch"]).tiny(),
                                  dtype="float32")
        r, m = (int(v) for v in c["mesh"].split("x"))
        mesh = jax.make_mesh((r, m), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:r * m])
        params = jax.tree.map(jnp.asarray, c["params"])
        batch = {"tokens": jnp.asarray(c["tokens"]),
                 "labels": jnp.asarray(c["labels"])}
        b, s = c["tokens"].shape
        res = {}
        with mesh:
            lm = build_lm(cfg, mesh)
            vg = jax.jit(jax.value_and_grad(
                lambda p: lm.loss_fn(p, batch), has_aux=True))
            (loss, met), g = vg(params)
            res["loss"] = float(loss)
            res["metrics"] = {k: float(v) for k, v in met.items()}
            res["grads"] = jax.tree.map(np.asarray, g)
            ocfg = adamw.AdamWConfig(moment_dtype=c["moments"])
            fn, _ = build_cell(cfg, ShapeSpec("t", s, b, "train"), mesh,
                               opt_cfg=ocfg)
            state = {"params": params, "opt": adamw.init(params, ocfg),
                     "step": jnp.zeros((), jnp.int32)}
            res["steps"] = []
            for _ in range(2):
                if c["moments"] == "int8":     # the step's gradients
                    res.setdefault("step_grads", []).append(jax.tree.map(
                        np.asarray, vg(state["params"])[1]))
                state, met = fn(state, batch)
                res["steps"].append({
                    "state": jax.tree.map(np.asarray, state),
                    "metrics": {k: float(v) for k, v in met.items()}})
        out[c["name"]] = res
    pickle.dump(out, open(sys.argv[2], "wb"))
    print("JAX_TRAIN_MESH_OK")
""")

# the reference's one-device train step (`make_train_step`, AdamW's
# defaults) from a given whole state, on the whole batch
JAX_ONE_STEP = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.launch.steps import build_lm, make_train_step
    from repro.optim import adamw

    c = pickle.load(open(sys.argv[1], "rb"))
    cfg = dataclasses.replace(get_config(c["arch"]).tiny(), dtype="float32")
    step = jax.jit(make_train_step(build_lm(cfg, None), adamw.AdamWConfig(),
                                   accum=c["accum"]))
    w = jax.tree.map(jnp.asarray, c["state"])
    state = {"params": w["params"], "opt": w["opt"],
             "step": jnp.asarray(c["step"], jnp.int32)}
    new, met = step(state, {"tokens": jnp.asarray(c["tokens"]),
                            "labels": jnp.asarray(c["labels"])})
    pickle.dump({"state": jax.tree.map(np.asarray, new),
                 "metrics": {k: float(v) for k, v in met.items()}},
                open(sys.argv[2], "wb"))
    print("JAX_ONE_STEP_OK")
""")


def _cfg(arch):
    return dataclasses.replace(get_config(arch).tiny(), dtype="float32")


def _cfg_payload(cfg) -> dict:
    return {**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)},
            "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
            "ssm": dataclasses.asdict(cfg.ssm) if cfg.ssm else None}


def _varied(tree, gen):
    """`init`'s tree with its constant per-channel vectors (norm scales,
    A_log, D, dt_bias: ones or zeros at init) made random."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _varied(v, gen)
        elif k in ("scale", "bias", "b", "A_log", "D", "dt_bias"):
            out[k] = v + 0.2 * torch.randn(v.shape, generator=gen)
        else:
            out[k] = v
    return out


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class _View:
    """A rank's coordinates as `sharding.local_block` reads a mesh."""

    def __init__(self, mesh, coords):
        r, c = (int(v) for v in mesh.split("x"))
        self.axis_names = ("data", "model")
        self.shape = {"data": r, "model": c}
        self.coords = coords

    def axis(self, entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        size, index = 1, 0
        for n in names:
            size, index = (size * self.shape[n],
                           index * self.shape[n] + self.coords[n])
        return SimpleNamespace(size=size, index=index)


def _block(whole, spec, view):
    return tsh.local_block(torch.from_numpy(np.asarray(whole)), spec,
                           view).numpy()


@pytest.fixture(scope="module")
def inputs():
    """Every case's parameters (the port's `init` from a seed, varied)
    and batch, the MoE case's and the collectives' inputs."""
    cases, drawn = [], {}
    for name, arch, mesh, moments in CASES:
        cfg = _cfg(arch)
        if arch not in drawn:
            gen = torch.Generator().manual_seed(5)
            drawn[arch] = _np(_varied(LM(cfg).init(
                torch.Generator().manual_seed(3)), gen))
        r = np.random.RandomState(3)
        tok = r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab = r.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab[0, :5] = -1
        lab[3, -7:] = -1
        cases.append({"name": name, "arch": arch, "mesh": mesh,
                      "moments": moments, "cfg": _cfg_payload(cfg),
                      "params": drawn[arch], "tokens": tok, "labels": lab})
    return {"cases": cases, "moe": _moe_inputs(), "coll": _coll_inputs(),
            "int8": _int8_inputs()}


def _moe_inputs() -> dict:
    spec = MoESpec(n_experts=3, top_k=2, expert_d_ff=32, shared_d_ff=33,
                   capacity_factor=1.0)
    p = moe.init_moe(torch.Generator().manual_seed(9), 16, spec,
                     dtype=torch.float32)
    view = _View("2x2", {"data": 0, "model": 0})
    specs = tsh._with_paths(lambda path, leaf: tsh._param_rule(
        ("mlp",) + path, tuple(leaf.shape), SimpleNamespace(moe=spec), view),
        p)
    r = np.random.RandomState(9)
    return {"spec": dataclasses.asdict(spec), "params": _np(p),
            "specs": specs, "x": r.randn(4, 8, 16).astype(np.float32),
            "c": r.randn(4, 8, 16).astype(np.float32)}


def _coll_inputs() -> dict:
    r = np.random.RandomState(4)
    f = np.float32
    return {"x": r.randn(4, 6).astype(f), "w1": r.randn(6, 8).astype(f),
            "w2": r.randn(8, 5).astype(f), "w3": r.randn(6, 5).astype(f),
            "c": r.randn(4, 5).astype(f), "c1": r.randn(4, 8).astype(f),
            "c2": r.randn(4, 5).astype(f), "a": r.randn(2, 2, 3, 4).astype(f),
            "ca": r.randn(2, 2, 3, 4).astype(f)}


def _int8_inputs() -> dict:
    r = np.random.RandomState(8)
    m = (r.randn(2, 64, 128) * np.exp(r.randn(2, 64, 1))).astype(np.float32)
    m[0, 3, 60:70] = 0.0                    # a block with a zero stretch
    return {"m": m, "q_spec": (None, None, "model"),
            "scale_spec": (None, None, None)}


@pytest.fixture(scope="module")
def jax_procs(inputs, tmp_path_factory):
    """The reference's sharded `loss_fn` and train cells: two subprocesses
    on 4 forced host devices, started before the ranks."""
    d = tmp_path_factory.mktemp("jax_train_mesh")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    procs = []
    for i, names in enumerate(JAX_GROUPS):
        with open(d / f"in{i}.pkl", "wb") as f:
            pickle.dump([c for c in inputs["cases"] if c["name"] in names], f)
        # the output goes to a file: XLA's warnings could fill a pipe
        # while the ranks run
        with open(d / f"log{i}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", JAX_TRAIN, str(d / f"in{i}.pkl"),
                 str(d / f"out{i}.pkl")], env=env, stdout=log,
                stderr=subprocess.STDOUT, cwd=ROOT))
    yield procs, d
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


@pytest.fixture(scope="module")
def port(inputs, jax_procs, tmp_path_factory):
    """Rank r's results of every job of the world of 4."""
    res = ranks.run(4, tmp_path_factory.mktemp("train_mesh4"),
                    "train_mesh_world",
                    {"train_mesh": {"cases": inputs["cases"]},
                     "moe_grads": inputs["moe"],
                     "int8_moments": inputs["int8"]})
    return res


@pytest.fixture(scope="module")
def jax_ref(jax_procs, port):
    procs, d = jax_procs
    out = {}
    for i, p in enumerate(procs):
        p.wait(timeout=900)
        log = (d / f"log{i}.txt").read_text()
        assert "JAX_TRAIN_MESH_OK" in log, log[-3000:]
        with open(d / f"out{i}.pkl", "rb") as f:
            out.update(pickle.load(f))
    return out


def _outs(port, name):
    outs = [r["train_mesh"][name] for r in port
            if name in r["train_mesh"]]
    r, c = (int(v) for v in next(
        m for n, _, m, _ in CASES if n == name).split("x"))
    assert len(outs) == r * c
    return outs


def _grad_gaps(got, want) -> dict:
    """{path: max |Δ| / max |want|} of two gradient trees."""
    w = dict(leaves_with_paths(want))
    return {path: float(np.abs(g - w[path]).max())
            / max(float(np.abs(w[path]).max()), 1e-30)
            for path, g in leaves_with_paths(got)}


# ---------------------------------------------------------------------------
# loss_fn under the mesh, its gradients, the train cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_metrics_match_reference(name, port, jax_ref):
    ref = jax_ref[name]
    atol = LOSS_ATOL_ARCH.get(name.split()[0], LOSS_ATOL)
    for o in _outs(port, name):
        assert o["loss"] == pytest.approx(ref["loss"], abs=atol)
        for k in ("loss", "aux"):
            assert o["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                    abs=atol), k
        assert o["metrics"]["ntok"] == ref["metrics"]["ntok"] == B * S - 12


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_reference(name, port, jax_ref):
    """Every leaf's gradient, completed and gathered whole, on every rank
    alike and within GRAD_REL of the reference's `jax.grad`."""
    arch = next(a for n, a, _, _ in CASES if n == name)
    rel = GRAD_REL.get(arch, 1e-4)
    outs = _outs(port, name)
    ref = jax_ref[name]["grads"]
    for o in outs:
        assert {p for p, _ in leaves_with_paths(o["grads"])} == {
            p for p, _ in leaves_with_paths(ref)}
        gaps = _grad_gaps(o["grads"], ref)
        bad = {p: g for p, g in gaps.items() if g > rel}
        assert not bad, (name, o["coords"], bad)
        for (_, a), (_, b) in zip(leaves_with_paths(o["grads"]),
                                  leaves_with_paths(outs[0]["grads"])):
            np.testing.assert_array_equal(a, b)


def test_grad_check_fails_a_doubled_replicated_leaf(port, jax_ref):
    """The control: one replicated leaf's gradient doubled (what a sum
    over 'model' of a replicated leaf's whole gradients gives at
    'model' = 2) misses the bound by far."""
    name = NAMES[0]
    got = _outs(port, name)[0]["grads"]
    got = dict(got, final_norm={"scale": 2 * got["final_norm"]["scale"]})
    gaps = _grad_gaps(got, jax_ref[name]["grads"])
    assert gaps[("final_norm", "scale")] > 0.5


def _dequantize(qs: dict) -> np.ndarray:
    """`quant.dequantize` in numpy: q · its block's scale."""
    q = qs["q"]
    scale = np.repeat(qs["scale"], jquant.BLOCK, axis=-1)[..., :q.shape[-1]]
    return q.astype(np.float32) * scale


def _pre_moments(jref: dict, i: int) -> dict:
    """The reference's moments of step i + 1 before their int8 encoding,
    whole: AdamW's m and v (its defaults) from the step's gradients
    (recorded by the reference's subprocess at the step's parameters)
    and the decoded moments before the step."""
    cfg = adamw.AdamWConfig()
    g = jref["step_grads"][i]
    gnorm = np.sqrt(sum(np.sum(np.square(x.astype(np.float32)))
                        for _, x in leaves_with_paths(g)))
    clip = min(1.0, cfg.grad_clip / max(gnorm, 1e-12))
    prev = jref["steps"][i - 1]["state"]["opt"] if i else None
    out = {"m": {}, "v": {}}
    for path, x in leaves_with_paths(g):
        gc = x.astype(np.float32) * np.float32(clip)
        m0 = _dequantize(_at(prev["m"], path)) if prev else 0.0
        v0 = _dequantize(_at(prev["v"], path)) if prev else 0.0
        out["m"][path] = cfg.b1 * m0 + (1 - cfg.b1) * gc
        out["v"][path] = cfg.b2 * v0 + (1 - cfg.b2) * np.square(gc)
    return out


def _state_gaps(o, want, old, specs, mesh, pre=None, before=None) -> dict:
    """{(part, path): gap} of a rank's state blocks: each parameter
    leaf's update against the reference's (relative L2), each moment's
    (dequantized where int8) against the reference's (relative L2).
    An int8 moment's q elements that differ from the reference's: the
    largest difference ("q step"), their share of the block ("q
    flips") and, with `pre` (`_pre_moments`), how far from a rounding
    boundary (a half step) the reference's unrounded m / scale lies at
    each of them, the largest in steps ("q edge").  With `before`
    (the rank's and the reference's states before the step), an
    element whose q already differed then is carried, not new: its
    moment started a step apart, so it is left out of "q edge"."""
    view = _View(mesh, o["coords"])
    out = {}
    st = o["state"]
    miss = norm = 0.0
    for path, p in leaves_with_paths(st["params"]):
        sp = _at(specs["params"], path)
        w, p0 = _block(_at(want["params"], path), sp, view), _block(
            _at(old, path), sp, view)
        d, n = np.linalg.norm(p - w), np.linalg.norm(w - p0)
        out[("update", path)] = float(d / max(n, 1e-30))
        miss, norm = miss + d ** 2, norm + n ** 2
        for k in ("m", "v"):
            got, ref = _at(st["opt"][k], path), _at(want["opt"][k], path)
            msp = _at(specs["opt"][k], path)
            if isinstance(got, dict):       # int8: {'q', 'scale'}
                dq = np.abs(got["q"].astype(np.int32) - _block(
                    ref["q"], msp["q"], view).astype(np.int32))
                out[(k + " q step", path)] = float(dq.max())
                out[(k + " q flips", path)] = float((dq > 0).mean())
                if pre is not None:
                    t = np.abs(_block(pre[k][path] / np.repeat(
                        ref["scale"], jquant.BLOCK, axis=-1)[
                            ..., :ref["q"].shape[-1]], msp["q"], view))
                    edge = np.abs(t - np.floor(t) - 0.5)
                    new = dq > 0
                    if before is not None:
                        new &= _at(before[0]["opt"][k], path)["q"] == _block(
                            _at(before[1]["opt"][k], path)["q"], msp["q"],
                            view)
                    out[(k + " q edge", path)] = float(
                        edge[new].max()) if new.any() else 0.0
                got, ref = got["scale"], _block(ref["scale"], msp["scale"],
                                                view)
                k += " scale"
            else:
                ref = _block(ref, msp, view)
            out[(k, path)] = float(np.linalg.norm(got - ref) / max(
                np.linalg.norm(ref), 1e-30))
    out[("update", "all")] = float(np.sqrt(miss / max(norm, 1e-30)))
    return out


def _state_bad(gaps: dict, arch: str, moments: str) -> dict:
    """The gaps of `_state_gaps` past their bounds: an int8 moment's q
    elements may differ from the reference's by one step, on at most
    Q_FLIPS of a block, each where the reference's unrounded value lies
    within Q_EDGE of a rounding boundary; its scales and the other
    moments within twice the arch's gradient bound."""
    moment = 2 * GRAD_REL.get(arch, MOMENT_REL / 2)
    update = UPDATE_REL["jamba" if arch == HYB else "int8"
                        if moments == "int8" else "fp32"]
    q_bounds = {" q step": 1, " q flips": Q_FLIPS, " q edge": Q_EDGE}

    def bound(k):
        if k[0] == "update":
            return update if k[1] == "all" else LEAF_UPDATE_REL
        return next((b for end, b in q_bounds.items()
                     if k[0].endswith(end)), moment)
    return {k: g for k, g in gaps.items() if g > bound(k)}


@pytest.mark.parametrize("name", NAMES)
def test_train_cell_state_matches_reference(name, port, jax_ref, inputs):
    """One and two steps of the train cell: each rank's blocks of the
    parameters and moments against the reference cell's, the metrics
    (the last microbatch's) and the step count; the cell's local shapes
    are the state's and the batch's.  jamba's second step: see
    `test_jamba_second_step_matches_one_device`."""
    case = next(c for c in inputs["cases"] if c["name"] == name)
    ref = jax_ref[name]["steps"]
    steps_held = 1 if case["arch"] == HYB else 2
    for o in _outs(port, name):
        assert o["shapes"], "build_cell's local shapes"
        old = case["params"]
        for i in range(2):
            got = o["steps"][i]
            assert int(got["state"]["step"]) == i + 1
            assert got["metrics"]["step"] == i + 1
            assert got["metrics"]["ntok"] == ref[i]["metrics"]["ntok"]
            if i >= steps_held:
                continue
            assert got["metrics"]["loss"] == pytest.approx(
                ref[i]["metrics"]["loss"],
                abs=LOSS_ATOL_ARCH.get(case["arch"], LOSS_ATOL))
            pre = (_pre_moments(jax_ref[name], i)
                   if case["moments"] == "int8" else None)
            before = (o["steps"][i - 1]["state"], ref[i - 1]["state"]) \
                if i else None
            gaps = _state_gaps(dict(got, coords=o["coords"]),
                               ref[i]["state"], old, o["specs"],
                               case["mesh"], pre, before)
            bad = _state_bad(gaps, case["arch"], case["moments"])
            assert not bad, (name, i, o["coords"], bad)
            old = ref[i]["state"]["params"]


def test_jamba_second_step_matches_one_device(port, inputs, tmp_path):
    """jamba's second step on the mesh against the reference's one-device
    train step (`make_train_step`, the cell's 4 one-row microbatches,
    fp32 moments) from the mesh's own state after the first step,
    gathered whole (a JAX subprocess)."""
    name = f"{HYB} 2x2"
    case = next(c for c in inputs["cases"] if c["name"] == name)
    outs = _outs(port, name)
    whole = outs[0]["whole_after_1"]
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump({"arch": HYB, "accum": 4, "state": whole, "step": 1,
                     "tokens": case["tokens"], "labels": case["labels"]}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_ONE_STEP, str(tmp_path / "in.pkl"),
         str(tmp_path / "out.pkl")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert "JAX_ONE_STEP_OK" in proc.stdout, proc.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    want = ref["state"]
    for o in outs:
        got = o["steps"][1]
        assert got["metrics"]["ntok"] == ref["metrics"]["ntok"]
        assert got["metrics"]["loss"] == pytest.approx(
            ref["metrics"]["loss"], abs=LOSS_ATOL_ARCH[HYB])
        gaps = _state_gaps(dict(got, coords=o["coords"]), want,
                           whole["params"], o["specs"], case["mesh"])
        bad = _state_bad(gaps, HYB, "float32")
        assert not bad, (o["coords"], bad)


def test_int8_moment_blocks_are_the_references_bitwise(port, inputs):
    """A moment leaf whose 128-wide rows split over 'model' = 2: each
    rank's q block and the whole row's scales equal the blocks of the
    reference's `quant.quantize` of the whole rows, and each rank's
    decoded block its block of the reference's `dequantize`."""
    inp = inputs["int8"]
    want = jquant.quantize(jnp.asarray(inp["m"]))
    back = np.asarray(jquant.dequantize(want))
    outs = [r["int8_moments"] for r in port if r["int8_moments"]]
    assert len(outs) == 2
    for o in outs:
        view = _View("1x2", o["coords"])
        np.testing.assert_array_equal(
            o["q"], _block(np.asarray(want["q"]), inp["q_spec"], view))
        np.testing.assert_array_equal(o["scale"], np.asarray(want["scale"]))
        np.testing.assert_array_equal(
            o["decoded"], _block(back, inp["q_spec"], view))
    assert outs[0]["q"].shape[-1] == 64


def test_moe_gspmd_path_grads_match_one_device(port, inputs):
    """apply_moe's GSPMD path at 2x2 (rows gathered over 'data', experts
    split on d_ff over 'model', a whole shared expert added by the rank
    at index 0): sum(y * c) + aux and its gradients with respect to x
    and every parameter, against the one-device function on the whole
    batch (the path's semantics: the global capacity)."""
    inp = inputs["moe"]
    spec = MoESpec(**inp["spec"])
    p = tree_map(lambda a: torch.from_numpy(a).requires_grad_(),
                 inp["params"])
    x = torch.from_numpy(inp["x"]).requires_grad_()
    y, aux = moe.apply_moe(p, x, spec, "silu")
    val = (y * torch.from_numpy(inp["c"])).sum() + aux
    leaves = [t for _, t in leaves_with_paths(p)]
    gs = torch.autograd.grad(val, [x] + leaves)
    want = dict(zip([path for path, _ in leaves_with_paths(p)], gs[1:]))
    for r in port:
        o = r["moe_grads"]
        assert o["value"] == pytest.approx(float(val.detach()), abs=1e-5)
        np.testing.assert_allclose(o["x"], gs[0].numpy(), rtol=0, atol=1e-5)
        for path, g in leaves_with_paths(o["grads"]):
            np.testing.assert_allclose(g, want[path].numpy(), rtol=0,
                                       atol=1e-5, err_msg=str(path))


# ---------------------------------------------------------------------------
# the differentiable collectives, on a world of 2
# ---------------------------------------------------------------------------
LAUNCH_ARGS = ["--arch", H2O, "--tiny", "--steps", "3", "--batch", "4",
               "--seq", "32", "--log-every", "1", "--device", "cpu"]


# the launcher with a checkpoint: 4 steps, saved at 2 and 4
CKPT_BASE = ["--arch", H2O, "--tiny", "--batch", "4", "--seq", "32",
             "--log-every", "1", "--device", "cpu"]
CKPT_ARGS = CKPT_BASE + ["--steps", "4", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def launch_ckpt(tmp_path_factory):
    return tmp_path_factory.mktemp("launch_ckpt") / "ckpt"


@pytest.fixture(scope="module")
def world2(inputs, launch_ckpt, tmp_path_factory):
    """Rank r's results of every job of the world of 2."""
    return ranks.run(2, tmp_path_factory.mktemp("world2"), "mesh2_world",
                     {"coll": inputs["coll"],
                      "launcher": {"args": LAUNCH_ARGS},
                      "launcher_ckpt": {"args": CKPT_ARGS + [
                          "--ckpt", str(launch_ckpt)]}})


@pytest.fixture(scope="module")
def coll(world2):
    return [r["coll"] for r in world2]


def _whole_cases(t, me):
    """(value, [gradients]) of each collective case of
    `_torch_mesh_ranks.collective_grads`, computed whole in one process
    with plain autograd, as rank `me` holds them."""
    def grads(fn, *xs):
        xs = [torch.from_numpy(a).requires_grad_() for a in xs]
        v = fn(*xs)
        return float(v), [g.numpy() for g in torch.autograd.grad(v, xs)]

    def blk(a, dim):
        n = a.shape[dim] // 2
        return np.take(a, range(me * n, (me + 1) * n), axis=dim)
    T = {k: torch.from_numpy(v) for k, v in t.items()}
    out = {}
    v, (gx, g1, g2) = grads(lambda x, w1, w2: (
        torch.relu(x @ w1) @ w2 * T["c"]).sum(), t["x"], t["w1"], t["w2"])
    out["mlp"] = (v, [gx, blk(g1, 1), blk(g2, 0)])
    v, (gx, g1) = grads(lambda x, w: (x @ w * T["c1"]).sum(), t["x"],
                        t["w1"])
    out["linear_col"] = (v, [gx, blk(g1, 1)])
    out["gather_sum"] = (v, [blk(gx, 0), blk(g1, 0)])
    out["gather_from"] = (v, [gx, blk(g1, 0)])
    v, (gx, g3) = grads(lambda x, w: (x @ w * T["c2"]).sum(), t["x"],
                        t["w3"])
    out["split_to"] = (v, [gx, blk(g3, 0)])
    a, ca = t["a"], t["ca"]
    out["all_to_all"] = (float(sum((a[i][me] * ca[me][i]).sum()
                                   for i in range(2))),
                         [np.stack([ca[j][me] for j in range(2)])])
    return out


@pytest.mark.parametrize("case", ["mlp", "linear_col", "split_to",
                                  "all_to_all", "gather_sum",
                                  "gather_from"])
def test_collective_backward_matches_whole_computation(case, coll, inputs):
    """reduce_from and copy_to (Megatron's g and f), gather_from (the
    column-parallel linear; a weight every rank uses alike), split_to,
    all_to_all and gather_sum (an FSDP weight): each rank's value and
    gradients against the whole computation's, as the rank holds them."""
    for o in coll:
        v, gs = _whole_cases(inputs["coll"], o["rank"])[case]
        assert o[case]["value"] == pytest.approx(v, abs=1e-5)
        assert len(o[case]["grads"]) == len(gs)
        for got, want in zip(o[case]["grads"], gs):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_serving_collectives_refuse_tensors_that_require_grad(coll):
    for o in coll:
        for op, err in o["errors"].items():
            assert err is not None and "requires grad" in err, op
            assert "differentiable collectives" in err, op
        np.testing.assert_array_equal(o["no_grad_sum"], np.full(3, 2.0))


# ---------------------------------------------------------------------------
# LM.loss_fn's refusals and the launcher
# ---------------------------------------------------------------------------
def test_loss_fn_under_a_mesh_takes_the_layout_and_no_positions():
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as meshlib
    cfg = _cfg(H2O)
    mesh = meshlib.make_mesh((1, 1), ("data", "model"))
    lm = steps.build_lm(cfg, mesh, KernelPolicy("ref"))
    params = lm.init(torch.Generator().manual_seed(0))
    tok = torch.zeros((2, 16), dtype=torch.int32)
    batch = {"tokens": tok, "labels": tok}
    with pytest.raises(ValueError, match="layout"):
        lm.loss_fn(params, batch)
    layout = lm.layout(ShapeSpec("t", 16, 2, "train"), int8=False)
    with pytest.raises(NotImplementedError, match="positions"):
        lm.loss_fn(params, dict(batch, positions=tok), layout=layout)
    # a 1x1 mesh: the one-device loss
    one = LM(cfg, KernelPolicy("ref"))
    with torch.no_grad():
        a, _ = lm.loss_fn(params, batch, layout=layout)
        b, _ = one.loss_fn(params, batch)
    assert float(a) == pytest.approx(float(b), abs=1e-6)


def test_launcher_refuses_checkpoints_under_a_mesh(world2, launch_ckpt,
                                                   monkeypatch):
    """The launcher once refused `--ckpt` under a mesh of more than one
    rank; now the flags run.  In the world of 2 at --model-parallel 2,
    4 steps in fp32 with `--ckpt D --ckpt-every 2`: both ranks return
    the same losses, each within 1e-5 relative of the one-device
    launcher's, and D holds steps 2 and 4 with every leaf whole (the
    global shapes)."""
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), dtype="float32"))
    got = [r["launcher_ckpt"] for r in world2]
    assert got[0] == got[1] and len(got[0]) == 4
    np.testing.assert_allclose(got[0], train.main(CKPT_ARGS), rtol=1e-5)
    assert Checkpointer(launch_ckpt).all_steps() == [2, 4]
    manifest = json.loads((launch_ckpt / "step_000000004" / "manifest.json")
                          .read_text())["leaves"]
    for path, leaf in leaves_with_paths(LM(_cfg(H2O)).param_shapes()):
        assert manifest["params/" + "/".join(path)]["shape"] == list(
            leaf.shape), path


def test_launcher_mesh_checkpoint_resumes_on_one_device(world2, launch_ckpt,
                                                        monkeypatch):
    """An elastic restart from a mesh to one device: the one-device
    launcher `--resume`s the world of 2's step-4 checkpoint for 2 steps,
    whose losses are within 1e-5 relative of a straight one-device 6-step
    run's last two."""
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), dtype="float32"))
    assert world2[0]["launcher_ckpt"]
    resumed = train.main(CKPT_BASE + ["--steps", "2", "--ckpt",
                                      str(launch_ckpt), "--resume"])
    straight = train.main(CKPT_BASE + ["--steps", "6"])
    assert len(resumed) == 2 and len(straight) == 6
    np.testing.assert_allclose(resumed, straight[4:], rtol=1e-5)


def test_launcher_mesh_matches_one_device_in_fp32(world2, monkeypatch):
    """`launch.train.main --mesh local --model-parallel 2` in a world of 2
    ranks on the tiny config in fp32: every rank returns the same
    losses, each of the 3 steps within 1e-5 relative of the one-device
    launcher's on the same config."""
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_config", lambda arch: dataclasses.replace(
        get_config(arch), dtype="float32"))
    want = train.main(LAUNCH_ARGS)
    got = [r["launcher"] for r in world2]
    assert got[0] == got[1]
    assert len(got[0]) == 3
    np.testing.assert_allclose(got[0], want, rtol=1e-5)


def test_launcher_mesh_under_torchrun_matches_one_device():
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    repro_torch.launch.train ... --mesh local --model-parallel 2`: rank
    0 alone logs each step's loss; the first equals the one-device
    launcher's, the next two within bf16's reach (module docstring)."""
    from repro_torch.launch import train
    args = LAUNCH_ARGS
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + args
        + ["--mesh", "local", "--model-parallel", "2"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    got = [float(v) for v in re.findall(r"^step \d+ loss ([\d.]+)",
                                        proc.stdout, re.M)]
    assert len(got) == 3, proc.stdout
    assert proc.stdout.count("done:") == 1        # rank 0 alone logs
    want = train.main(args)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=5e-4)

