"""Elastic restart and the sharded checkpoint of the port
(`repro_torch.runtime.elastic`, `repro_torch.ckpt.checkpoint` under a
mesh, `launch/train.py --ckpt` under torchrun) against the JAX package's,
on the CPU.

The ranks are spawned processes (`_torch_mesh_ranks.elastic_world`): one
world of 4 runs every scenario, two meshes of 2 side by side on ranks
(0, 1) and (2, 3) where one is enough.  The reference runs in this
process where no mesh is needed: its `Checkpointer` saves and restores
the logical leaves.  The configuration is the tiny h2o-danube-1.8b in
fp32, AdamW at lr 3e-4 (the reference test's), SyntheticLM batches of
(8, 32).

What is held, and the tolerances:
  * `plan_remesh` and `RemeshPlan` equal the reference's, field for
    field, on a grid that holds the reference test's (8, 2, 16) and
    (12, 2, 8); `build_mesh` refuses a world of the wrong size;
  * `replace_state` on one device (and on a 1x1 mesh), fp32 and int8
    moments: every leaf bitwise the saved one, on the template's device
    and in its dtype (the port of `test_replace_state_replaces_params_
    and_moments`);
  * a state saved by a port mesh (1x2 and 2x1, fp32 and int8 moments,
    after one step) restores in the reference's `Checkpointer` into a
    template of the reference's `LM.init` + `adamw.init`, every leaf
    bitwise the port's state gathered whole; a state the reference
    saves restores onto the port's 1x2, 2x1 and 2x2 meshes as bitwise
    `local_block`s, in the template's dtypes;
  * the elastic resume (the port of `test_elastic_resume_subprocess`):
    4 steps on a world of 4 (2x2), saved, resumed through
    `replace_state` on a world of 2 (1x2) for 2 steps, against a
    straight 6 steps on 1x2: max parameter delta <= 1e-5 and final loss
    delta < 1e-4, the reference's bounds.  The control (step 2's
    checkpoint resumed as step 4) must miss the parameter bound;
  * `run_resilient`'s restore escalation under a 1x2 mesh, every rank
    raising TransientError twice at step 3: one restore (of step 2) on
    every rank, and a final state bitwise that of the uninterrupted run;
  * `launch.train --ckpt` under torchrun on 2 ranks: rank 0 alone logs,
    and the checkpoint holds the whole leaves (the global shapes).
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.ckpt.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.treeutil import leaves_with_paths  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O = "h2o-danube-1.8b"
B, S = 8, 32
PARAM_BOUND, LOSS_BOUND = 1e-5, 1e-4        # the reference test's
MOMENTS = ("float32", "int8")


def _cfg():
    return dataclasses.replace(get_config(H2O).tiny(), dtype="float32")


def _jcfg():
    return dataclasses.replace(jget_config(H2O).tiny(), dtype="float32")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(got, want, what):
    """Bitwise equal trees of arrays: the same paths, dtypes and bits."""
    g, w = dict(leaves_with_paths(got)), dict(leaves_with_paths(want))
    assert sorted(g) == sorted(w), what
    for path in g:
        a, b = _bits(g[path]), _bits(w[path])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")


class _View:
    """A rank's coordinates as `sharding.local_block` reads a mesh."""

    def __init__(self, coords, shape):
        self.axis_names = tuple(coords)
        self.shape = shape
        self.coords = coords

    def axis(self, entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        size, index = 1, 0
        for n in names:
            size, index = (size * self.shape[n],
                           index * self.shape[n] + self.coords[n])
        return SimpleNamespace(size=size, index=index)


def _gap(a, b) -> float:
    w = dict(leaves_with_paths(b))
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(w[p], np.float64)).max())
               for p, x in leaves_with_paths(a))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,mp,gb", [(8, 2, 16), (12, 2, 8), (4, 2, 8),
                                     (2, 2, 8), (6, 1, 4), (16, 4, 12),
                                     (9, 3, 5), (1, 1, 1)])
def test_plan_remesh_matches_reference(n, mp, gb):
    got = elastic.plan_remesh(n, model_parallel=mp, global_batch=gb)
    want = jelastic.plan_remesh(n, model_parallel=mp, global_batch=gb)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_devices == want.n_devices
    assert got.axis_names() == want.axis_names()
    assert got.shape() == want.shape()
    assert gb % got.data == 0


def test_remesh_plan_with_pods_matches_reference():
    got, want = elastic.RemeshPlan(2, 4, pod=2), jelastic.RemeshPlan(2, 4,
                                                                     pod=2)
    assert (got.n_devices, got.axis_names(), got.shape()) == (
        want.n_devices, want.axis_names(), want.shape())
    with pytest.raises(AssertionError):
        elastic.plan_remesh(6, model_parallel=4, global_batch=8)


def test_build_mesh_refuses_a_world_of_the_wrong_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="world of 2 ranks"):
        elastic.build_mesh(elastic.RemeshPlan(data=2, model=1))
    mesh = elastic.build_mesh(elastic.RemeshPlan(data=1, model=1))
    assert mesh.shape == {"data": 1, "model": 1}
    assert elastic.mesh_invariant_rng() is None


def test_checkpointer_under_a_mesh_needs_the_spec_tree(tmp_path):
    mesh = meshlib.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="spec tree"):
        Checkpointer(tmp_path, mesh=mesh)
    with pytest.raises(ValueError, match="spec tree"):
        Checkpointer(tmp_path).restore({}, mesh=mesh)


# ---------------------------------------------------------------------------
# replace_state on one device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_kind", ["none", "1x1"])
@pytest.mark.parametrize("moments", MOMENTS)
def test_replace_state_round_trip_one_device(moments, mesh_kind, tmp_path):
    """Parameters and both moment trees come back bitwise, on the
    template's device and in its dtypes, from a template of other
    values (the port of the reference's
    `test_replace_state_replaces_params_and_moments`)."""
    cfg = _cfg()
    mesh = (None if mesh_kind == "none"
            else meshlib.make_mesh((1, 1), ("data", "model")))
    ocfg = adamw.AdamWConfig(lr=1e-3, moment_dtype=moments)
    lm = LM(cfg)

    def state(seed):
        p = lm.init(torch.Generator().manual_seed(seed))
        # one update with the parameters as gradients: moments not zero
        p2, opt = adamw.update(p, adamw.init(p, ocfg), p, ocfg)
        return {"params": p2, "opt": opt,
                "step": torch.tensor(3, dtype=torch.int32)}
    saved, tmpl = state(0), state(1)
    ck = Checkpointer(tmp_path)
    ck.save(3, saved)
    got = elastic.replace_state(cfg, ck, tmpl, mesh, step=3)
    np_ = {k: v for k, v in leaves_with_paths(got)}
    for path, t in leaves_with_paths(tmpl):
        assert np_[path].dtype == t.dtype and np_[path].device == t.device
    _same({k: v.numpy() for k, v in np_.items()},
          {k: v.numpy() for k, v in leaves_with_paths(saved)}, moments)
    assert any(v.dtype == torch.int8 for v in np_.values()) == (
        moments == "int8")


# ---------------------------------------------------------------------------
# the world of 4
# ---------------------------------------------------------------------------
def _ref_state(moments):
    """The reference's tiny fp32 state after one AdamW update of made-up
    gradients (moments not zero), at step 5."""
    params = JLM(_jcfg()).init(jax.random.PRNGKey(7))
    oc = jadamw.AdamWConfig(moment_dtype=moments)
    g = jax.tree.map(lambda p: jnp.sin(p * 3.0 + 1.0), params)
    p2, opt = jadamw.update(g, jadamw.init(params, oc), params, oc)
    return {"params": p2, "opt": opt, "step": jnp.int32(5)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(the ranks' results in rank order, the reference's saved states)."""
    d = tmp_path_factory.mktemp("elastic_world")
    saved, dirs = {}, {}
    for m in MOMENTS:
        saved[m] = jax.tree.map(np.asarray, _ref_state(m))
        dirs[m] = str(d / f"from_ref_{m}")
        JCheckpointer(dirs[m]).save(5, saved[m])
    cfg = _cfg()
    payload = {"cfg": {**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)},
                       "moe": None, "ssm": None},
               "batch": B, "seq": S, "dir": str(d), "from_ref": dirs}
    return ranks.run(4, d, "elastic_world", payload), saved


def test_elastic_resume_matches_straight_run(world):
    """4 steps on 2x2, resumed on 1x2 for 2 more, against 6 straight
    steps on 1x2 (the data stream re-partitions exactly)."""
    outs, _ = world
    p1 = outs[0]["phase 1"]
    assert p1["plan"] == elastic.RemeshPlan(data=2, model=2)
    assert [o["phase 1"]["coords"] for o in outs] == [
        {"data": d, "model": m} for d in range(2) for m in range(2)]
    resumed, straight = outs[0]["resumed"], outs[2]["straight"]
    assert resumed["plan"] == elastic.RemeshPlan(data=1, model=2)
    d = _gap(resumed["params"], straight["params"])
    assert d <= PARAM_BOUND, d
    assert abs(resumed["loss"] - straight["loss"]) < LOSS_BOUND
    assert np.isfinite(resumed["loss"])


def test_elastic_resume_control_misses(world):
    """Step 2's checkpoint resumed as step 4: the check must fail it."""
    outs, _ = world
    d = _gap(outs[0]["control"]["params"], outs[2]["straight"]["params"])
    assert d > 10 * PARAM_BOUND, d


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_port_mesh_checkpoint_restores_in_reference(world, mesh, moments):
    """A port mesh's save holds the whole leaves: the reference's
    `Checkpointer.restore` into its own `LM.init` + `adamw.init`
    template gives the port's state gathered whole, bitwise."""
    outs, _ = world
    res = outs[0 if mesh == "1x2" else 2][f"to ref {mesh} {moments}"]
    params = JLM(_jcfg()).init(jax.random.PRNGKey(0))
    tmpl = {"params": params,
            "opt": jadamw.init(params, jadamw.AdamWConfig(
                moment_dtype=moments)),
            "step": jnp.zeros((), jnp.int32)}
    got = JCheckpointer(res["dir"]).restore(tmpl, step=1)
    _same(jax.tree.map(np.asarray, got), res["whole"], f"{mesh} {moments}")
    assert int(got["step"]) == 1
    manifest = json.loads((pathlib.Path(res["dir"]) / "step_000000001"
                           / "manifest.json").read_text())
    shapes = {k: tuple(v["shape"]) for k, v in manifest["leaves"].items()}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tmpl)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        assert shapes[key] == tuple(leaf.shape), key


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("mesh", ["1x2", "2x1", "2x2"])
def test_reference_checkpoint_restores_onto_port_mesh(world, mesh, moments):
    """The reference's save restored onto a port mesh: each rank's blocks
    are `local_block` of the reference's leaves, bitwise, in the
    template's dtypes (int8 q and scale each by its own spec)."""
    outs, saved = world
    want = dict(leaves_with_paths(saved[moments]))
    got = [o[f"from ref {mesh} {moments}"] for o in outs
           if f"from ref {mesh} {moments}" in o]
    assert len(got) == (4 if mesh == "2x2" else 2)
    for res in got:
        assert res["shape"] == dict(zip(("data", "model"), map(
            int, mesh.split("x"))))
        view = _View(res["coords"], res["shape"])
        for path, blk in leaves_with_paths(res["blocks"]):
            spec = res["specs"]
            for k in path:
                spec = spec[k]
            whole = torch.from_numpy(np.array(_bits(want[path])))
            exp = tsh.local_block(whole, spec, view).numpy()
            np.testing.assert_array_equal(_bits(blk), exp, err_msg=str(path))
        assert all(v for _, v in leaves_with_paths(res["same_dtype"]))


def test_restore_escalation_under_a_mesh(world):
    """Every rank raises TransientError twice at step 3: run_resilient
    restores step 2 on every rank once, and the run ends where the
    uninterrupted one does, bitwise."""
    outs, _ = world
    for r in (0, 1):
        assert outs[r]["escalation"]["stats"] == {
            "retries": 2, "restores": 1, "stragglers": 0}
        assert outs[r]["escalation"]["steps"] == [2, 4]
    assert outs[2]["uninterrupted"]["stats"]["restores"] == 0
    _same(outs[0]["escalation"]["state"], outs[2]["uninterrupted"]["state"],
          "escalation")


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------
def test_launcher_checkpoint_under_torchrun(tmp_path):
    """`torchrun --nproc-per-node 2 -m repro_torch.launch.train ...
    --mesh local --model-parallel 2 --ckpt D`: rank 0 alone logs, and D
    holds the whole leaves at the global shapes, which the one-device
    launcher resumes."""
    from repro_torch.launch import train
    d = tmp_path / "ckpt"
    args = ["--arch", H2O, "--tiny", "--steps", "2", "--batch", "4",
            "--seq", "32", "--log-every", "1", "--ckpt", str(d),
            "--ckpt-every", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train"] + args
        + ["--mesh", "local", "--model-parallel", "2"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done:") == 1          # rank 0 alone logs
    assert proc.stdout.count("step 2 loss") == 1
    assert Checkpointer(d).all_steps() == [2]
    manifest = json.loads((d / "step_000000002" / "manifest.json")
                          .read_text())["leaves"]
    lm = LM(get_config(H2O).tiny())
    for path, leaf in leaves_with_paths(lm.param_shapes()):
        key = "params/" + "/".join(path)
        assert manifest[key]["shape"] == list(leaf.shape), key
        assert manifest[key]["dtype"] == str(leaf.dtype)[len("torch."):]
    got = train.main(args[:2] + ["--tiny", "--steps", "1", "--batch", "4",
                                 "--seq", "32", "--ckpt", str(d),
                                 "--resume", "--device", "cpu"])
    assert len(got) == 1 and np.isfinite(got[0])
