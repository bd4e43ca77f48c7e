"""The port's checkpointer and fault-tolerance loop
(`repro_torch.ckpt.checkpoint`, `repro_torch.runtime.fault`): the port's
counterparts of the checkpoint and fault tests of tests/test_substrate.py,
and checkpoints carried across the two packages in both directions.

The on-disk format is shared: a state written by `repro.ckpt.Checkpointer`
restores through the port's (bf16 leaves included, bit for bit through
their uint16 bits), and a state the port writes restores through the
reference's, with the same file names and manifest.
"""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.runtime import fault as jfault  # noqa: E402
from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: E402
from repro_torch.runtime import fault  # noqa: E402


def _state_np(seed=0):
    """A training-state-shaped tree of numpy arrays: fp32, bf16 (as
    ml_dtypes' bfloat16), int8 moments with fp32 scales, an int32 step."""
    r = np.random.RandomState(seed)
    bf16 = jnp.bfloat16
    return {
        "params": {"w": np.asarray(jnp.asarray(r.randn(3, 4), bf16)),
                   "layers": {"p0": {"scale": r.randn(5).astype(np.float32)}}},
        "opt": {"m": {"w": {"q": r.randint(-127, 128, (3, 4)).astype(np.int8),
                            "scale": r.rand(3, 1).astype(np.float32)}},
                "count": np.int32(7)},
        "step": np.int32(7)}


def _to_torch(tree):
    from repro_torch.core.treeutil import params_from_numpy
    return params_from_numpy(tree)


def _bits(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(t, j):
    """Equal trees, leaf by leaf: the same paths, dtypes and bits."""
    assert [p for p, _ in _items(t)] == [p for p, _ in _items(j)]
    for (path, a), (_, b) in zip(_items(t), _items(j)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=path)
        assert _bits(a).dtype == _bits(b).dtype, path


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _items(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    state = _to_torch(_state_np())
    ck.save(7, state)
    ck.save(9, state)
    assert ck.latest_step() == 9
    tmpl = jax.tree.map(torch.zeros_like, state)
    out = ck.restore(tmpl, step=7)
    _same(out, state)
    assert int(out["step"]) == 7
    assert out["params"]["w"].dtype == torch.bfloat16


def test_checkpoint_gc_and_async(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    st_ = {"w": torch.ones((4,))}
    for s in (1, 2, 3, 4):
        ck.save_async(s, st_)
    ck.wait()
    assert ck.all_steps() == [3, 4]


def test_save_async_snapshots_before_returning(tmp_path):
    """The host copy is taken before save_async returns: a later write
    into the state's tensors does not reach the checkpoint."""
    ck = Checkpointer(tmp_path)
    w = torch.ones((1000,))
    ck.save_async(1, {"w": w})
    w.fill_(5.0)
    ck.wait()
    assert torch.equal(ck.restore({"w": torch.zeros(1000)})["w"],
                       torch.ones(1000))


def test_checkpoint_atomic_no_partial(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones((4,))})
    # a stale tmp dir (crashed save) is ignored
    (pathlib.Path(tmp_path) / "step_000000002.tmp").mkdir()
    assert ck.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore({"w": torch.ones(4)})


def test_restore_places_leaves_on_the_template(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(3, {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)})
    out = ck.restore({"a": torch.zeros(2, 3, dtype=torch.float64),
                      "b": torch.zeros(2, dtype=torch.bfloat16)})
    assert out["a"].dtype == torch.float64 and out["b"].dtype == torch.bfloat16
    assert torch.equal(out["a"], torch.arange(6.0).reshape(2, 3).double())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _state_np(1)
    JCheckpointer(tmp_path).save(5, jax.tree.map(jnp.asarray, state))
    tmpl = jax.tree.map(torch.zeros_like, _to_torch(state))
    out = Checkpointer(tmp_path).restore(tmpl)
    _same(out, _to_torch(state))
    assert out["params"]["w"].dtype == torch.bfloat16
    assert out["opt"]["m"]["w"]["q"].dtype == torch.int8


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _state_np(2)
    Checkpointer(tmp_path).save(5, _to_torch(state))
    jck = JCheckpointer(tmp_path)
    out = jck.restore(jax.tree.map(lambda a: jnp.zeros_like(jnp.asarray(a)),
                                   state))
    _same(_to_torch(jax.tree.map(np.asarray, out)), _to_torch(state))
    # the same files and manifest as the reference writes
    JCheckpointer(tmp_path / "ref").save(5, jax.tree.map(jnp.asarray, state))
    mine = json.loads((tmp_path / "step_000000005" /
                       "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_000000005" /
                      "manifest.json").read_text())
    assert mine == ref


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------
def test_run_resilient_retry_and_restore(tmp_path):
    ck = Checkpointer(tmp_path)
    calls = {"n": 0, "fails": 0}

    def step_fn(state, step):
        calls["n"] += 1
        if step == 5 and calls["fails"] < 3:
            calls["fails"] += 1
            raise fault.TransientError("simulated node loss")
        return {"x": state["x"] + 1}, {"loss": 0.0}

    state, stats = fault.run_resilient(step_fn, {"x": torch.zeros(())}, 0,
                                       10, checkpointer=ck, ckpt_every=2,
                                       max_retries=2)
    assert stats["retries"] == 3
    assert stats["restores"] >= 1
    assert float(state["x"]) == 10.0 or float(state["x"]) >= 6.0


def test_run_resilient_matches_the_reference_schedule(tmp_path):
    """The same failure schedule gives the same stats, steps and final
    state in both packages (each with its own checkpointer).  A failing
    step first waits for the save in flight, so that which checkpoint a
    restore finds does not race the writer thread."""
    out = {}
    for name, (mod, ck, x0) in {
            "port": (fault, Checkpointer(tmp_path / "p"), torch.zeros(())),
            "jax": (jfault, JCheckpointer(tmp_path / "j"), jnp.zeros(()))
    }.items():
        seen, fails = [], {"n": 0}

        def step_fn(state, step, mod=mod, ck=ck, seen=seen, fails=fails):
            if step in (3, 7) and fails["n"] < 5:
                fails["n"] += 1
                ck.wait()
                raise mod.TransientError("node loss")
            seen.append(step)
            return {"x": state["x"] + 1}, {"loss": 0.0}
        state, stats = mod.run_resilient(step_fn, {"x": x0}, 0, 9,
                                         checkpointer=ck, ckpt_every=2,
                                         max_retries=2)
        out[name] = (float(state["x"]), stats, seen)
    assert out["port"] == out["jax"]


def test_watchdog_flags_stragglers():
    wd = fault.StepWatchdog(threshold=2.0)
    assert not wd.observe(1.0)
    assert not wd.observe(1.1)
    assert wd.observe(5.0)
    assert wd.stragglers == 1
    assert not wd.observe(1.0)      # baseline not poisoned by straggler


def test_heartbeat_writes_the_step(tmp_path):
    hb = fault.Heartbeat(str(tmp_path / "hb" / "beat"))
    hb.beat(12)
    assert (tmp_path / "hb" / "beat").read_text().split()[0] == "12"
