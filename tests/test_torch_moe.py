"""The port's MoE block (`repro_torch.models.moe`) vs the JAX package's
local path (`repro.models.moe.apply_moe` without a mesh) on the same
numpy inputs and the reference's own parameters, in fp32.

Routing is held in fp32: a one-ulp difference in a router probability
can flip a top-k choice, so the kept set is compared exactly (the
port's `dispatch` against the one the reference's own `lax.top_k` and
argsort give), and outputs at atol 1e-5 (two frameworks' products in
another summation order).  The aux value at rtol 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoESpec as JMoESpec  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoESpec  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

OUT_ATOL = 1e-5
D = 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _specs(**kw):
    base = dict(n_experts=4, top_k=2, expert_d_ff=48)
    base.update(kw)
    return JMoESpec(**base), MoESpec(**base)


def _params(jspec, seed=0, router=None):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, jspec, dtype=jnp.float32)
    if router is not None:
        jp = dict(jp, router={"w": jnp.asarray(router)})
    return jp, params_from_numpy(jp)


def _x(seed, B, S):
    return np.random.RandomState(seed).randn(B, S, D).astype(np.float32)


def _reference_keep(jp, x, jspec):
    """The kept candidates as the reference computes them: its fp32
    router, `lax.top_k`, stable argsort and capacity."""
    xt = jnp.asarray(x.reshape(-1, D))
    probs = jax.nn.softmax(xt @ jp["router"]["w"], axis=-1)
    _, top_e = jax.lax.top_k(probs, jspec.top_k)
    flat_e = np.asarray(top_e).reshape(-1)
    order = np.asarray(jnp.argsort(jnp.asarray(flat_e), stable=True))
    rank = np.argsort(order)
    counts = np.bincount(flat_e, minlength=jspec.n_experts)
    starts = np.cumsum(counts) - counts
    pos = rank - starts[flat_e]
    cap = jmoe.capacity(xt.shape[0], jspec)
    return flat_e, pos < cap, cap


def _run(jspec, tspec, jp, tp, x, act="silu"):
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jspec, act)
    ty, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tspec, act)
    np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    return ty, taux


def _port_keep(tp, x, tspec):
    xt = torch.from_numpy(x.reshape(-1, D))
    _, _, top_e = tmoe.route(xt @ tp["router"]["w"], tspec.top_k)
    flat_e = top_e.reshape(-1)
    C = tmoe.capacity(xt.shape[0], tspec)
    return flat_e.numpy(), tmoe.dispatch(flat_e, tspec.n_experts, C)[4].numpy()


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0])
def test_overflowing_experts_drop_the_same_candidates(cf):
    """capacity_factor < 1 at T = 40: C = max(8, int(40*2*cf/4)) slots,
    fewer than the busiest experts' candidates, so some are dropped; the
    kept set and the outputs equal the reference's."""
    jspec, tspec = _specs(capacity_factor=cf)
    jp, tp = _params(jspec, 1)
    x = _x(2, 2, 20)
    want_e, want_keep, cap = _reference_keep(jp, x, jspec)
    got_e, got_keep = _port_keep(tp, x, tspec)
    assert tmoe.capacity(40, tspec) == cap
    assert np.array_equal(got_e, want_e)
    assert np.array_equal(got_keep, want_keep)
    assert not want_keep.all()              # the case drops candidates
    _run(jspec, tspec, jp, tp, x)


def test_capacity_matches_the_reference():
    for cf in (0.5, 1.25, 8.0):
        jspec, tspec = _specs(capacity_factor=cf, n_experts=60, top_k=4)
        for T in (1, 4, 7, 64, 255, 256, 257, 2048, 4096, 8192, 24576):
            c = tmoe.capacity(T, tspec)
            assert c == jmoe.capacity(T, jspec), (cf, T)
            if T >= 256:
                assert c % 256 == 0 and c >= 256
            else:
                assert c >= 8


def test_at_256_tokens_and_more_capacity_rounds_to_256():
    """T = 320 (2 x 160): int(320*2*1.25/4) = 200 rounds up to C = 256."""
    jspec, tspec = _specs()
    assert tmoe.capacity(320, tspec) == 256
    jp, tp = _params(jspec, 3)
    _run(jspec, tspec, jp, tp, _x(4, 2, 160))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_shared_expert_matches_jax(act):
    jspec, tspec = _specs(shared_d_ff=40, n_shared=2, n_experts=6, top_k=3)
    jp, tp = _params(jspec, 5)
    assert set(tp) == {"router", "w_gate", "w_up", "w_down", "shared"}
    _run(jspec, tspec, jp, tp, _x(6, 3, 7), act)


def test_exact_router_ties_go_to_the_lowest_expert():
    """A router whose expert columns come in identical pairs (0 = 1,
    2 = 3) gives every token exact probability ties: top-2 takes the
    lower index of a tied pair, as `lax.top_k` does."""
    jspec, tspec = _specs()
    r = np.random.RandomState(7).randn(D, 2).astype(np.float32)
    router = np.repeat(r, 2, axis=1)                         # (D, 4)
    jp, tp = _params(jspec, 8, router=router)
    x = _x(9, 2, 12)
    want_e, want_keep, _ = _reference_keep(jp, x, jspec)
    got_e, got_keep = _port_keep(tp, x, tspec)
    assert np.array_equal(got_e, want_e)
    assert np.array_equal(got_keep, want_keep)
    xt = torch.from_numpy(x.reshape(-1, D))
    probs, top_p, top_e = tmoe.route(xt @ tp["router"]["w"], 2)
    assert torch.equal(probs[:, 0], probs[:, 1])
    # the two largest probabilities are one tied pair: 0 and 1, or 2 and 3
    assert set(map(tuple, top_e.tolist())) <= {(0, 1), (2, 3)}
    _run(jspec, tspec, jp, tp, x)


def test_aux_value_matches_jax():
    jspec, tspec = _specs(n_experts=8, top_k=2)
    jp, tp = _params(jspec, 10)
    x = _x(11, 4, 9)
    _, aux = _run(jspec, tspec, jp, tp, x)
    # the Switch loss: E * sum(mean prob * routed share); balanced = 1
    assert aux.dtype == torch.float32 and 0.5 < float(aux) < 4.0


def test_top1_matches_jax():
    """llama4-maverick's routing: top-1 with one shared expert."""
    jspec, tspec = _specs(n_experts=8, top_k=1, shared_d_ff=32, n_shared=1)
    jp, tp = _params(jspec, 12)
    _run(jspec, tspec, jp, tp, _x(13, 2, 10))


def test_bf16_matches_jax_where_no_choice_flips():
    """bf16 weights and activations: the outputs at the relative 2e-2 of
    the LM's bf16 tests, on inputs whose top-k choices are the same in
    both packages (checked here: a flipped choice is a routing
    difference, not a rounding)."""
    jspec, tspec = _specs(shared_d_ff=40)
    jp = jmoe.init_moe(jax.random.PRNGKey(14), D, jspec, dtype=jnp.bfloat16)
    tp = params_from_numpy(jp)
    x = _x(15, 2, 8).astype(jnp.bfloat16)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jspec, "silu")
    ty, taux = tmoe.apply_moe(tp, params_from_numpy(x), tspec, "silu")
    assert ty.dtype == torch.bfloat16
    xt = jnp.asarray(x).reshape(-1, D).astype(jnp.float32)
    _, jtop = jax.lax.top_k(jax.nn.softmax(xt @ jp["router"]["w"]), 2)
    _, _, ttop = tmoe.route(params_from_numpy(x).reshape(-1, D).float()
                            @ tp["router"]["w"], 2)
    assert np.array_equal(ttop.numpy(), np.asarray(jtop))
    a, b = _np(ty), _np(jy)
    assert np.abs(a - b).max() / np.abs(b).max() < 2e-2
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_init_moe_matches_reference_shapes():
    jspec, tspec = _specs(shared_d_ff=40)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                          jmoe.init_moe(jax.random.PRNGKey(0), D, jspec))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), D, tspec)

    def walk(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for k in j:
                walk(t[k], j[k])
        else:
            assert (tuple(t.shape), str(t.dtype).replace("torch.", "")) == j
    walk(tp, shapes)
    w = tp["w_down"].float()
    assert abs(float(w.std()) - 1 / np.sqrt(tspec.expert_d_ff)) < 0.01


def test_expert_parallel_is_not_ported():
    """Expert parallelism is ported now (`apply_moe_ep`, held to the
    reference's on gloo ranks in tests/test_torch_lm_mesh.py); what is
    left of this check: a `Sharder` over no mesh is the one-device
    function, as in the reference (no expert-parallel path without a
    mesh)."""
    from repro_torch.parallel.sharding import Sharder
    _, tspec = _specs()
    jspec, _ = _specs()
    _, tp = _params(jspec)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 8, D)
                         .astype(np.float32))
    y0, a0 = tmoe.apply_moe(tp, x, tspec, "silu")
    y1, a1 = tmoe.apply_moe(tp, x, tspec, "silu", sharder=Sharder(None))
    assert torch.equal(y0, y1) and torch.equal(a0, a1)


def test_spec_copies_agree():
    assert dataclasses.asdict(MoESpec(4, 2, 8)) == \
        dataclasses.asdict(JMoESpec(4, 2, 8))
