"""Plain versions of the LM kernels (flash attention, RMSNorm) vs the JAX
package's.

Inputs are made with numpy from a seed and fed to both packages.  The
JAX side runs `repro.kernels.ops` under KernelPolicy("ref") (the
pure-jnp oracle) and KernelPolicy("interpret") (the Pallas kernel in
interpret mode); the port side runs `repro_torch.kernels.ops` on CPU
tensors, which dispatch to the plain versions.  Sweeps mirror
tests/test_kernels.py, plus grouped-query cases the port takes natively
(K < H kv heads) and the reference takes pre-expanded.

Tolerances: fp32 atol/rtol 1e-5 (fp32 softmax over at most 256 keys,
sums in another order); bf16 2e-2, as tests/test_kernels.py holds the
Pallas kernel to its oracle (one bf16 ulp of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import layernorm as tln  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402

torch.set_num_threads(1)

JAX_MODES = ("ref", "interpret")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`
    (numpy fp32 -> bf16 rounds to nearest even in both)."""
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (64, 64, True, None), (64, 128, True, None), (32, 128, False, None),
    (128, 128, True, 48), (64, 256, True, 17),
])
def test_flash_attention_matches_jax(sq, skv, causal, window, dtype, mode):
    qj, qt = _pair(_np(1, 2, 3, sq, 32), dtype)
    kj, kt = _pair(_np(2, 2, 3, skv, 32), dtype)
    vj, vt = _pair(_np(3, 2, 3, skv, 32), dtype)
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=32, block_kv=32,
                                policy=JaxPolicy(mode))
    got = tops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kv,sq,skv,d,window", [
    (8, 2, 64, 64, 16, None), (32, 8, 48, 96, 80, 40), (4, 1, 40, 40, 16, 7),
])
def test_flash_attention_gqa_matches_expanded_reference(h, kv, sq, skv, d,
                                                        window, dtype):
    """k/v with K < H heads (head h reads kv head h // (H/K)) equal the
    reference on k/v expanded with jnp.repeat, D = 80 and ragged S
    included."""
    qj, qt = _pair(_np(4, 2, h, sq, d), dtype)
    kj, kt = _pair(_np(5, 2, kv, skv, d), dtype)
    vj, vt = _pair(_np(6, 2, kv, skv, d), dtype)
    want = jref.flash_attention(qj, jnp.repeat(kj, h // kv, axis=1),
                                jnp.repeat(vj, h // kv, axis=1),
                                causal=True, window=window)
    got = tops.flash_attention(qt, kt, vt, causal=True, window=window)
    _close(got, want, DTYPES[dtype][2])


def test_flash_attention_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(_np(s, 1, 4, 24, 16)) for s in (7, 8, 9))
    tops.reset_launch_counts()
    got = tfa.flash_attention(q, k[:, :2], v[:, :2], causal=True, window=5)
    want = tref.flash_attention(q, k[:, :2], v[:, :2], causal=True, window=5)
    assert torch.equal(got, want)
    assert tops.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.flash_attention(q, k, v, policy=KernelPolicy("kernel"))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(32, 64), (256, 80), (100, 257), (37, 80),
                                 (300, 129), (128, 96), (6, 2560)])
def test_rmsnorm_matches_jax(t, d, dtype, mode):
    xj, xt = _pair(_np(d, t, d), dtype)
    s = 1 + 0.1 * _np(1, d)
    want = jops.rmsnorm(xj, jnp.asarray(s), policy=JaxPolicy(mode))
    got = tops.rmsnorm(xt, torch.from_numpy(s))
    assert got.dtype == xt.dtype
    _close(got, want, DTYPES[dtype][2])


def test_rmsnorm_eps_and_order_match_reference_bitwise_fp32():
    """fp32 statistics, `(x * rsqrt(var + eps)) * scale`: the plain
    version equals the JAX oracle to the last bits it can (one rsqrt
    ulp), at a non-default eps too."""
    x, s = _np(11, 16, 48), _np(12, 48)
    for eps in (1e-6, 1e-2):
        want = np.asarray(jref.rmsnorm(jnp.asarray(x), jnp.asarray(s),
                                       eps=eps))
        got = tref.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), eps=eps)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=1e-7)


def test_rmsnorm_wrapper_counts_apart_from_layernorm_on_cpu():
    x, s = torch.from_numpy(_np(13, 5, 32)), torch.from_numpy(_np(14, 32))
    tops.reset_launch_counts()
    assert torch.equal(tln.rmsnorm(x, s), tref.rmsnorm(x, s))
    counts = tops.launch_counts()
    assert counts["rmsnorm"] == 0 and counts["layernorm"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tops.rmsnorm(x, s, policy=KernelPolicy("kernel"))
