"""The int8 product with its activation quantization fused in, on the CPU.

The card computes `ops.int8_matmul_prepared(x, wq, ws)` in one launch
(`int8_matmul.int8_matmul_fused`): per-row quantization of the fp32
activations, the int8 product and the rescale.  Here its plain version
(`ref.int8_matmul_prepared`, which the wrapper runs for CPU tensors) is
held bitwise against the JAX package's `ops.int8_matmul_prepared`, run
as the JAX package's own tests run it: under the "ref" policy (plain
`quantize_rows`, then `ref.int8_matmul`) and, at small shapes, with the
Pallas kernel in interpret mode.  Shapes: the four FC/head shapes of the
full-width model at small M, ragged shapes, rows exactly half-way between
two int8 steps (x = (n + 0.5) * s, rounded half to even) and all-zero
rows (s = 0, the divisor clamped to 1e-12).

The kernel's launch planning (`int8_matmul.plan`) is plain Python and is
tested here too: its plans cover K with no empty K slice, fit shared
memory, fill the card on the main path, and it refuses what the kernel
does not take.

Tolerance: bitwise everywhere (integer products are exact, and the
quantization and the rescale are the same IEEE fp32 operations).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro_torch.kernels import int8_matmul as tim  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(1)

FULL_WIDTH = [(4, 1200, 1200), (2, 1520, 1520), (1, 1840, 1840),
              (1, 1840, 9000), (16, 1840, 1840)]
RAGGED = [(5, 37, 29), (17, 4100, 3), (3, 100, 7), (9, 65, 130)]


def _np(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            ).astype(np.float32)


def _half_way(seed, m, k):
    """Rows of values (n + 0.5) * s with max |x| = 127 s (s a power of
    two, so x / s is exactly n + 0.5), every third row all zero."""
    r = np.random.RandomState(seed)
    x = np.zeros((m, k), np.float32)
    for i in range(m):
        if i % 3 == 1:
            continue
        s = np.float32(2.0 ** r.randint(-4, 5))
        x[i] = (r.randint(-127, 127, k).astype(np.float32)
                + np.float32(0.5)) * s
        x[i, r.randint(k)] = np.float32(127.0) * s
    return x


def _both(x, w, mode):
    """(JAX's int8_matmul_prepared, the port's plain fused path) on the
    same numpy operands, each with its own prepared weights."""
    jwq, jws = jops.prepare_int8_weights(jnp.asarray(w))
    want = np.asarray(jops.int8_matmul_prepared(jnp.asarray(x), jwq, jws,
                                                policy=JaxPolicy(mode)))
    wq, ws = tops.prepare_int8_weights(torch.from_numpy(w))
    got = tim.int8_matmul_fused(torch.from_numpy(x), wq, ws)
    assert torch.equal(got, tops.int8_matmul_prepared(torch.from_numpy(x),
                                                      wq, ws))
    return got.numpy(), want


@pytest.mark.parametrize("m,k,n", FULL_WIDTH)
def test_fused_plain_path_matches_jax_at_full_width(m, k, n):
    x, w = _np(m + k, m, k, scale=2.0), _np(n, k, n, scale=0.05)
    got, want = _both(x, w, "ref")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("m,k,n", RAGGED)
def test_fused_plain_path_matches_jax_at_ragged_shapes(m, k, n, mode):
    x, w = _np(m * k, m, k), _np(n * k, k, n)
    got, want = _both(x, w, mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["ref", "interpret"])
@pytest.mark.parametrize("m,k,n", [(7, 1840, 24), (6, 37, 16), (3, 129, 8)])
def test_fused_plain_path_matches_jax_half_way_and_zero_rows(m, k, n, mode):
    x, w = _half_way(m + k, m, k), _np(n, k, n)
    jq, js = jops.quantize_rows(jnp.asarray(x))
    q, s = tref.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s.numpy()[1::3] == 0).all() and (q.numpy()[1::3] == 0).all()
    # every x / s is an integer or exactly half-way between two
    ratio = x[0] / s.numpy()[0]
    assert set(np.abs(ratio - np.round(ratio))) <= {0.0, 0.5}
    got, want = _both(x, w, mode)
    np.testing.assert_array_equal(got, want)


def test_plain_scale_is_a_true_division():
    """The per-row scale is max|x| / 127 correctly rounded (the plain
    version divides by a tensor, never by its reciprocal)."""
    x = _np(1, 4096, 16, scale=5.0)
    _, s = tref.quantize_rows(torch.from_numpy(x))
    amax = np.abs(x).max(axis=1).astype(np.float64)
    np.testing.assert_array_equal(s.numpy(),
                                  (amax / 127.0).astype(np.float32))


MAIN_PATH = FULL_WIDTH[:4] + [(64, 1200, 1200), (32, 1520, 1520),
                              (16, 1840, 9000)]


@pytest.mark.parametrize("m,k,n", MAIN_PATH + RAGGED + [
    (100, 200, 96), (128, 128, 128), (1, 0, 5), (16, 16_000, 8),
    (300, 64, 64)])
def test_plan_covers_k_and_fits(m, k, n):
    p = tim.plan(m, k, n)
    tim.check_plan(p, m, k, n)
    nch = -(-k // tim.CHUNK)
    assert p.split * p.cps * tim.CHUNK >= k
    assert p.split == 1 or (p.split - 1) * p.cps < nch    # no empty slice
    assert 1 <= p.split <= tim.MAX_SPLIT
    assert tim.smem_bytes(p) <= tim.MAX_SMEM


@pytest.mark.parametrize("m,k,n", MAIN_PATH)
def test_plan_fills_the_card_on_the_main_path(m, k, n):
    """Many blocks, at most two a SM (one wave)."""
    p = tim.plan(m, k, n)
    lo = 64 if m <= 4 else 96
    assert lo <= tim.blocks(p, m, n) <= 2 * tim.H100_SMS, p


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="shared memory"):
        tim.plan(64, 10 ** 6, 4)
    with pytest.raises(ValueError):
        tim.plan(0, 16, 16)
    for bad in (tim.Plan(4, 1, 1),              # K = 1840 not covered
                tim.Plan(4, 8, 28),             # slices 2-8 empty
                tim.Plan(8, 1, 29),             # 8 column tiles a warp
                tim.Plan(4, 9, 4),              # a cluster of 9
                tim.Plan(2, 1, 1000)):          # more shared memory
        with pytest.raises(ValueError):
            tim.check_plan(bad, 16, 1840, 1840)
    tim.check_plan(tim.Plan(4, 8, 4), 16, 1840, 1840)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    tops.reset_launch_counts()
    x = torch.from_numpy(_half_way(3, 5, 40))
    wq, ws = tops.prepare_int8_weights(torch.from_numpy(_np(4, 40, 9)))
    q, s = tops.quantize_rows(x)
    assert torch.equal(tim.int8_matmul(q, wq, s, ws),
                       tim.int8_matmul_fused(x, wq, ws))
    assert tops.launch_counts()["int8_matmul"] == 0
