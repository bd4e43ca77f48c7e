"""The bf16 flash kernel's epilogue quotient, replayed on the CPU.

`fa_tma_kernel` (src/repro_torch/kernels/csrc/flash_attention.cu,
`tm_store`) divides each output accumulator o by den = max(l, 1e-30)
without a division per value: y = RN(1/den) once a row, q0 = RN(o·y),
e = RN(o - q0·den) and q = RN(q0 + e·y), the last two as FMAs (one
rounding each).  A thread holding any |o| outside [2^-64, 2^64] (0
aside) divides instead.  The kernel claims q is the IEEE quotient RN(o /
den) bit for bit wherever it takes that path; these tests replay the
five float32 roundings exactly (float64 holds each product of two
float32 values exactly, the residual is exact by Sterbenz's lemma, and
the last FMA is rounded from an exact rational) over the kernel's range:
den from 1e-30 (a row that saw no key, o = 0) and ~1 up to past any
sequence length, o across the whole fast range, mantissas at the edges
of their binades.
"""
from fractions import Fraction

import numpy as np
import pytest

F32 = np.float32


def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even (normal range)."""
    f = F32(float(x))
    cands = (np.nextafter(f, F32(-np.inf)), f, np.nextafter(f, F32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.asarray(c).view(np.uint32)) & 1))


def _kernel_quotient(o: np.float32, den: np.float32) -> np.float32:
    y = F32(1) / den                                    # IEEE, once a row
    q0 = F32(float(o) * float(y))                       # exact, then RN
    e = F32(float(o) - float(den) * float(q0))          # FMA: exact, then RN
    return _rn32(Fraction(float(q0)) + Fraction(float(e))
                 * Fraction(float(y)))                  # FMA


def _edge(rng, lo_exp, hi_exp, n):
    """n float32 values with mantissas near 1 or 2 at random exponents."""
    ulps = rng.integers(0, 64, n)
    mant = np.where(rng.random(n) < 0.5, 1 + ulps * 2.0 ** -23,
                    2 - (ulps + 1) * 2.0 ** -23)
    return np.ldexp(mant, rng.integers(lo_exp, hi_exp, n)).astype(F32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kind", ["normal", "edges", "bits"])
def test_quotient_equals_the_ieee_division(seed, kind):
    rng = np.random.default_rng(seed)
    n = 1500
    if kind == "normal":                    # attention-like outputs and sums
        o = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n))
        den = rng.uniform(0.999, 4096.0, n)
    elif kind == "edges":
        o = _edge(rng, -64, 64, n) * rng.choice([-1, 1], n)
        den = _edge(rng, 0, 22, n)
    else:                                   # any bits in the fast range
        o = rng.integers(0x1F800000, 0x5F800000, n,
                         dtype=np.uint32).view(F32)
        den = rng.integers(0x3F7F0000, 0x4B000000, n,
                           dtype=np.uint32).view(F32)
    o, den = o.astype(F32), den.astype(F32)
    for a, b in zip(o, den):
        assert _kernel_quotient(a, b) == a / b, (a, b)


def test_quotient_of_a_row_that_saw_no_key_is_zero():
    """o = 0 over den = max(0, 1e-30): +0, as 0 / 1e-30 is."""
    q = _kernel_quotient(F32(0), F32(1e-30))
    assert q == 0 and not np.signbit(q)
