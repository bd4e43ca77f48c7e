"""Fused hypothesis unit: hash merge + beam threshold + top-K, one block per row.

Replaces the TPU kernel `hypothesis_unit_pallas`
(src/repro/kernels/hypothesis_unit.py) and the argsort its wrapper
`ops._hypothesis_unit` (src/repro/kernels/ops.py) runs outside it: the
Hopper kernel groups, merges and selects in shared memory itself.  CUDA
source: `csrc/hypothesis_unit.cu`.

What bounds it on the H100: not bytes (about 100 KB a row at N = 8320,
0.03 us at 3.35 TB/s) but one SM per slot row (only B of the 132 SMs
work), whose load pass over the row is the kernel's largest step on the
decoder's rows.  The design reads the row once, coalesced, compacts
the live candidates in original order, groups equal hashes by bucketing
instead of sorting, sums each segment in original index order (so the
merge is deterministic, unlike an unordered `scatter_add`), filters the
heads by the beam before selecting, ranks the survivors directly, and
runs a radix select first only where more than max(K, 256) survive:
about 14 block barriers in all, where the bitonic sorts it replaces paid
one per pass.

Output conventions follow `ref.hypothesis_unit`: `idx` int32 (0 where
pruned), `pb`/`pnb` (NEG_INF where pruned), bool `valid`.  On a CPU
tensor the wrapper runs that plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper
MAX_ROW = 16384     # candidates per row the kernel takes
CARRY_N = 10240     # longer rows keep their channels in a global scratch


def hypothesis_unit(hashes: torch.Tensor, pb: torch.Tensor,
                    pnb: torch.Tensor, *, k: int, beam: float) -> dict:
    """hashes: (B, N) int32 31-bit prefix hashes; pb/pnb: (B, N) f32.
    Returns a dict of (B, k) tensors: idx, pb, pnb, valid."""
    global launches
    if not hashes.is_cuda:
        return ref.hypothesis_unit(hashes, pb, pnb, k=k, beam=beam)
    _build.refuse_grad("hypothesis_unit", hashes, pb, pnb)
    dev = hashes.device
    _build.require(hashes, "hashes", torch.int32, 2, dev)
    _build.require(pb, "pb", torch.float32, 2, dev)
    _build.require(pnb, "pnb", torch.float32, 2, dev)
    B, N = hashes.shape
    if tuple(pb.shape) != (B, N) or tuple(pnb.shape) != (B, N):
        raise ValueError(f"hypothesis_unit: hashes {tuple(hashes.shape)}, pb "
                         f"{tuple(pb.shape)}, pnb {tuple(pnb.shape)}")
    if not 1 <= k <= N:
        raise ValueError(f"hypothesis_unit: need 1 <= k <= N, got k={k}, "
                         f"N={N}")
    if N > MAX_ROW:
        raise ValueError(f"hypothesis_unit: N={N} > {MAX_ROW} candidates "
                         f"per row")
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    opb = torch.empty((B, k), dtype=torch.float32, device=dev)
    opnb = torch.empty((B, k), dtype=torch.float32, device=dev)
    valid = torch.empty((B, k), dtype=torch.bool, device=dev)
    scratch = (torch.empty((B, 2, N), dtype=torch.float32, device=dev)
               if N > CARRY_N else None)
    err = _build.lib().hypothesis_unit_launch(
        hashes.data_ptr(), pb.data_ptr(), pnb.data_ptr(), idx.data_ptr(),
        opb.data_ptr(), opnb.data_ptr(), valid.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, N, k,
        float(beam), _build.stream(dev))
    _build.check(err, "hypothesis_unit")
    launches += 1
    return {"idx": idx, "pb": opb, "pnb": opnb, "valid": valid}
