"""The hypothesis unit: candidate struct and payload gathering around the
fused merge -> threshold -> top-k op.  Port of `repro/core/hypothesis.py`
(the legacy `merge_duplicates`/`select` stages are not ported).

A hypothesis set is a fixed-K struct-of-tensors.  Scores are two CTC
channels (blank / non-blank); the merge logsumexps each channel
independently, which is exactly CTC prefix-beam merging.
`total = logaddexp(pb, pnb)` orders hypotheses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


class Candidates(NamedTuple):
    """Flat candidate set produced by one hypothesis-expansion execution."""
    hash: torch.Tensor      # (..., N) int32 prefix hash (identity for merging)
    pb: torch.Tensor        # (..., N) f32 log-prob ending in blank
    pnb: torch.Tensor       # (..., N) f32 log-prob ending in non-blank
    fields: dict            # str -> (..., N, ...) payload


def total_score(pb: torch.Tensor, pnb: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(pb, pnb)


def _pad_candidates(c: Candidates, pad: int) -> Candidates:
    """Append `pad` dead candidates (hash 0, NEG_INF scores, zero payload)
    on the candidate axis."""
    nd = c.hash.dim()

    def p(a, value=0):
        spec = [0, 0] * (a.dim() - nd) + [0, pad]
        return F.pad(a, spec, value=value)
    return Candidates(p(c.hash), p(c.pb, NEG_INF), p(c.pnb, NEG_INF),
                      {n: p(a) for n, a in c.fields.items()})


def hypothesis_unit_step_batched(c: Candidates, k: int,
                                 beam_threshold: float,
                                 kernels=None) -> dict:
    """Fused hypothesis-unit operation over a batch of candidate rows.

    hash/pb/pnb (B, N), fields (B, N, ...).  Returns a dict of
    (B, k, ...) tensors + 'valid'.  The merge/threshold/top-k is one
    `ops.hypothesis_unit` call (CUDA kernel or plain version, per the
    `kernels` policy); payload fields are gathered once with the
    returned representative indices."""
    from repro_torch.kernels import ops

    if k > c.hash.shape[-1]:   # pad candidate set up to the beam size
        c = _pad_candidates(c, k - c.hash.shape[-1])
    sel = ops.hypothesis_unit(c.hash, c.pb, c.pnb, k, beam_threshold,
                              policy=kernels)
    idx = sel["idx"].long()                                 # (B, k)
    out = {"pb": sel["pb"], "pnb": sel["pnb"], "valid": sel["valid"],
           "hash": torch.gather(c.hash, 1, idx)}
    for name, arr in c.fields.items():
        ix = idx.reshape(idx.shape + (1,) * (arr.dim() - 2))
        out[name] = torch.gather(arr, 1, ix.expand((-1, -1) + arr.shape[2:]))
    return out


def hypothesis_unit_step(c: Candidates, k: int, beam_threshold: float,
                         kernels=None) -> dict:
    """Full hypothesis-unit operation for one (N,) row."""
    batched = Candidates(c.hash[None], c.pb[None], c.pnb[None],
                         {n: a[None] for n, a in c.fields.items()})
    out = hypothesis_unit_step_batched(batched, k, beam_threshold, kernels)
    return {name: a[0] for name, a in out.items()}
