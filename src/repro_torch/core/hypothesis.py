"""The hypothesis unit: candidate struct and payload gathering around the
fused merge -> threshold -> top-k op, and the legacy `merge_duplicates`/
`select` stages, kept as the semantic spec of the fused op.  Port of
`repro/core/hypothesis.py`.

A hypothesis set is a fixed-K struct-of-tensors.  Scores are two CTC
channels (blank / non-blank); the merge logsumexps each channel
independently, which is exactly CTC prefix-beam merging.
`total = logaddexp(pb, pnb)` orders hypotheses.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import HASH_SENTINEL as _SENTINEL, _seg_lse

NEG_INF = -1e30


class Candidates(NamedTuple):
    """Flat candidate set produced by one hypothesis-expansion execution."""
    hash: torch.Tensor      # (..., N) int32 prefix hash (identity for merging)
    pb: torch.Tensor        # (..., N) f32 log-prob ending in blank
    pnb: torch.Tensor       # (..., N) f32 log-prob ending in non-blank
    fields: dict            # str -> (..., N, ...) payload


def total_score(pb: torch.Tensor, pnb: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(pb, pnb)


def merge_duplicates(c: Candidates) -> Candidates:
    """logsumexp-merge the candidates of one (N,) row with equal hash.

    After the merge, one representative per hash (its first occurrence)
    keeps the combined channels; the rest drop to NEG_INF.  Payload
    fields of duplicates are identical by construction (same prefix), so
    they pass through unchanged.  (Legacy stage: the decode path uses
    the fused `hypothesis_unit_step`.)"""
    n = c.hash.shape[0]
    dev = c.hash.device
    valid = total_score(c.pb, c.pnb) > NEG_INF / 2
    # the hash's uint32 value, as the reference keys it
    key = torch.where(valid, c.hash.long() & 0xFFFFFFFF,
                      torch.full_like(c.hash, _SENTINEL, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    sk = key[order]
    seg_start = torch.ones((n,), dtype=torch.bool, device=dev)
    seg_start[1:] = sk[1:] != sk[:-1]
    seg_id = torch.cumsum(seg_start, 0) - 1                  # (N,)

    pb_m = _seg_lse(c.pb[order], seg_id, n)
    pnb_m = _seg_lse(c.pnb[order], seg_id, n)
    keep = seg_start & (sk != _SENTINEL)
    neg = torch.full_like(pb_m, NEG_INF)
    inv = torch.argsort(order)
    return Candidates(c.hash, torch.where(keep, pb_m, neg)[inv],
                      torch.where(keep, pnb_m, neg)[inv], c.fields)


def select(c: Candidates, k: int, beam_threshold: float) -> dict:
    """Sort + prune one (N,) row: top-k by total score (ties to the
    lowest index), then the beam threshold.  Returns the new hypothesis
    set: a dict of (k,) tensors + 'valid'.  (Legacy stage — see
    `merge_duplicates`.)"""
    if k > c.hash.shape[0]:      # pad the candidate set up to the beam size
        c = _pad_candidates(c, k - c.hash.shape[0])
    tot = total_score(c.pb, c.pnb)
    top, idx = torch.sort(tot, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    valid = (top > NEG_INF / 2) & (top >= top[0] - beam_threshold)
    neg = torch.full_like(top, NEG_INF)
    out = {"hash": c.hash[idx], "pb": torch.where(valid, c.pb[idx], neg),
           "pnb": torch.where(valid, c.pnb[idx], neg), "valid": valid}
    for name, arr in c.fields.items():
        out[name] = arr[idx]
    return out


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
