"""CTC loss (Graves et al. 2006), forward algorithm in log space, port
of `repro/core/ctc.py`.

The training counterpart of the decoder: wav2letter-style systems
(paper §4) train the TDS acoustic model with CTC.  Standard extended
label sequence (blank-interleaved), alpha recursion over time with
`torch.logaddexp`, -1-padded labels supported.  The recursion runs once
for the whole batch: each row keeps its own label count, the emission
log-probs of every extended label at every frame come from one gather,
and each frame is one batched update of the (B, 2L+1) alphas.  Autograd
differentiates it, as `jax.grad` differentiates the reference's scan.

An impossible alignment (labels longer than the frames allow) gives a
loss of about 1e30, not inf, as in the reference: `NEG` stands for
log 0.  Its gradient is where the two packages part: every state is NEG
there, the log 2 of each logaddexp is absorbed, and `jnp.logaddexp`'s
derivative exp(x - out) weighs both inputs 1, so the reference's
gradient doubles at every frame back in time (2^(T-2) at the second
frame: inf in fp32 from T = 130).  `torch.logaddexp`'s derivative,
1 / (1 + exp(y - x)), weighs them 1/2: the port's stays below 1.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor,
             blank_id: int) -> torch.Tensor:
    """(B, T, V) log-probs, (B, L) labels (-1 pad) -> (B,) negative log
    likelihoods, in the log-probs' dtype."""
    B, T, _ = log_probs.shape
    dev, dt = log_probs.device, log_probs.dtype
    labels = labels.to(device=dev, dtype=torch.int64)
    L = labels.shape[1]
    n_lab = (labels >= 0).sum(dim=1)                              # (B,)
    lab = torch.where(labels >= 0, labels, torch.full_like(labels, blank_id))
    # extended sequence: blank, l1, blank, l2, ..., blank  (len 2L+1)
    S = 2 * L + 1
    ext = torch.full((B, S), blank_id, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    s = torch.arange(S, device=dev)
    valid = s[None, :] < (2 * n_lab + 1)[:, None]                 # (B, S)
    # skip from s-2 when ext[s] != blank and ext[s] != ext[s-2]
    ext_m2 = torch.cat([torch.full((B, 2), -2, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (s % 2 == 1)[None, :] & (ext != ext_m2)
    # emission log-prob of every extended label at every frame
    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))
    neg = torch.full((B, S), NEG, dtype=dt, device=dev)
    # alpha_0: blank, and the first label where there is one
    first = (s[None, :] == 0) | ((s[None, :] == 1) & (n_lab > 0)[:, None])
    alpha = torch.where(first, emit[:, 0], neg)
    pad1, pad2 = neg[:, :1], neg[:, :2]
    for t in range(1, T):
        prev = torch.cat([pad1, alpha[:, :-1]], dim=1)
        skip = torch.where(can_skip, torch.cat([pad2, alpha[:, :-2]], dim=1),
                           neg)
        a = torch.logaddexp(torch.logaddexp(alpha, prev), skip) + emit[:, t]
        alpha = torch.where(valid, a, neg)
    end1 = torch.gather(alpha, 1, (2 * n_lab)[:, None])[:, 0]     # final blank
    # the last label's state; with no label there is none, so the
    # (clamped) read is masked, never used
    end2 = torch.gather(alpha, 1, torch.clamp(2 * n_lab - 1, min=0)[:, None])
    end2 = torch.where(n_lab > 0, end2[:, 0], neg[:, 0])
    return -torch.logaddexp(end1, end2)


def ctc_loss(log_probs: torch.Tensor, labels: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """log_probs: (T, V) log-softmax outputs; labels: (L,) int, -1 pad.

    Returns the scalar negative log likelihood of the label sequence."""
    return _ctc_nll(log_probs[None], labels[None], blank_id)[0]


def ctc_loss_batch(log_probs: torch.Tensor, labels: torch.Tensor,
                   blank_id: int = 0) -> torch.Tensor:
    """(B, T, V) x (B, L) -> the mean of the per-utterance CTC losses
    (not `F.ctc_loss`'s length-normalised mean)."""
    return _ctc_nll(log_probs, labels, blank_id).mean()


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two int sequences (python lists)."""
    ref, hyp = list(ref), list(hyp)
    dp = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        prev = dp[0]
        dp[0] = i
        for j, h in enumerate(hyp, 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (r != h))
            prev = cur
    return dp[-1]


def wer(refs, hyps) -> float:
    """Word error rate over a corpus of (ref, hyp) id sequences."""
    errs = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    n = sum(len(r) for r in refs)
    return errs / max(n, 1)
