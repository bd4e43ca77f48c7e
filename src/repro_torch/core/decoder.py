"""CTC prefix-beam-search decoding with lexicon trie + bigram LM, port of
`repro/core/decoder.py`.

Each hypothesis-expansion execution (one acoustic frame) expands every
live hypothesis into:
  * 1 "stay" candidate  — CTC blank (pb channel) + CTC repeat (pnb channel),
  * C "continue" candidates — one per reachable lexicon-trie child,
  * C "commit" candidates — child is word-final: word is emitted, the LM
    scores the word, the hypothesis returns to the trie root.
The hypothesis unit (core/hypothesis.py) then merges duplicates and
sort-prunes to K.  All state is a fixed-shape struct of tensors; a
decode is a Python loop over frames.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.tds_asr import DecoderConfig
from repro_torch.core import hypothesis as hyp
from repro_torch.core import treeutil
from repro_torch.core.lexicon import BigramLM, Lexicon

NEG_INF = hyp.NEG_INF
MAX_TOKENS = 256
MAX_WORDS = 64


def _mix(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """31-bit multiplicative prefix hash -> int32.  The reference relies
    on int32 wraparound; int64 arithmetic masked to 31 bits keeps the
    same low bits (h < 2**31 and the multiplier < 2**20, so the product
    cannot overflow int64)."""
    return (((h.long() * 1000003) ^ (x.long() + 0x9E3779B))
            & 0x7FFFFFFF).to(torch.int32)


class BeamState(NamedTuple):
    hash: torch.Tensor        # (K,) int32
    pb: torch.Tensor          # (K,) f32
    pnb: torch.Tensor         # (K,) f32
    node: torch.Tensor        # (K,) int32 lexicon trie node
    lm_state: torch.Tensor    # (K,) int32
    last_token: torch.Tensor  # (K,) int32 last emitted token (-1 = none)
    tokens: torch.Tensor      # (K, MAX_TOKENS) int32 emitted token history
    n_tokens: torch.Tensor    # (K,) int32
    words: torch.Tensor       # (K, MAX_WORDS) int32 committed word ids
    n_words: torch.Tensor     # (K,) int32


def init_state(k: int, lm: BigramLM, device=None) -> BeamState:
    device = lm.table.device if device is None else device
    i32 = dict(dtype=torch.int32, device=device)
    pb = torch.full((k,), NEG_INF, dtype=torch.float32, device=device)
    pb[0] = 0.0
    h = torch.zeros((k,), **i32)
    h[0] = 1
    return BeamState(
        hash=h, pb=pb,
        pnb=torch.full((k,), NEG_INF, dtype=torch.float32, device=device),
        node=torch.zeros((k,), **i32),
        lm_state=torch.full((k,), lm.start_state, **i32),
        last_token=torch.full((k,), -1, **i32),
        tokens=torch.full((k, MAX_TOKENS), -1, **i32),
        n_tokens=torch.zeros((k,), **i32),
        words=torch.full((k, MAX_WORDS), -1, **i32),
        n_words=torch.zeros((k,), **i32),
    )


def _append(arr, n, val):
    """arr: (..., L); n/val: (...) -> arr with arr[..., n] = val."""
    L = arr.shape[-1]
    pos = torch.arange(L, device=arr.device)
    onehot = pos == torch.clamp(n, max=L - 1)[..., None]
    return torch.where(onehot, val[..., None], arr)


def _append_if(arr, n, val):
    """Batched conditional append: arr (B, K, L); n/val (B, K); append
    `val` at position n where val >= 0, else pass the row through."""
    L = arr.shape[-1]
    pos = torch.arange(L, device=arr.device)
    onehot = ((pos[None, None, :] == torch.clamp(n, max=L - 1)[:, :, None])
              & (val >= 0)[:, :, None])
    return torch.where(onehot, val[:, :, None], arr)


def expand_step_batched(state: BeamState, log_probs: torch.Tensor,
                        lex: Lexicon, lm: BigramLM, cfg: DecoderConfig,
                        kernels=None) -> BeamState:
    """One batched hypothesis-expansion execution.

    state: (B, K, ...) BeamState; log_probs: (B, V) — one acoustic frame
    per stream.  The lexicon trie and bigram table are shared across
    slots: every gather runs once over the flattened (B*K,) / (B*K*C,)
    index set.  The merge/threshold/top-k is the fused hypothesis unit
    with one row per slot.  Candidates carry only scalar payload
    fields; the K winners' token/word histories are rebuilt from
    (parent, appended token/word) after selection."""
    B, K = state.hash.shape
    C = lex.max_children
    dev = state.hash.device
    i32 = dict(dtype=torch.int32, device=dev)
    lp = log_probs.float()                               # (B, V)
    tot = hyp.total_score(state.pb, state.pnb)           # (B, K)
    alive = tot > NEG_INF / 2
    # a Python scalar in torch.where: a device tensor made from a Python
    # number is a host-to-device copy, which blocks the host every frame
    neg = NEG_INF

    # ---- stay candidates (blank + repeat), one per hypothesis ----------
    lp_last = torch.where(
        state.last_token >= 0,
        torch.gather(lp, 1, torch.clamp(state.last_token, min=0).long()),
        neg)                                             # (B, K)
    parent0 = torch.arange(K, **i32)[None].expand(B, K)
    minus1 = torch.full((B, K), -1, **i32)
    stay = hyp.Candidates(
        hash=state.hash,
        pb=torch.where(alive, tot + lp[:, cfg.blank_id][:, None], neg),
        pnb=torch.where(alive, state.pnb + lp_last, neg),
        fields=dict(node=state.node, lm_state=state.lm_state,
                    last_token=state.last_token, n_tokens=state.n_tokens,
                    n_words=state.n_words, parent=parent0,
                    app_tok=minus1, app_word=minus1),
    )

    # ---- extension candidates (continue / commit), K x C per slot ------
    nodes_f = state.node.reshape(B * K).long()
    child = lex.children[nodes_f].reshape(B, K, C)
    ctok = lex.child_token[nodes_f].reshape(B, K, C)
    has_child = child >= 0
    ctok_s = torch.clamp(ctok, min=0)
    lp_ext = torch.where(
        has_child,
        torch.gather(lp, 1, ctok_s.reshape(B, K * C).long()).reshape(B, K, C),
        neg)                                             # (B, K, C)
    # CTC merge rule: extending with the last token needs a blank in between
    same = ctok_s == state.last_token[:, :, None]
    base = torch.where(same, state.pb[:, :, None], tot[:, :, None])
    pnb_ext = torch.where(alive[:, :, None], base + lp_ext, neg)

    h_ext = _mix(state.hash[:, :, None], ctok_s * 2)     # continue-hash
    n_tok_ext = (state.n_tokens[:, :, None] + 1).expand(B, K, C)
    lm_state_b = state.lm_state[:, :, None].expand(B, K, C)
    parent_b = parent0[:, :, None].expand(B, K, C)
    n_words_b = state.n_words[:, :, None].expand(B, K, C)

    def flat(x):
        return x.reshape((B, K * C) + tuple(x.shape[3:]))

    neg_kc = torch.full((B, K * C), NEG_INF, dtype=torch.float32, device=dev)
    cont = hyp.Candidates(
        hash=flat(h_ext), pb=neg_kc, pnb=flat(pnb_ext),
        fields=dict(
            node=flat(child), lm_state=flat(lm_state_b),
            last_token=flat(ctok_s), n_tokens=flat(n_tok_ext),
            n_words=flat(n_words_b), parent=flat(parent_b),
            app_tok=flat(ctok_s),
            app_word=torch.full((B, K * C), -1, **i32)),
    )

    wid = torch.where(
        has_child,
        lex.word_id[torch.clamp(child, min=0).reshape(B * K * C).long()
                    ].reshape(B, K, C),
        torch.full_like(child, -1))
    is_word = wid >= 0
    wid_s = torch.clamp(wid, min=0)
    lm_sc = lm.score(lm_state_b, wid_s)    # one shared bigram-table gather
    commit_pnb = torch.where(
        is_word, pnb_ext + cfg.lm_weight * lm_sc + cfg.word_score, neg)
    h_commit = _mix(_mix(state.hash[:, :, None], ctok_s * 2 + 1), wid_s)

    commit = hyp.Candidates(
        hash=flat(h_commit), pb=neg_kc, pnb=flat(commit_pnb),
        fields=dict(
            node=flat(torch.where(is_word, torch.full_like(child, lex.root),
                                  torch.full_like(child, -1))),
            lm_state=flat(lm.advance(lm_state_b, wid_s).to(torch.int32)),
            last_token=flat(ctok_s), n_tokens=flat(n_tok_ext),
            n_words=flat(n_words_b + 1), parent=flat(parent_b),
            app_tok=flat(ctok_s),
            app_word=flat(torch.where(is_word, wid_s,
                                      torch.full_like(wid_s, -1)))),
    )

    cand = hyp.Candidates(
        hash=torch.cat([stay.hash, cont.hash, commit.hash], dim=1),
        pb=torch.cat([stay.pb, cont.pb, commit.pb], dim=1),
        pnb=torch.cat([stay.pnb, cont.pnb, commit.pnb], dim=1),
        fields={k: torch.cat([stay.fields[k], cont.fields[k],
                              commit.fields[k]], dim=1)
                for k in stay.fields},
    )
    sel = hyp.hypothesis_unit_step_batched(cand, K, cfg.beam_threshold,
                                           kernels)
    # rebuild the K winners' token/word histories: gather the parent
    # rows and conditionally append the one new token/word
    parent = sel["parent"].long()                        # (B, K)
    par_tokens = torch.gather(
        state.tokens, 1, parent[:, :, None].expand(-1, -1, MAX_TOKENS))
    par_words = torch.gather(
        state.words, 1, parent[:, :, None].expand(-1, -1, MAX_WORDS))
    appending = (sel["app_tok"] >= 0).to(torch.int32)
    tokens = _append_if(par_tokens, sel["n_tokens"] - appending,
                        sel["app_tok"])
    words = _append_if(par_words,
                       sel["n_words"] - (sel["app_word"] >= 0).to(torch.int32),
                       sel["app_word"])
    return BeamState(
        hash=sel["hash"], pb=sel["pb"], pnb=sel["pnb"], node=sel["node"],
        lm_state=sel["lm_state"], last_token=sel["last_token"],
        tokens=tokens, n_tokens=sel["n_tokens"], words=words,
        n_words=sel["n_words"])


def expand_step(state: BeamState, log_probs: torch.Tensor, lex: Lexicon,
                lm: BigramLM, cfg: DecoderConfig, kernels=None) -> BeamState:
    """One expansion for a single (K, ...) beam — the B=1 slice of the
    batched expansion, so single-stream and slot-pool decoding share one
    code path."""
    out = expand_step_batched(treeutil.tree_map(lambda a: a[None], state),
                              log_probs[None], lex, lm, cfg, kernels)
    return treeutil.tree_map(lambda a: a[0], out)


def decode(log_probs: torch.Tensor, lex: Lexicon, lm: BigramLM,
           cfg: DecoderConfig, kernels=None) -> BeamState:
    """Offline decode: log_probs (T, V) -> final beam state."""
    st = init_state(cfg.beam_size, lm, log_probs.device)
    for lp in log_probs:
        st = expand_step(st, lp, lex, lm, cfg, kernels)
    return st


def init_batched_state(batch: int, k: int, lm: BigramLM,
                       device=None) -> BeamState:
    """Beam state for `batch` independent streams: leaves are (B, K, ...)."""
    return treeutil.batch_tree(init_state(k, lm, device), batch)


def decode_batched(log_probs: torch.Tensor, lex: Lexicon, lm: BigramLM,
                   cfg: DecoderConfig, kernels=None) -> BeamState:
    """Offline batched decode: log_probs (B, T, V) -> (B, K, ...) beams."""
    st = init_batched_state(log_probs.shape[0], cfg.beam_size, lm,
                            log_probs.device)
    for t in range(log_probs.shape[1]):
        st = expand_step_batched(st, log_probs[:, t], lex, lm, cfg, kernels)
    return st


def slot_state(state: BeamState, slot) -> BeamState:
    """Slice one stream's (K, ...) beam out of a (B, K, ...) batch."""
    return treeutil.tree_map(lambda a: a[slot], state)


def reset_slot(state: BeamState, slot, lm: BigramLM) -> BeamState:
    """A copy of `state` with stream `slot` reset to a fresh init_state."""
    return treeutil.set_slot(
        state, slot, init_state(state.hash.shape[1], lm, state.hash.device))


def finalize(state: BeamState, lex: Lexicon, lm: BigramLM,
             cfg: DecoderConfig) -> BeamState:
    """End-of-utterance: commit pending word-final hypotheses.

    Words are normally committed when the search extends past a
    word-final trie node; the utterance's last word has no such
    extension step, so hypotheses sitting on a word-final node get their
    word (and LM score) applied here.  Works on (K, ...) and (B, K, ...)
    states alike."""
    wid = lex.word_id[torch.clamp(state.node, min=0).long()]
    pend = (wid >= 0) & (state.node != lex.root)
    wid_s = torch.clamp(wid, min=0)
    bonus = cfg.lm_weight * lm.score(state.lm_state, wid_s) + cfg.word_score
    pb = torch.where(pend & (state.pb > NEG_INF / 2), state.pb + bonus,
                     state.pb)
    pnb = torch.where(pend & (state.pnb > NEG_INF / 2), state.pnb + bonus,
                      state.pnb)
    words = torch.where(pend[..., None],
                        _append(state.words, state.n_words, wid_s),
                        state.words)
    return state._replace(
        pb=pb, pnb=pnb, words=words,
        n_words=torch.where(pend, state.n_words + 1, state.n_words),
        lm_state=torch.where(pend, lm.advance(state.lm_state, wid_s),
                             state.lm_state),
        node=torch.where(pend, torch.full_like(state.node, lex.root),
                         state.node))


# the reference's vmap of `finalize` over streams; `finalize` is
# elementwise over the hypotheses, so it takes (B, K, ...) as it is
finalize_batched = finalize


def best(state: BeamState) -> dict:
    """Best hypothesis of one (K, ...) beam (ties to the lowest index)."""
    tot = hyp.total_score(state.pb, state.pnb)
    i = torch.argmax(tot)
    return {"score": tot[i], "words": state.words[i],
            "n_words": state.n_words[i], "tokens": state.tokens[i],
            "n_tokens": state.n_tokens[i]}


def materialize_best(b: dict) -> dict:
    """Trim a `best` readout to host arrays: words/tokens cut to their
    true lengths + float score (the serving engine's result payload)."""
    n = int(b["n_words"])
    return {"words": b["words"].cpu().numpy()[:n].astype(np.int32),
            "tokens": b["tokens"].cpu().numpy()[:int(b["n_tokens"])
                                                ].astype(np.int32),
            "score": float(b["score"])}


def best_hypothesis(state: BeamState, lex: Lexicon, lm: BigramLM,
                    cfg: DecoderConfig, *, final: bool = False) -> dict:
    """Materialize the best hypothesis of one (K, ...) beam as host
    arrays.  final=True first commits a pending utterance-final word
    (see `finalize`); the input state is not modified."""
    if final:
        state = finalize(state, lex, lm, cfg)
    return materialize_best(best(state))


def greedy_decode(log_probs: torch.Tensor, blank_id: int = 0) -> torch.Tensor:
    """The paper's baseline: best token per frame, repeats collapsed,
    blanks dropped.  log_probs (T, V) -> (T,) int32, padded with -1.
    A scatter, not a boolean mask, so the card never syncs on the
    number of kept tokens."""
    T = log_probs.shape[0]
    dev = log_probs.device
    ids = torch.argmax(log_probs, dim=-1).to(torch.int32)     # (T,)
    prev = torch.full_like(ids, -1)
    prev[1:] = ids[:-1]
    keep = (ids != blank_id) & (ids != prev)
    pos = torch.cumsum(keep, 0) - 1
    # dropped frames all write -1 into the extra slot T, cut off below
    out = torch.full((T + 1,), -1, dtype=torch.int32, device=dev)
    out.scatter_(0, torch.where(keep, pos, torch.full_like(pos, T)),
                 torch.where(keep, ids, torch.full_like(ids, -1)))
    return out[:T]
