"""Lexicon trie + bigram language model as dense padded tensors, port of
`repro/core/lexicon.py`.

Each trie node stores up to `max_children` (child_id, token) pairs;
word-final nodes carry a word id for the LM.  The bigram LM is a dense
(n_words+1, n_words) log-prob table (row n_words = sentence start).
Both are built on the host with numpy and live on one device; `to()`
moves them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class Lexicon:
    """Padded trie over acoustic tokens."""
    children: torch.Tensor      # (n_nodes, C) int32 child node id, -1 = pad
    child_token: torch.Tensor   # (n_nodes, C) int32 acoustic token on the edge
    word_id: torch.Tensor       # (n_nodes,) int32 word id if word-final else -1
    n_nodes: int
    max_children: int

    @property
    def root(self) -> int:
        return 0

    def to(self, device) -> "Lexicon":
        return Lexicon(self.children.to(device), self.child_token.to(device),
                       self.word_id.to(device), self.n_nodes,
                       self.max_children)

    @classmethod
    def from_numpy(cls, children, child_token, word_id, n_nodes: int,
                   max_children: int, device="cpu") -> "Lexicon":
        """Carry a lexicon across as numpy arrays (e.g. the JAX
        package's `Lexicon` fields via `np.asarray`)."""
        def t(a):
            return torch.tensor(np.asarray(a, np.int32), device=device)
        return cls(t(children), t(child_token), t(word_id), int(n_nodes),
                   int(max_children))


def build_lexicon(words: Dict[str, Sequence[int]], max_children: int) -> Lexicon:
    """words: word -> token-id sequence. Word ids = insertion order."""
    children: List[Dict[int, int]] = [{}]
    word_id: List[int] = [-1]
    for wid, (_word, toks) in enumerate(words.items()):
        node = 0
        for t in toks:
            nxt = children[node].get(t)
            if nxt is None:
                nxt = len(children)
                children[node][t] = nxt
                children.append({})
                word_id.append(-1)
            node = nxt
        word_id[node] = wid
    n = len(children)
    ch = np.full((n, max_children), -1, np.int32)
    ct = np.full((n, max_children), -1, np.int32)
    for i, cs in enumerate(children):
        if len(cs) > max_children:
            raise ValueError(f"trie fanout {len(cs)} > {max_children}")
        for j, (t, c) in enumerate(sorted(cs.items())):
            ch[i, j] = c
            ct[i, j] = t
    return Lexicon.from_numpy(ch, ct, np.asarray(word_id, np.int32), n,
                              max_children)


@dataclass(frozen=True)
class BigramLM:
    """log P(w | prev). State = prev word id; start state = n_words."""
    table: torch.Tensor         # (n_words + 1, n_words) f32 log-probs
    n_words: int

    @property
    def start_state(self) -> int:
        return self.n_words

    def score(self, state: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        return self.table[state.long(), word.long()]

    def advance(self, state: torch.Tensor, word: torch.Tensor) -> torch.Tensor:
        del state
        return word

    def to(self, device) -> "BigramLM":
        return BigramLM(self.table.to(device), self.n_words)

    @classmethod
    def from_numpy(cls, table, n_words: int, device="cpu") -> "BigramLM":
        return cls(torch.tensor(np.asarray(table, np.float32),
                                device=device), int(n_words))


def uniform_bigram(n_words: int) -> BigramLM:
    t = np.full((n_words + 1, n_words), -np.log(n_words), np.float32)
    return BigramLM.from_numpy(t, n_words)


def bigram_from_counts(counts: np.ndarray, alpha: float = 0.5) -> BigramLM:
    """counts: (n_words+1, n_words) raw bigram counts (last row = <s>)."""
    c = counts.astype(np.float64) + alpha
    t = np.log(c / c.sum(axis=1, keepdims=True)).astype(np.float32)
    return BigramLM.from_numpy(t, counts.shape[1])
