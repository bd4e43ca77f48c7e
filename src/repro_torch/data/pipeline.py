"""Deterministic, resumable synthetic data: a copy of
`repro/data/pipeline.py` (numpy only), kept in the port so that it
imports nothing of the JAX package.  Each source draws the same numpy
streams as the reference, so its batches equal the reference's bit for
bit.

The pipeline is a pure function of (seed, step, shard): a restart
resumes from the checkpointed step counter with no state files, and a
different shard count re-partitions the same global stream.

  * SyntheticLM  — zipf-ish token stream for LM training (next-token
    labels built here).
  * SyntheticASR — synthetic utterances: a pure function of (seed,
    index), sine-mixture tone segments per token plus noise, with the
    word and token transcript.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class SyntheticLM:
    """Deterministic zipf token stream; batch(step) is pure."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {cfg.n_shards} shards")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_shards

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        out_tok = np.empty((self.local_batch, cfg.seq_len + 1), np.int64)
        for i in range(self.local_batch):
            g = cfg.global_batch * step + cfg.shard * self.local_batch + i
            rng = np.random.default_rng((cfg.seed << 32) ^ g)
            out_tok[i] = rng.zipf(1.3, cfg.seq_len + 1) % cfg.vocab_size
        tokens = out_tok[:, :-1].astype(np.int32)
        labels = out_tok[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class SyntheticASR:
    """Synthetic utterances: each token renders as a tone segment; the
    transcript is a word sequence from a small lexicon."""

    def __init__(self, words: dict, sample_rate: int = 16000,
                 tok_ms: float = 120.0, seed: int = 0):
        self.words = list(words.items())
        self.sr = sample_rate
        self.tok_samples = int(sample_rate * tok_ms / 1000)
        self.seed = seed

    def utterance(self, idx: int, n_words: int = 3) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ idx)
        wids = rng.integers(0, len(self.words), n_words)
        toks = []
        for w in wids:
            toks.extend(self.words[w][1])
        sig = []
        for t in toks:
            f = 200.0 + 37.0 * (t + 1)
            n = self.tok_samples
            tt = np.arange(n) / self.sr
            seg = (np.sin(2 * np.pi * f * tt)
                   + 0.3 * np.sin(2 * np.pi * 2 * f * tt))
            seg *= np.hanning(n)
            sig.append(seg)
        audio = np.concatenate(sig).astype(np.float32)
        audio += rng.normal(0, 0.01, audio.shape).astype(np.float32)
        return {"audio": audio, "words": np.asarray(wids, np.int32),
                "tokens": np.asarray(toks, np.int32)}
