"""Synthetic utterances for the ASR case study.

A copy of `SyntheticASR` from `repro/data/pipeline.py` (numpy only),
kept in the port so that it imports nothing of the JAX package.  An
utterance is a pure function of (seed, index): sine-mixture tone
segments per token plus noise, with its word and token transcript.
"""
from __future__ import annotations

import numpy as np


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
