"""End-to-end ASR on the PyTorch port: train the paper's system with CTC,
then transcribe streamed audio.

The port's counterpart of examples/train_and_transcribe_asr.py, the
wav2letter loop of §4 of the paper at toy scale:
  1. synthesize a speech corpus over a small lexicon,
  2. train a TDS acoustic model with CTC (autograd through the plain
     versions of the kernels: `KernelPolicy("ref")`; AdamW),
  3. load it into the ASRPU runtime (the configure commands),
  4. stream held-out utterances through DecodingStep in 80 ms chunks
     (the kernels on the card; their plain versions with --device cpu),
  5. report partial transcripts per chunk and the final WER.

  PYTHONPATH=src python examples/torch_train_and_transcribe_asr.py \
      [--device cpu] [--steps 120]
"""
import argparse
import pathlib
import sys
import warnings

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.tds_asr import (DecoderConfig,  # noqa: E402
                                         FeatureConfig, TDSConfig, TDSStage)
from repro_torch.core import ctc, features, lexicon as lx  # noqa: E402
from repro_torch.core.scheduler import ASRPU  # noqa: E402
from repro_torch.core.treeutil import value_and_grad  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.models import tds  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

PLAIN = KernelPolicy("ref")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    feat_cfg = FeatureConfig(n_mels=16, n_mfcc=16)
    tds_cfg = TDSConfig(
        stages=(TDSStage(1, 3, 16, 5, 2), TDSStage(1, 3, 16, 5, 2),
                TDSStage(1, 4, 16, 5, 2)),
        sub_kernel=6, vocab_size=8)
    words = {"a": [1], "bc": [2, 3], "d": [4]}
    lex = lx.build_lexicon(words, max_children=8)
    lm = lx.uniform_bigram(len(words))
    data = SyntheticASR(words, tok_ms=200.0)

    # --- corpus ----------------------------------------------------------
    utts = [data.utterance(i, n_words=2) for i in range(8)]
    train, test = utts[:6], utts[6:]
    max_audio = max(len(u["audio"]) for u in utts)

    def padded(u):
        audio = np.zeros((max_audio,), np.float32)
        audio[:len(u["audio"])] = u["audio"]
        return audio

    # pad the AUDIO to the longest (silence -> blanks), never truncate a
    # transcript: labels must stay alignable for CTC
    audio = torch.from_numpy(np.stack([padded(u) for u in train])).to(dev)
    X = features.mfcc(audio, feat_cfg, kernels=PLAIN)
    X = X[:, :(X.shape[1] // 8) * 8]
    Y = torch.from_numpy(np.stack([
        np.pad(u["tokens"], (0, 8 - len(u["tokens"])), constant_values=-1)
        for u in train])).to(dev)

    # --- train (CTC) ------------------------------------------------------
    params = tds.init_tds(torch.Generator().manual_seed(0), tds_cfg,
                          device=dev)
    state0 = tds.init_batched_stream_state(tds_cfg, X.shape[0], dev)

    def loss_fn(p):
        lps, _ = tds.forward_batched(p, tds_cfg, X, state0, kernels=PLAIN)
        return ctc.ctc_loss_batch(lps, Y)

    ocfg = adamw.AdamWConfig(lr=3e-3, weight_decay=0.0)
    opt = adamw.init(params, ocfg)

    def step(p, o):
        _, grads = value_and_grad(loss_fn, p)
        return adamw.update(grads, o, p, ocfg)

    n_params = sum(t.numel() for v in params.values() for t in v.values())
    print(f"training TDS ({n_params} params) with CTC on {dev}...")
    for it in range(args.steps):
        params, opt = step(params, opt)
        if (it + 1) % 40 == 0 or it + 1 == args.steps:
            with torch.no_grad():
                print(f"  step {it+1}: ctc loss {float(loss_fn(params)):.4f}")

    # --- serve: stream the held-out utterances through the ASRPU runtime --
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        asrpu = ASRPU(device=dev)
    asrpu.configure_acoustic_scoring(tds_cfg, params, feat_cfg)
    dcfg = DecoderConfig(beam_size=16, beam_threshold=1e9, lm_weight=0.5,
                         word_score=0.0)
    asrpu.configure_hyp_expansion(lex, lm, dcfg)

    refs, hyps = [], []
    spp = asrpu.plan.samples_per_step
    for u in test:
        asrpu.clean_decoding()
        signal = padded(u)
        partials = []
        for off in range(0, len(signal), spp):
            b = asrpu.decoding_step(signal[off:off + spp])
            partials.append(list(b["words"]))
        final = asrpu.best(final=True)
        print(f"  utt ref={list(u['words'])} partials={partials[::4]} "
              f"final={list(final['words'])}")
        refs.append(list(u["words"]))
        hyps.append(list(final["words"]))
    print(f"held-out WER: {ctc.wer(refs, hyps):.2f}")
    return ctc.wer(refs, hyps)


if __name__ == "__main__":
    main()
