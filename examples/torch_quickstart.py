"""Quickstart for the PyTorch port: decode one utterance end to end.

The port's counterpart of examples/quickstart.py.  Builds the pipeline —
MFCC features -> TDS acoustic model -> CTC beam search over a lexicon
trie + bigram LM — as a frozen serving program (`AsrProgram`), then
streams a synthetic utterance through a `Session` in 80 ms pushes.  One
engine decoding step per full window; `finish()` commits the final word
and frees the slot.  On the GPU (the default) every step runs the
port's Hopper kernels; `--device cpu` runs their plain versions.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs.tds_asr import (DecoderConfig, TDSConfig,  # noqa: E402
                                         TDSStage)
from repro_torch.core import lexicon as lx  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.models import tds  # noqa: E402
from repro_torch.serving import AsrEngine, AsrProgram, EngineConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "kernels' plain versions on the CPU)")
    args = ap.parse_args(argv)

    # 1. a small TDS acoustic model (same kernel structure as the paper's)
    tds_cfg = TDSConfig(
        stages=(TDSStage(1, 4, 80, 9, 2), TDSStage(1, 4, 80, 9, 2),
                TDSStage(1, 6, 80, 9, 2)),
        vocab_size=32)
    params = tds.init_tds(torch.Generator().manual_seed(0), tds_cfg)
    census = tds.kernel_census(tds_cfg)
    print(f"TDS kernels: {census} "
          f"(paper's full system: 18 conv / 29 fc / 32 layernorm)")

    # 2. lexicon trie + bigram LM
    words = {f"word{i}": [1 + (i * 3 + j) % 30 for j in range(2 + i % 3)]
             for i in range(10)}
    lex = lx.build_lexicon(words, max_children=16)
    lm = lx.uniform_bigram(len(words))

    # 3. one frozen program instead of the configure-command sequence
    program = AsrProgram(tds_cfg, lex, lm,
                         dec_cfg=DecoderConfig(beam_size=32),
                         ).with_beam_width(25.0)
    engine = AsrEngine(EngineConfig(program, n_slots=1), params,
                       device=args.device)
    plan = engine.plan
    print(f"decoding step plan on {engine.device}: {plan.samples_per_step} "
          f"samples -> {plan.feat_frames_per_step} feature frames -> "
          f"{plan.acoustic_frames_per_step} acoustic frame(s), "
          f"{len(plan.kernels)} kernels, {plan.total_threads()} threads")

    # 4. stream one synthetic utterance through a serving session
    utt = SyntheticASR(words).utterance(0)
    audio = utt["audio"]
    spp = plan.samples_per_step
    session = engine.open()
    for off in range(0, len(audio), spp):
        session.push(audio[off:off + spp])
        session.poll()                 # live best hypothesis so far
    best = session.finish()            # end of utterance: commit + free slot
    print(f"decoded {len(audio)/16000:.2f}s of audio in "
          f"{best['steps']} decoding steps")
    print(f"best hypothesis: words={best['words'].tolist()} "
          f"tokens={best['tokens'].tolist()} score={best['score']:.2f}")
    print(f"(untrained acoustic model — structure demo; "
          f"reference words were {utt['words'].tolist()})")
    print(f"session {session!r}: slot freed for the next connection")
    return best


if __name__ == "__main__":
    main()
