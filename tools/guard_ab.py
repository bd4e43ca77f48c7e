"""Time the serving engines' warmed steps in two checkouts of the repo,
alternating, on one card: the cost of the host-sync guard and of the
uploads that go with it (pinned, `non_blocking`), against a checkout
without them.

    python3 tools/guard_ab.py --before DIR [--rounds 2] [--out FILE]

DIR is a checkout of the commit to compare with (`git archive` of it
unpacked).  Each round runs DIR, this checkout, this checkout, DIR, one
process each, so that drift on the card or the host falls on both
sides alike.  A process builds (or loads) its checkout's kernel
library, then times, on the paper's TDS_CONFIG at full width with
seeded random weights and 4 slots of noise, ASR_STEPS warmed
`AsrEngine._step_slots` calls for each of fp32 and int8 and w in
(1, 4), and LM_STEPS warmed `LmEngine._step` decode steps of
h2o-danube-1.8b at full width in bf16 at 4 slots.  Every step is timed
on its own between two `torch.cuda.synchronize()` calls (the steps are
bound by the host).  It prints one JSON line per process, then the
medians over the processes of each side's per-process medians, their
ratio, and the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED = 0
SLOTS = 4
WINDOWS = (1, 4)
ASR_STEPS = 20
LM_ARCH = "h2o-danube-1.8b"
LM_PROMPTS = (100, 300, 200, 480)
LM_BUCKET = 512
LM_STEPS = 16


def full_width_words(n_words=4096, fanout=32, vocab=9000):
    """4096 words of 2-6 tokens over tokens 1..vocab-1, no trie node with
    more than `fanout` children (numpy, fixed seed)."""
    rng = np.random.default_rng(SEED)
    children = [dict()]
    words, seen = {}, set()
    while len(words) < n_words:
        node, toks = 0, []
        for _ in range(int(rng.integers(2, 7))):
            ch = children[node]
            t = (int(rng.integers(1, vocab)) if len(ch) < fanout
                 else int(rng.choice(list(ch))))
            if t not in ch:
                ch[t] = len(children)
                children.append({})
            toks.append(t)
            node = ch[t]
        if tuple(toks) not in seen:
            seen.add(tuple(toks))
            words[f"w{len(words)}"] = toks
    return words


def timed(torch, fn, n):
    """Per-call milliseconds of `n` calls of `fn`, each synchronized."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(out),
            "mean_ms": statistics.fmean(out)}


def worker(tree: pathlib.Path) -> dict:
    """Time the steps with `tree`'s package (imported from tree/src)."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.tds_asr import DECODER_CONFIG, TDS_CONFIG
    from repro_torch.core import lexicon as lx
    from repro_torch.kernels import _build
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.models import LM, tds
    from repro_torch.serving import (AsrEngine, AsrProgram, EngineConfig,
                                     LmEngine, LmProgram)

    import repro_torch
    assert pathlib.Path(repro_torch.__file__).is_relative_to(tree), \
        repro_torch.__file__
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.lib()
    out = {"tree": str(tree), "build_or_load_s": time.perf_counter() - t0}
    words = full_width_words(fanout=DECODER_CONFIG.max_children,
                             vocab=TDS_CONFIG.vocab_size)
    lex = lx.build_lexicon(words, max_children=DECODER_CONFIG.max_children)
    lm = lx.uniform_bigram(len(words))
    params = tds.init_tds(torch.Generator().manual_seed(SEED), TDS_CONFIG,
                          device=dev)
    rng = np.random.default_rng(SEED + 1)
    slots = list(range(SLOTS))
    for use_int8 in (False, True):
        prog = AsrProgram(TDS_CONFIG, lex, lm, dec_cfg=DECODER_CONFIG,
                          use_int8=use_int8)
        eng = AsrEngine(EngineConfig(prog, n_slots=SLOTS,
                                     kernels=KernelPolicy("auto")),
                        params, device=dev)
        spp = eng.plan.samples_per_step
        need = sum((ASR_STEPS + 1) * w for w in WINDOWS) + 4
        for s in slots:
            eng.feed_slot(s, rng.standard_normal(spp * need + 4000)
                          .astype(np.float32) * 0.1)
        for w in WINDOWS:
            eng._step_slots(slots, w)                   # warm-up
            out[f"asr {'int8' if use_int8 else 'fp32'} w={w}"] = timed(
                torch, lambda: eng._step_slots(slots, w), ASR_STEPS)
        del eng
    cfg = get_config(LM_ARCH)
    lm_params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    prog = LmProgram(cfg, cache_len=LM_BUCKET + LM_STEPS + 3,
                     max_new=LM_STEPS + 3, prefill_buckets=(LM_BUCKET,))
    eng = LmEngine(EngineConfig(prog, n_slots=SLOTS,
                                kernels=KernelPolicy("auto")),
                   lm_params, device=dev)
    prompts = np.random.default_rng(SEED + 3)
    for n in LM_PROMPTS:
        eng.open().push(prompts.integers(1, cfg.vocab_size, n)
                        .astype(np.int32))
    eng._step()                                         # warm-up
    out["lm decode"] = timed(torch, eng._step, LM_STEPS)
    return out


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", type=pathlib.Path,
                    help="the checkout to compare with")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--worker", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print(json.dumps(worker(args.worker.resolve())), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("guard_ab: needs a CUDA device", file=sys.stderr)
        return 1
    if args.before is None:
        ap.error("--before DIR is required")
    sides = {"before": args.before.resolve(), "after": ROOT}
    runs = []
    for r in range(args.rounds):
        for side in ("before", "after", "after", "before"):
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", str(sides[side])],
                capture_output=True, text=True, cwd=sides[side],
                timeout=600)
            if proc.returncode != 0:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return proc.returncode
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res.update(side=side, round=r)
            runs.append(res)
            print(json.dumps(res), flush=True)
    summary = {}
    for key in [k for k in runs[0] if isinstance(runs[0][k], dict)]:
        med = {side: statistics.median(x[key]["median_ms"] for x in runs
                                       if x["side"] == side)
               for side in sides}
        summary[key] = dict(med, ratio=med["after"] / med["before"])
        print(f"{key}: before {med['before']:.3f} ms, after "
              f"{med['after']:.3f} ms a step (medians), after/before "
              f"{summary[key]['ratio']:.4f}", flush=True)
    smi = card()
    print(smi, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "runs": runs,
                                        "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
