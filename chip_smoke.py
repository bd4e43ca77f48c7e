#!/usr/bin/env python3
"""Smoke run of the PyTorch port's streaming ASR decode path on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (no phase is caught):
  1. build   — nvcc builds the four Hopper kernels from
               src/repro_torch/kernels/csrc/ (one process per source).
  2. kernels — each kernel vs its plain PyTorch version on the card at
               the main path's shapes.
  3. demo    — the demo system through `AsrEngine` at 1 and 4 slots,
               KernelPolicy("kernel") vs KernelPolicy("ref"): equal
               words and tokens, scores allclose.
  4. full    — the paper's TDS_CONFIG (widths 1200/1520/1840, V=9000)
               with the default decoder (K=128, C=32) and seeded random
               weights serves 8 synthetic utterances over 4 slots; every
               kernel's launch count must match the steps taken, and the
               kernel path's log-probs must match the plain path's.
  5. timing  — each kernel, its plain version and the library call
               (where one exists) at the full-width step shapes, the
               bound, step times per (b, w), a profiler breakdown.
The last lines are the card (nvidia-smi name, power limit), the kernels
JSON and the ok JSON.  Needs a CUDA device; without one it exits 1.
Detailed results (build log, timings, profile) go to build/chip_smoke/.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))     # the port, from this checkout

from repro_torch.configs.tds_asr import (DECODER_CONFIG,  # noqa: E402
                                         FEATURE_CONFIG, TDS_CONFIG)
from repro_torch.core import features, lexicon as lx  # noqa: E402
from repro_torch.data.pipeline import SyntheticASR  # noqa: E402
from repro_torch.kernels import (_build, ops, ref,  # noqa: E402
                                 hypothesis_unit as khu, layernorm as kln,
                                 logmel as klm, tds_conv as ktc)
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.launch.serve import (asr_demo_engine,  # noqa: E402
                                      asr_demo_system)
from repro_torch.models import tds  # noqa: E402
from repro_torch.serving import AsrEngine, AsrProgram, EngineConfig  # noqa: E402

OUT = ROOT / "build" / "chip_smoke"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and fp32 (non-tensor)
# FLOP/s, for the bounds.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

# tolerances of the kernel checks (kernel vs plain version on the card)
TOL = {"logmel": dict(rtol=1e-4, atol=1e-3),
       "layernorm": dict(rtol=1e-5, atol=1e-5),
       "tds_conv": dict(rtol=1e-5, atol=1e-5),
       "hypothesis_unit": dict(rtol=1e-5, atol=0.0)}
REPLACES = {
    "logmel": "src/repro/kernels/logmel.py:24",
    "tds_conv": "src/repro/kernels/tds_conv.py:52",
    "layernorm": "src/repro/kernels/layernorm.py:32",
    "hypothesis_unit": "src/repro/kernels/hypothesis_unit.py:45",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32) * 1e3


# ---------------------------------------------------------------------------
# shapes of one full-width step
# ---------------------------------------------------------------------------
def conv_shapes(cfg, b: int, w: int):
    """(name, k, stride, Cin, Cout, T_in, residual) of every conv of one
    step at b slots and w windows (8 feature frames per window)."""
    out, t = [], 8 * w
    feat = cfg.stages[0].feat
    for spec in tds.build_kernel_specs(cfg):
        if spec.kind == "conv":
            cin, cout = spec.n_in // spec.kernel, spec.n_out // feat
            res = spec.residual and spec.stride == 1 and cin == cout
            out.append((spec.name, spec.kernel, spec.stride, cin, cout, t, res))
        t //= spec.stride
    return out


def ln_shapes(cfg, b: int, w: int):
    """(rows, D) of every LayerNorm of one step."""
    out, t = [], 8 * w
    for spec in tds.build_kernel_specs(cfg):
        t //= spec.stride
        if spec.kind == "layernorm":
            out.append((b * t, spec.n_out))
    return out


def conv_inputs(dev, gen, b, k, stride, cin, cout, t, res):
    x = torch.randn((b, k - 1 + t, 80, cin), generator=gen).to(dev)
    wt = (torch.randn((k, cin, cout), generator=gen)
          / np.sqrt(k * cin)).to(dev)
    bias = (0.1 * torch.randn((cout,), generator=gen)).to(dev)
    r = (torch.randn((b, t // stride, 80, cout), generator=gen).to(dev)
         if res else None)
    return x, wt, bias, r


def hu_inputs(dev, gen, b, n):
    h = torch.randint(0, 4096, (b, n), generator=gen, dtype=torch.int32)
    pb = 3 * torch.randn((b, n), generator=gen)
    pnb = 3 * torch.randn((b, n), generator=gen)
    dead = torch.rand((b, n), generator=gen) < 0.2
    pb = torch.where(dead, torch.full_like(pb, -1e30), pb)
    pnb = torch.where(dead, torch.full_like(pnb, -1e30), pnb)
    return h.to(dev), pb.to(dev), pnb.to(dev)


def power_rows(dev, gen, r):
    return (torch.randn((r, 257), generator=gen).square() * 10.0).to(dev)


def feature_tables(dev):
    fb = torch.from_numpy(features.mel_filterbank(FEATURE_CONFIG)).to(dev)
    dct = torch.from_numpy(features.dct_matrix(80, 80)).to(dev)
    return fb, dct


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------
def check_kernels(dev) -> dict:

    gen = torch.Generator().manual_seed(SEED)
    err = {}

    def close(name, got, want, label):
        d = (got - want).abs().max().item() if got.numel() else 0.0
        err[name] = max(err.get(name, 0.0), d)
        try:
            torch.testing.assert_close(got, want, **TOL[name])
        except AssertionError as e:
            fail(f"{name} {label}: kernel disagrees with its plain version: "
                 f"{e}")
        print(f"[kernels] {name:16s} {label:34s} max|err| {d:.3e} ok",
              flush=True)

    fb, dct = feature_tables(dev)
    for r in (8, 128):
        p = power_rows(dev, gen, r)
        close("logmel", klm.logmel(p, fb, dct), ref.logmel(p, fb, dct),
              f"R={r}")
    torch.cuda.synchronize()

    seen = set()
    for (_, k, s, cin, cout, t, res) in conv_shapes(TDS_CONFIG, 4, 4):
        if (k, s, cin, cout, t, res) in seen:
            continue
        seen.add((k, s, cin, cout, t, res))
        x, wt, bias, r = conv_inputs(dev, gen, 4, k, s, cin, cout, t, res)
        close("tds_conv", ktc.tds_conv(x, wt, bias, r, stride=s, relu=True),
              ref.tds_conv_fused(x, wt, bias, stride=s, relu=True, res=r),
              f"k={k} s={s} {cin}->{cout} T={t} res={int(res)}")
    torch.cuda.synchronize()

    for rows, d in sorted(set(ln_shapes(TDS_CONFIG, 4, 4))):
        x = torch.randn((rows, d), generator=gen).to(dev)
        sc = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
        bi = (0.1 * torch.randn((d,), generator=gen)).to(dev)
        close("layernorm", kln.layernorm(x, sc, bi), ref.layernorm(x, sc, bi),
              f"R={rows} D={d}")
    torch.cuda.synchronize()

    for b, n in ((4, 8320), (4, 4224)):
        h, pb, pnb = hu_inputs(dev, gen, b, n)
        got = khu.hypothesis_unit(h, pb, pnb, k=128, beam=25.0)
        want = ref.hypothesis_unit(h, pb, pnb, k=128, beam=25.0)
        for key in ("idx", "valid"):
            if not torch.equal(got[key], want[key]):
                bad = (got[key] != want[key]).sum().item()
                fail(f"hypothesis_unit ({b},{n}): {key} differs in {bad} "
                     f"of {got[key].numel()} entries")
        for key in ("pb", "pnb"):
            close("hypothesis_unit", got[key], want[key],
                  f"({b},{n}) K=128 {key}")
    torch.cuda.synchronize()
    return err


# ---------------------------------------------------------------------------
# phase 3 / 4: serving through AsrEngine
# ---------------------------------------------------------------------------
def full_width_words(n_words=4096, fanout=32, vocab=9000):
    """4096 words of 2-6 tokens over tokens 1..8999, no trie node with
    more than 32 children (numpy, fixed seed)."""
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


def serve_pair(make_engine, utts, label, assert_equal):
    """Serve `utts` with the kernel and the plain policy; compare."""
    res = {}
    for mode in ("kernel", "ref"):
        eng = make_engine(KernelPolicy(mode))
        t0 = time.perf_counter()
        res[mode] = eng.serve(utts)
        torch.cuda.synchronize()
        print(f"[{label}] policy={mode}: {len(utts)} utterances, "
              f"{eng.n_steps} steps, {time.perf_counter() - t0:.3f} s "
              f"(first use included)", flush=True)
    n_equal = 0
    for i, (a, b) in enumerate(zip(res["kernel"], res["ref"])):
        same = (np.array_equal(a["words"], b["words"])
                and np.array_equal(a["tokens"], b["tokens"]))
        n_equal += same
        if not np.isfinite(a["score"]):
            fail(f"{label} utt {i}: non-finite score {a['score']}")
        print(f"[{label}] utt {i}: words_equal={same} "
              f"score kernel={a['score']:.6f} ref={b['score']:.6f} "
              f"diff={a['score'] - b['score']:.3e} words={a['words'].tolist()}",
              flush=True)
        if assert_equal:
            if not same:
                fail(f"{label} utt {i}: transcripts differ: kernel "
                     f"{a['words'].tolist()}/{a['tokens'].tolist()} vs ref "
                     f"{b['words'].tolist()}/{b['tokens'].tolist()}")
            if not np.isclose(a["score"], b["score"], rtol=1e-4, atol=1e-4):
                fail(f"{label} utt {i}: scores {a['score']} vs {b['score']}")
    return res, n_equal


def demo_phase(dev):
    system = asr_demo_system()
    utts = [SyntheticASR(system[1]).utterance(u)["audio"] for u in range(4)]
    for n_slots in (1, 4):
        serve_pair(lambda pol, n=n_slots: asr_demo_engine(
            n, pol, device=dev, system=system)[0], utts,
            f"demo slots={n_slots}", assert_equal=True)


def full_width_system(dev):
    """The paper's TDS_CONFIG and default decoder with seeded random
    weights (placed on `dev` once, shared by every engine below)."""
    words = full_width_words(fanout=DECODER_CONFIG.max_children,
                             vocab=TDS_CONFIG.vocab_size)
    lex = lx.build_lexicon(words, max_children=DECODER_CONFIG.max_children)
    lm = lx.uniform_bigram(len(words))
    params = tds.init_tds(torch.Generator().manual_seed(SEED), TDS_CONFIG,
                          device=dev)
    return TDS_CONFIG, words, lex, lm, params, DECODER_CONFIG


def full_width_utterances(words, n=8):
    """`n` SyntheticASR utterances; within each group of four, two of 2
    words and two of 4, so that serving them over 4 slots gathers steps
    of 4, 2 and 1 slots (the long pair outlives the short pair)."""
    data = SyntheticASR(words)
    return [data.utterance(u, n_words=(2, 2, 4, 4)[u % 4])["audio"]
            for u in range(n)]


def full_engine(dev, system, policy, n_slots=4):
    tds_cfg, _, lex, lm, params, dec_cfg = system
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg)
    return AsrEngine(EngineConfig(prog, n_slots=n_slots, kernels=policy),
                     params, device=dev)


def window_batch(eng, utts, b, w):
    """(b, w, need) samples: the first w windows of utterances 0..b-1."""
    need, spp = eng._need, eng._spp
    batch = np.zeros((b, w, need), np.float32)
    for j in range(b):
        for i in range(w):
            batch[j, i] = utts[j][i * spp:i * spp + need]
    return batch


def full_phase(dev, system, utts):

    eng = full_engine(dev, system, KernelPolicy("auto"))
    torch.cuda.synchronize()
    # ---- the main path: counts set to 0 just before, read just after --
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.serve(utts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    steps = list(eng.step_shapes)
    n_steps = len(steps)
    expect = {"logmel": n_steps, "tds_conv": 18 * n_steps,
              "layernorm": 32 * n_steps,
              "hypothesis_unit": sum(w for _, _, w in steps)}
    print(f"[full] served {len(utts)} utterances over 4 slots in {wall:.3f} s "
          f"(first use included): {n_steps} steps, (n_active, b, w) = "
          f"{steps}", flush=True)
    print(f"[full] launch counts {counts}, expected {expect}", flush=True)
    if counts != expect or not n_steps:
        fail(f"launch counts {counts} != expected {expect}")
    shapes = {(b, w) for _, b, w in steps}
    if not ({b for b, _ in shapes} >= {1, 2, 4}
            and {w for _, w in shapes} >= {1, 2, 4}):
        fail(f"gathered steps did not cover b and w in 1, 2, 4: {shapes}")
    for r in results:
        if not np.isfinite(r["score"]):
            fail(f"non-finite full-width score {r['score']}")

    # ---- per-step log-probs: kernel path vs plain path, same batch ----
    lp_err = 0.0
    for b, w in ((4, 4), (1, 1), (2, 2)):
        batch = torch.from_numpy(window_batch(eng, utts, b, w)).to(dev)
        st = tds.init_batched_stream_state(system[0], b, dev)
        out = {}
        for mode in ("kernel", "ref"):
            lp, _ = eng.acoustic(batch, st, kernels=KernelPolicy(mode))
            out[mode] = lp
        torch.cuda.synchronize()
        if out["kernel"].shape != (b, w, system[0].vocab_size) or \
                not torch.isfinite(out["kernel"]).all():
            fail(f"log-probs at b={b} w={w}: shape "
                 f"{tuple(out['kernel'].shape)} or non-finite values")
        d = (out["kernel"] - out["ref"]).abs().max().item()
        lp_err = max(lp_err, d)
        print(f"[full] log-probs b={b} w={w}: kernel vs plain max|err| "
              f"{d:.3e} (atol 1e-3)", flush=True)
        torch.testing.assert_close(out["kernel"], out["ref"], rtol=1e-4,
                                   atol=1e-3)

    # ---- the plain path on the same utterances, for the transcripts ---
    ref_eng = full_engine(dev, system, KernelPolicy("ref"))
    ref_results = ref_eng.serve(utts)
    torch.cuda.synchronize()
    n_eq = 0
    for i, (a, r) in enumerate(zip(results, ref_results)):
        same = (np.array_equal(a["words"], r["words"])
                and np.array_equal(a["tokens"], r["tokens"]))
        n_eq += same
        print(f"[full] utt {i}: words_equal={same} best-score diff "
              f"{a['score'] - r['score']:.3e} (kernel {a['score']:.4f}, "
              f"ref {r['score']:.4f}), {len(a['words'])} words", flush=True)
    print(f"[full] words equal for {n_eq}/{len(utts)} utterances", flush=True)
    return counts, steps, lp_err


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------
def host_ms(fn, n=30, warmup=3) -> float:
    """Median time of one call from its enqueue to the end of its work
    (CUDA events around each call; host launch overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def device_ms(fn, n=20, warmup=3) -> float:
    """Median over n calls of the device time of one call, without the
    host's launch overhead.  Before each call a spin kernel
    (`torch.cuda._sleep`) holds the stream while the host enqueues the
    call between two CUDA events, so the device then runs the call's
    kernels back to back and the events bracket only them.  The spin is
    lengthened until it outlasts the enqueue (checked, not assumed); one
    call at a time, so a call of many kernels never fills the launch
    queue and blocks the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 4_000_000
    times = []
    while len(times) < n:
        s0, e0, s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(4))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0.record()
        torch.cuda._sleep(cycles)
        e0.record()
        s.record()
        fn()
        e.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if s0.elapsed_time(e0) > enqueue_ms:
            times.append(s.elapsed_time(e))
        elif cycles < 4_000_000_000:
            cycles *= 4
        else:
            fail(f"the spin kernel never outlasted the host's enqueue "
                 f"({enqueue_ms:.1f} ms)")
    return float(np.median(times))


def timing_phase(dev) -> dict:
    """Each kernel's launches in one full-width step at b=4, w=4:
    summed medians of the kernel, the plain version and (where one call
    computes the same function) the library call, and the bound."""

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}

    def add(name, launches, fk, fp, fl, nbytes, flops, label):
        """fk/fp/fl: one call of the kernel / plain version / library."""
        kms, pms = device_ms(fk), device_ms(fp)
        lms = None if fl is None else device_ms(fl)
        khost = host_ms(fk)
        r = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=None,
                                       bound_ms=0.0, bytes=0.0, flops=0.0,
                                       step_launches=0, host_ms=0.0))
        r["host_ms"] += launches * khost
        r["ms"] += launches * kms
        r["plain_ms"] += launches * pms
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + launches * lms
        r["bound_ms"] += launches * bound_ms(nbytes, flops)
        r["bytes"] += launches * nbytes
        r["flops"] += launches * flops
        r["step_launches"] += launches
        print(f"[timing] {name:16s} {label:30s} x{launches:<2d} device: "
              f"kernel {kms * 1e3:9.2f} us  plain {pms * 1e3:9.2f} us  "
              f"library {'-' if lms is None else f'{lms * 1e3:.2f}'} us  "
              f"bound {bound_ms(nbytes, flops) * 1e3:.3f} us | kernel call "
              f"with launch {khost * 1e3:.2f} us", flush=True)

    # logmel: R = b * w * 8 = 128 rows
    fb, dct = feature_tables(dev)
    p = power_rows(dev, gen, 128)
    R, Fb, M, C = 128, 257, 80, 80
    add("logmel", 1, lambda: klm.logmel(p, fb, dct),
        lambda: ref.logmel(p, fb, dct),
        lambda: torch.log(torch.clamp(p @ fb, min=1e-10)) @ dct,
        4 * (R * Fb + Fb * M + M * C + R * C),
        2 * R * Fb * M + 2 * R * M + 2 * R * M * C, "R=128")

    # tds_conv: the 18 convs of the step
    shapes = {}
    for (_, k, s, cin, cout, t, res) in conv_shapes(TDS_CONFIG, 4, 4):
        key = (k, s, cin, cout, t, res)
        shapes[key] = shapes.get(key, 0) + 1
    for (k, s, cin, cout, t, res), n in shapes.items():
        x, wt, bias, r = conv_inputs(dev, gen, 4, k, s, cin, cout, t, res)
        t_out = t // s
        outs = 4 * t_out * 80 * cout
        nbytes = 4 * (x.numel() + wt.numel() + cout + outs * (2 if res else 1))
        flops = 2 * outs * k * cin + outs * (3 if res else 2)
        add("tds_conv", n,
            lambda x=x, wt=wt, bias=bias, r=r, s=s: ktc.tds_conv(
                x, wt, bias, r, stride=s, relu=True),
            lambda x=x, wt=wt, bias=bias, r=r, s=s: ref.tds_conv_fused(
                x, wt, bias, stride=s, relu=True, res=r),
            None, nbytes, flops, f"k={k} s={s} {cin}->{cout} T={t}")

    # layernorm: the 32 LayerNorms of the step
    lns = {}
    for key in ln_shapes(TDS_CONFIG, 4, 4):
        lns[key] = lns.get(key, 0) + 1
    for (nr, d), n in sorted(lns.items()):
        x = torch.randn((nr, d), generator=gen).to(dev)
        sc = torch.ones((d,), device=dev)
        bi = torch.zeros((d,), device=dev)
        add("layernorm", n, lambda x=x, sc=sc, bi=bi: kln.layernorm(x, sc, bi),
            lambda x=x, sc=sc, bi=bi: ref.layernorm(x, sc, bi),
            lambda x=x, sc=sc, bi=bi, d=d: F.layer_norm(x, (d,), sc, bi,
                                                        1e-5),
            4 * (2 * nr * d + 2 * d), 8 * nr * d, f"R={nr} D={d}")

    # hypothesis unit: w = 4 launches at (4, 8320), K = 128
    b, n, k = 4, 8320, 128
    h, pb, pnb = hu_inputs(dev, gen, b, n)
    add("hypothesis_unit", 4,
        lambda: khu.hypothesis_unit(h, pb, pnb, k=k, beam=25.0),
        lambda: ref.hypothesis_unit(h, pb, pnb, k=k, beam=25.0),
        None, b * n * 12 + b * k * 13, 20 * b * n,
        "(4, 8320) K=128, 20% dead")
    return rows


def step_times(dev, system, utts) -> dict:
    """Wall time of one full-width decoding step per (b, w): batch
    assembly and upload, acoustic scoring and w expansions, ending in a
    synchronize (median of 5 after one warm-up step)."""
    out = {}
    for mode in ("kernel", "ref"):
        eng = full_engine(dev, system, KernelPolicy(mode))
        for s in range(4):
            eng.feed_slot(s, utts[s])
        for b in (1, 2, 4):
            for w in (1, 2, 4):
                slots = list(range(b))
                ts = []
                for i in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng._step_slots(slots, w, commit=False)
                    torch.cuda.synchronize()
                    if i:                      # the first call warms up
                        ts.append(time.perf_counter() - t0)
                out[f"{mode} b={b} w={w}"] = float(np.median(ts)) * 1e3
                print(f"[step] policy={mode} b={b} w={w}: "
                      f"{out[f'{mode} b={b} w={w}']:.3f} ms median of 5",
                      flush=True)
    return out


def profile_step(dev, system, utts, step_ms: float) -> dict:
    """Device time by kernel over one b=4, w=4 kernel-path step of real
    decoding (the hypothesis unit sees the decoder's own candidates),
    and the device's idle share of the unprofiled step time."""
    eng = full_engine(dev, system, KernelPolicy("kernel"))
    for s in range(4):
        eng.feed_slot(s, utts[s])
    eng._step_slots([0, 1, 2, 3], 4, commit=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._step_slots([0, 1, 2, 3], 4, commit=False)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, n, t) for k, (n, t) in by_name.items()),
                  key=lambda r: -r[2])
    busy = sum(t for _, _, t in rows)
    n_events = sum(n for _, n, _ in rows)
    if not n_events:
        print("[profile] the profiler recorded no device events: device "
              "busy time and idle share not measured", flush=True)
        return {"step_ms": step_ms, "device_busy_ms": None}
    print(f"[profile] b=4 w=4 kernel-path step: {n_events} device events, "
          f"device busy {busy:.3f} ms of the unprofiled {step_ms:.3f} ms "
          f"step: idle share {max(0.0, 1 - busy / step_ms):.3f}", flush=True)
    for key, cnt, ms in rows[:14]:
        print(f"[profile]   {ms:8.3f} ms  x{cnt:<4d} {key[:100]}", flush=True)
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "device_events": n_events,
            "by_kernel": [list(r) for r in rows[:60]]}


# ---------------------------------------------------------------------------
def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    (OUT / "build_log.txt").write_text(_build.build_log)
    print(f"[build] {len(_build.sources())} sources -> {lib_path.name}: "
          f"{build_s:.2f} s ({'built' if _build.build_seconds else 'reused'})",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}", flush=True)

    # 2. kernel checks
    errs = check_kernels(dev)

    # 3. demo system, kernel vs ref policy
    demo_phase(dev)
    torch.cuda.synchronize()

    # 4. full width
    t0 = time.perf_counter()
    system = full_width_system(dev)
    utts = full_width_utterances(system[1])
    print(f"[full] system: TDS_CONFIG, {len(system[1])} words, "
          f"{system[2].n_nodes} trie nodes, K={system[5].beam_size}, "
          f"C={system[5].max_children}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counts, steps, lp_err = full_phase(dev, system, utts)
    torch.cuda.synchronize()

    # 5. timing
    rows = timing_phase(dev)
    torch.cuda.synchronize()
    steps_ms = step_times(dev, system, utts)
    prof = profile_step(dev, system, utts, steps_ms["kernel b=4 w=4"])
    torch.cuda.synchronize()

    kernels = []
    for name in ("logmel", "tds_conv", "layernorm", "hypothesis_unit"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes"] / PEAK_BYTES
                         >= r["flops"] / PEAK_FP32 else "operations"),
            "library_ms": r["library_ms"],
            "work": f"the {r['step_launches']} launches of one full-width "
                    f"step at b=4, w=4 (device time)",
            "launch_inclusive_ms": r["host_ms"],
        })
    (OUT / "results.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "build_s": build_s, "kernels": kernels, "steps": steps,
        "launch_counts": counts, "logp_max_abs_err": lp_err,
        "step_ms": steps_ms, "profile": prof}, indent=1))
    print(f"[done] launches on the main path: {counts}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
