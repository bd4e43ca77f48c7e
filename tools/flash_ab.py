"""Compare this checkout's bf16 LM prefill path with another checkout's on
one card: the flash_attention kernel at chip_smoke.py's timed shapes, and
the prefills of chip_smoke.py's phases 8 (h2o-danube-1.8b), 12
(qwen2-moe-a2.7b), 20 (qwen2-vl-7b) and 21(a) (musicgen-medium), their
wall and device-busy times.

    python3 tools/flash_ab.py [--before DIR] [--rounds 2] [--sass]
                              [--out FILE]

DIR is the other checkout (`git archive` of the parent commit, unpacked
in a directory that .gitignore lists).  Each run is a process of its own
that imports its tree's chip_smoke.py, so each tree runs its own kernels
(built into its own build/) under its own harness: `lm_timing_phase` at
LM_FLASH_TIMED + LM3_FLASH_TIMED (flash only: kernel, plain, SDPA and
bound; SDPA with the band mask and, where the tree's harness has it,
with `is_causal`), `lm_serve_phase` and `lm_profile` for LM_ARCH (every
bucket's prefill wall time, the 6144 bucket's included, and the busy
time of a 1-row 2048-token prefill) and MOE_ARCH, and
`embed_model_phase` for VLM_ARCH and AUDIO_ARCH, which hold their tokens
and logits to their own checks and fail the run otherwise.  The runs
alternate: before, after, after, before, ... (`--rounds` of each).  The
last lines are the card's name and power limit and a JSON object of
every run, also written to FILE.  Needs a CUDA device and nvcc.

`--sass` first compiles this checkout's kernels/csrc/flash_attention.cu
with the library's flags and -lineinfo into a cubin, and prints, for each
kernel with local-memory traffic, every STL / LDL instruction with the
source line it came from, and for each bf16 kernel the highest register
its code names (a kernel whose code names registers past `-Xptxas -v`'s
count gets them from `setmaxnreg`).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MARK = "flash_ab result: "


def sass(out_dir: pathlib.Path) -> dict:
    """Spills and register use of the flash kernels, read from the SASS."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    src = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / "flash_attention.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-lineinfo", "-cubin", str(src),
                    "-o", str(cubin)], check=True)
    nvdisasm = pathlib.Path(_build._nvcc()).with_name("nvdisasm")
    text = subprocess.run([str(nvdisasm), "-g", "-c", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "flash_attention.sass").write_text(text)
    res, fn, line = {}, None, None
    for ln in text.splitlines():
        m = re.match(r"\.text\.(\S+):", ln)
        if m:
            fn = m.group(1)
            res[fn] = {"max_reg": -1, "local": []}
            continue
        m = re.search(r'line (\d+)', ln) if ln.lstrip().startswith("//##") \
            else None
        if m:
            line = int(m.group(1))
            continue
        if fn is None or "/*" not in ln:
            continue
        regs = [int(r) for r in re.findall(r"\bR(\d+)\b", ln)]
        res[fn]["max_reg"] = max([res[fn]["max_reg"], *regs])
        if re.search(r"\b(STL|LDL)\b", ln):
            res[fn]["local"].append((line, " ".join(ln.split())))
    res = {f: r for f, r in res.items() if "fa_" in f}
    for f, r in res.items():
        print(f"[sass] {f}: highest register R{r['max_reg']}, "
              f"{len(r['local'])} local-memory instructions", flush=True)
        for line, ins in r["local"]:
            print(f"[sass]   flash_attention.cu:{line}: {ins}", flush=True)
    return res


def child(tree: pathlib.Path) -> None:
    """One run in `tree`: prints MARK and a JSON object."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timing = cs.lm_timing_phase(dev, [*cs.LM_FLASH_TIMED,
                                      *cs.LM3_FLASH_TIMED], (), (),
                                tag="ab timing")["flash_attention"]
    def us(ms):
        return None if ms is None else ms * 1e3
    res = {"flash_us": {k: us(r["ms"]) for k, r in timing.items()},
           "sdpa_us": {k: us(r["library_ms"]) for k, r in timing.items()},
           "sdpa_causal_us": {k: us(r.get("library_causal_ms"))
                              for k, r in timing.items()}}
    for arch, prompts, buckets, tag in (
            (cs.LM_ARCH, cs.LM_PROMPTS, cs.LM_BUCKETS, "h2o"),
            (cs.MOE_ARCH, cs.MOE_PROMPTS, cs.MOE_BUCKETS, "moe")):
        cfg = get_config(arch)
        params = LM(cfg).init(
            torch.Generator(device=dev).manual_seed(cs.SEED))
        sv = cs.lm_serve_phase(dev, cfg, params, prompts, buckets,
                               tag=f"{tag} serve")
        prof = cs.lm_profile(sv.pop("engine"), dev, cfg.vocab_size,
                             sv["prefill_ms"]["B=1 S=2048"],
                             sv["decode_step_ms"], tag=f"{tag} bf16")
        res[tag] = {"prefill_ms": sv["prefill_ms"],
                    "decode_step_ms": sv["decode_step_ms"],
                    "busy_ms": {k: p["device_busy_ms"]
                                for k, p in prof.items()}}
        del sv, prof, params
        torch.cuda.empty_cache()
    for arch, tag in ((cs.VLM_ARCH, "vlm"), (cs.AUDIO_ARCH, "audio")):
        out = cs.embed_model_phase(dev, arch, tag)
        res[tag] = {"prefill_ms": out["prefill_ms"],
                    "decode_step_ms": out["decode_step_ms"],
                    "busy_ms": {k: p["device_busy_ms"]
                                for k, p in out["profile"].items()}}
    print(MARK + json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", type=pathlib.Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "chiprun_out" / "flash_ab.json")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--child", type=pathlib.Path, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        child(args.child.resolve())
        return
    result = {}
    if args.sass:
        result["sass"] = sass(ROOT / "build" / "flash_ab")
    if args.before is None:
        print(json.dumps(result))
        return
    trees = {"before": args.before.resolve(), "after": ROOT}
    order = [n for r in range(args.rounds)
             for n in (("before", "after") if r % 2 == 0
                       else ("after", "before"))]
    runs = []
    for name in order:
        p = subprocess.run([sys.executable, __file__, "--child",
                            str(trees[name])], capture_output=True, text=True,
                           cwd=trees[name])
        print(f"[{name}] rc {p.returncode}\n" + "\n".join(
            ln for ln in p.stdout.splitlines()
            if ln.startswith(("[ab timing]", "[h2o serve] prefill",
                              "[h2o serve] decode", "[profile] h2o bf16 1",
                              "[moe serve] prefill",
                              "[moe serve] decode", "[profile] moe bf16 1",
                              "[vlm] qwen", "[audio] music",
                              "[profile] vlm 2", "[profile] audio 2"))),
              flush=True)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], flush=True)
            raise SystemExit(f"the {name} run failed")
        got = [ln for ln in p.stdout.splitlines() if ln.startswith(MARK)]
        runs.append({"tree": name, **json.loads(got[-1][len(MARK):])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result.update(order=order, runs=runs, smi=smi)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
