"""Render the dry run's records (artifacts/dryrun_torch/*.json) as markdown
tables, port of `repro/launch/report.py`.

  PYTHONPATH=src python -m repro_torch.launch.report      # markdown tables

Every time in the tables is derived from the NVIDIA H100 SXM's published
peaks (`launch/roofline.py`), not measured; HBM a rank is set beside
the card's 80 GB.
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.launch.roofline import HBM_BYTES

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"


def load(mesh: str):
    out = []
    for f in sorted(ART.glob(f"*__{mesh}.json")):
        out.append(json.loads(f.read_text()))
    return out


def _hbm(rec) -> str:
    b = rec["memory_analysis"].get("total_hbm_bytes_per_device", 0)
    over = " **over 80 GB**" if b > HBM_BYTES else ""
    return f"{b / 1e9:.2f} GB{over}"


def fmt_table(mesh: str) -> str:
    rows = [
        "| arch | shape | rank | HBM/rank | t_comp (s) | t_mem (s) | "
        "t_coll (s) | bound | roofline frac | useful ratio |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for rec in load(mesh):
        name = f"| {rec['arch']} | {rec['shape']} | {rec.get('rank', '—')} "
        if rec["status"] == "skipped":
            rows.append(name + "| — | — | — | — | skipped (full attention; "
                        "long_500k needs sub-quadratic) | — | — |")
            continue
        if rec["status"] != "ok":
            rows.append(name + f"| FAIL: {rec.get('error', '')[:60]} |")
            continue
        r = rec["roofline"]
        tmax = max(r["t_compute"], r["t_memory"], r["t_collective"])
        frac = r["t_compute"] / tmax if tmax else 0.0
        rows.append(
            name + f"| {_hbm(rec)} | {r['t_compute']:.4f} | "
            f"{r['t_memory']:.4f} | {r['t_collective']:.4f} | "
            f"{r['bottleneck']} | {frac:.3f} | {r['useful_ratio']:.3f} |")
    return "\n".join(rows)


def perf_comparison() -> str:
    """Int8 serving weights (the default) against REPRO_BASELINE=1, where
    both records exist."""
    rows = ["| cell | variant | t_comp | t_mem | t_coll | HBM/rank |",
            "|---|---|---|---|---|---|"]
    for f in sorted(ART.glob("*__single_pod_baseline.json")):
        base = json.loads(f.read_text())
        opt_f = ART / f.name.replace("_baseline", "")
        if not opt_f.exists():
            continue
        opt = json.loads(opt_f.read_text())
        for tag, rec in (("baseline", base), ("optimized", opt)):
            if rec["status"] != "ok":
                continue
            r = rec["roofline"]
            rows.append(
                f"| {rec['arch']} × {rec['shape']} | {tag} | "
                f"{r['t_compute']:.2f} | {r['t_memory']:.2f} | "
                f"{r['t_collective']:.2f} | {_hbm(rec)} |")
    return "\n".join(rows)


def summary():
    print("Times derived from NVIDIA H100 SXM published peaks, not "
          "measured; HBM a rank against the card's 80 GB.")
    for mesh in ("single_pod", "multi_pod"):
        recs = load(mesh)
        ok = [r for r in recs if r["status"] == "ok"]
        print(f"\n## {mesh}: {len(ok)} ok / "
              f"{sum(r['status'] == 'skipped' for r in recs)} skipped / "
              f"{sum(r['status'] == 'FAIL' for r in recs)} fail\n")
        print(fmt_table(mesh))
    print("\n## int8 serving weights against REPRO_BASELINE=1\n")
    print(perf_comparison())


if __name__ == "__main__":
    summary()
