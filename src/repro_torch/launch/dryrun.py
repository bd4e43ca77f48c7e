"""Multi-pod dry run, port of `repro/launch/dryrun.py`: count one rank of
every (arch x shape x mesh) cell against an H100's roofline.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's program.  The port has no compiler to ask, so
`run_cell` builds the cell with `launch/steps.build_cell` on a dry
production mesh (`launch.mesh.make_production_mesh(dry_rank=...)`: one
rank's view of the (16, 16) or (2, 16, 16) mesh, whose collectives
record themselves and send nothing), on meta tensors (the rank's blocks
of the parameters, optimizer state, cache and batch), and runs one call
of the cell's function under `launch/op_cost.OpCounter`: the plain ops
counted op by op, the kernel wrappers by their formulas (the serving
cells' default policy launches them on the card).  Nothing is
allocated: it needs no world of ranks and no GPU.  It is a planning
tool: what a rank of each cell computes, moves and holds, and which
term bounds it on an H100.

Which rank: the reference's SPMD program is the same on every device.
The port's ranks can differ: where the kv heads do not divide 'model'
(qwen2-72b's 8 over 16) the prefill attention splits the queries into
blocks, and rank i attends to keys up to its own block only.  So a cell
is evaluated on the **last rank** (the highest index on every axis: the
longest causal prefix, the rank that sets the pace) unless `rank` says
otherwise; the record names its rank and coordinates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                  # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi_pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
      --shape prefill_32k --mesh single_pod --rank 0
Records land in artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json (a
rank other than the last adds _rank<r> to the mesh's name) and feed
`launch/report.py`.  Every time in them is derived from the NVIDIA H100
SXM's published peaks (`launch/roofline.py`), not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback

from repro_torch.configs import ASSIGNED_ARCHS, LM_SHAPES, get_config
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell

ART = pathlib.Path(__file__).resolve().parents[3] / "artifacts" / \
    "dryrun_torch"
PEAKS = ("derived from NVIDIA H100 SXM published peaks (launch/roofline.py), "
         "not measured")


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             rank: int | None = None, save: bool = True,
             extra: dict | None = None, baseline: bool = False) -> dict:
    if baseline:
        os.environ["REPRO_BASELINE"] = "1"
        mesh_name_out = mesh_name + "_baseline"
    else:
        os.environ.pop("REPRO_BASELINE", None)
        mesh_name_out = mesh_name
    cfg = get_config(arch)
    shape = {s.name: s for s in LM_SHAPES}[shape_name]
    n_dev = 512 if mesh_name == "multi_pod" else 256
    last = n_dev - 1
    if rank is not None and rank != last:
        mesh_name_out += f"_rank{rank}"
    rank = last if rank is None else rank
    if shape in cfg.skipped_shapes():
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name_out,
               "status": "skipped", "rank": rank,
               "reason": "full-attention arch; long_500k requires "
                         "sub-quadratic attention (see DESIGN.md)"}
        if save:
            _save(rec)
        return rec

    mesh = make_production_mesh(multi_pod=(mesh_name == "multi_pod"),
                                dry_rank=rank)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name_out,
           **count_cell(cfg, shape, mesh)}
    if extra:
        rec.update(extra)
    if save:
        _save(rec)
    return rec


def count_cell(cfg, shape, mesh) -> dict:
    """The record of one cell (`build_cell(cfg, shape, mesh)`, called
    once under an `OpCounter`) on `mesh`'s rank: status "ok" with the
    counts, memory, roofline and collectives, or "FAIL" with the
    error."""
    t0 = time.time()
    try:
        fn, args = build_cell(cfg, shape, mesh)
        t_build = time.time() - t0
        out, counter = op_cost.count(fn, *args)
        t_count = time.time() - t0 - t_build
        mem = memory(args, out, counter)
        roof = rl.analyze(counter.cost, mesh.size,
                          rl.model_flops(cfg, shape),
                          peak_bytes=mem["total_hbm_bytes_per_device"])
        coll = rl.collective_bytes(counter.collectives)
        return {
            "status": "ok", "n_devices": mesh.size, "rank": mesh.rank,
            "coords": mesh.coords,
            "build_s": round(t_build, 1), "count_s": round(t_count, 1),
            "memory_analysis": mem,
            "hbm_fits": mem["total_hbm_bytes_per_device"] <= rl.HBM_BYTES,
            "roofline": roof.asdict(),
            "collectives": {k: coll[k] for k in rl.COLLECTIVES + ("total",)},
            "collective_counts": coll["counts"],
            "kernel_ops": dict(counter.kernel_ops),
            "flops_by_op": dict(counter.flops_by_op),
            "peaks": PEAKS,
        }
    except Exception as e:  # a failure here is a bug in the port's cell
        return {"status": "FAIL", "rank": mesh.rank,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def _storages(tree) -> dict:
    """{storage key: bytes} of a tree's tensors (a view shares its
    base's storage)."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in op_cost.tensors(tree)}


def memory(args, out, counter) -> dict:
    """The reference's memory fields for one call: the arguments' bytes
    (the rank's blocks, exact from their shapes), the outputs', the
    temporaries' (the peak of the bytes alive of the storages the call
    created, less the outputs it created) and the outputs that alias
    an argument (a cache written in place), so that
    total = arguments + outputs + temporaries - aliased is the call's
    high-water mark."""
    a, o = _storages(args), _storages(out)
    alias = sum(n for k, n in o.items() if k in a)
    created = sum(o.values()) - alias
    rec = {"argument_size_in_bytes": sum(a.values()),
           "output_size_in_bytes": sum(o.values()),
           "temp_size_in_bytes": counter.peak_bytes - created,
           "alias_size_in_bytes": alias}
    rec["total_hbm_bytes_per_device"] = (
        rec["argument_size_in_bytes"] + rec["output_size_in_bytes"]
        + rec["temp_size_in_bytes"] - rec["alias_size_in_bytes"])
    return rec


def _save(rec: dict):
    ART.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (ART / name).write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default=None,
                    choices=[None, "single_pod", "multi_pod"])
    ap.add_argument("--rank", type=int, default=None,
                    help="the rank to evaluate (default: the last, the "
                         "longest causal prefix)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--baseline", action="store_true",
                    help="serve on the weights' own dtype, not int8 "
                         "(REPRO_BASELINE=1); saves to "
                         "*_<mesh>_baseline.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]
    meshes = [args.mesh] if args.mesh else ["single_pod", "multi_pod"]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                out = ART / f"{arch}__{shape}__{mesh}.json"
                if args.skip_existing and args.rank is None \
                        and not args.baseline and out.exists():
                    old = json.loads(out.read_text())
                    if old.get("status") in ("ok", "skipped"):
                        print(f"[skip-existing] {arch} {shape} {mesh}")
                        continue
                t0 = time.time()
                rec = run_cell(arch, shape, mesh, rank=args.rank,
                               baseline=args.baseline)
                dt = time.time() - t0
                status = rec["status"]
                n_fail += status == "FAIL"
                msg = (f"[{status}] {arch} {shape} {rec['mesh']} rank "
                       f"{rec['rank']} ({dt:.0f}s)")
                if status == "ok":
                    r = rec["roofline"]
                    hbm = rec["memory_analysis"][
                        "total_hbm_bytes_per_device"] / 1e9
                    msg += (f" bottleneck={r['bottleneck']}"
                            f" t=({r['t_compute']:.3f},{r['t_memory']:.3f},"
                            f"{r['t_collective']:.3f})s hbm={hbm:.2f}GB"
                            f" of {rl.HBM_BYTES / 1e9:.0f}")
                elif status == "FAIL":
                    msg += " " + rec["error"][:300]
                print(msg, flush=True)
    print(f"done. failures={n_fail} (times {PEAKS})")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
