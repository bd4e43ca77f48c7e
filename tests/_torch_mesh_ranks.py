"""Ranks of the port's mesh tests: spawned processes on the CPU, a gloo
world over a `file://` rendezvous (so concurrent test workers never
share a port), each running one job of this module and handing back its
result as a pickle.  Imports torch and the port only, never jax: the
spawned children import this module, not the test files."""
import os
import pickle
import traceback

import multiprocessing as mp
import numpy as np

TIMEOUT_S = 240          # a whole world's run; the collectives' own: 120


def run(world: int, workdir, job: str, payload) -> list:
    """Run `JOBS[job](payload)` on `world` spawned ranks; returns
    their results in rank order.  Any rank's failure (or a hang past
    TIMEOUT_S) fails the caller with the rank's traceback."""
    ctx = mp.get_context("spawn")
    workdir = str(workdir)
    init = os.path.join(workdir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, job, payload, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    outs, errors = [], []
    for r, p in enumerate(procs):
        path = os.path.join(workdir, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append(f"rank {r}: exit code {p.exitcode}, no result"
                          + (" (killed after the timeout)" if r in hung
                             else ""))
            continue
        with open(path, "rb") as f:
            ok, val = pickle.load(f)
        if ok:
            outs.append(val)
        else:
            errors.append(f"rank {r} raised:\n{val}")
    if errors:
        raise AssertionError("\n".join(errors))
    return outs


def _rank_main(rank, world, init, job, payload, workdir):
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as meshlib
    try:
        meshlib.init_ranks("cpu", init_method=f"file://{init}", rank=rank,
                           world_size=world, timeout_s=120)
        res = (True, JOBS[job](payload))
    except BaseException:       # reported to the parent, which fails
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def parse_mesh(spec: str):
    """"N" -> ('model',) of N; "RxC" -> ('data', 'model')."""
    from repro_torch.launch import mesh as meshlib
    if "x" in spec:
        r, c = (int(v) for v in spec.split("x"))
        return meshlib.make_mesh((r, c), ("data", "model"),
                                 ranks=range(r * c))
    return meshlib.make_mesh((int(spec),), ("model",),
                             ranks=range(int(spec)))


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------
def layout(_payload):
    """This rank's coordinates and axis groups on a 2x2 mesh, and on a
    ('model',) mesh of the world's first two ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib
    m = meshlib.make_local_mesh(model=2)
    sub = meshlib.make_mesh((2,), ("model",), ranks=(0, 1))
    summed = torch.full((3,), float(dist.get_rank() + 1))
    m.axis("model").all_reduce(summed)
    got = m.axis("data").broadcast_object({"from": dist.get_rank()}, 1)
    return {"coords": m.coords, "shape": m.shape, "size": m.size,
            "ranks": {a: m.axis(a).ranks for a in m.axis_names},
            "sub": None if sub is None else sub.coords,
            "model_sum": summed.numpy(), "data_bcast": got}


def forward(payload):
    """The sharded TDS forward (fp32, fp32 with overlap, int8 prepared),
    the mesh helpers of `ops`, at a ('model',) mesh of the world."""
    import torch

    from repro_torch.configs import tds_asr as tcfg
    from repro_torch.kernels import ops
    from repro_torch.models import tds
    from repro_torch.parallel import sharding as shlib
    world = torch.distributed.get_world_size()
    mesh = parse_mesh(str(world))
    ax = mesh.axis("model")
    cfg = tcfg.TDSConfig(stages=tuple(tcfg.TDSStage(*s)
                                      for s in payload["stages"]),
                         vocab_size=payload["vocab"])
    full = tds.params_from_numpy(payload["params"])
    params = shlib.shard_tree(full, shlib.tds_param_specs(cfg, mesh), mesh)
    prepared = shlib.shard_tree(tds.quantize_params(full, cfg),
                                shlib.tds_prepared_specs(cfg, mesh), mesh)
    out = {"fc_rows": params["s0b0_fc1"]["w"].shape[0],
           "wq_stride": prepared["s0b0_fc1"]["wq"].stride()}
    for key, (feats, state) in payload["inputs"].items():
        f = torch.from_numpy(feats)
        st = {k: torch.from_numpy(v) for k, v in state.items()}
        lp, ns = tds.forward_batched(params, cfg, f, st, axis=ax)
        out[f"fp32 {key}"] = (_np(lp), {k: _np(v) for k, v in ns.items()})
        lp, _ = tds.forward_batched(params, cfg, f, st, axis=ax,
                                    overlap=True)
        out[f"overlap {key}"] = _np(lp)
        lp, _ = tds.forward_batched(params, cfg, f, st, use_int8=True,
                                    prepared=prepared, axis=ax)
        out[f"int8 {key}"] = _np(lp)
    x, w = (torch.from_numpy(payload[k]) for k in ("x", "w"))
    kloc = w.shape[0] // world
    wloc = w[ax.index * kloc:(ax.index + 1) * kloc]
    xloc = ops.shard_local_cols(x, kloc, ax)
    sync = xloc @ wloc
    ax.all_reduce(sync)
    out["psum sync"] = _np(sync)
    out["psum overlap"] = _np(ops.psum_overlap_matmul(xloc, wloc, ax))
    wq, ws = ops.prepare_int8_weights(torch.from_numpy(payload["w8"]))
    wq_loc = shlib.shard_tree({"wq": wq}, {"wq": ("model", None)},
                              mesh)["wq"]
    x8 = torch.from_numpy(payload["x8"])
    out["int8 product"] = _np(ops.int8_matmul_prepared(x8, wq_loc, ws,
                                                       axis=ax))
    out["int8 product overlap"] = _np(ops.int8_matmul_prepared(
        x8, wq_loc, ws, axis=ax, overlap=True))
    return out


def serve(payload):
    """The demo engine served at each (mesh, int8, overlap) case whose
    mesh spans this world; plus the shard-aligned assembly of slots
    {0, 1, 3} on a 2x1 mesh of 4 slots where the world has 2 ranks."""
    import torch

    from repro_torch.launch.serve import asr_demo_engine
    world = torch.distributed.get_world_size()
    system, utts = payload["system"], payload["utts"]
    out = {}
    meshes = {}
    for spec, int8, overlap in payload["cases"]:
        if spec not in meshes:
            meshes[spec] = parse_mesh(spec)
        eng, _ = asr_demo_engine(payload["n_slots"], device="cpu",
                                 system=system, use_int8=int8,
                                 mesh=meshes[spec], overlap_psum=overlap)
        res = eng.serve(utts)
        out[(spec, int8, overlap)] = {
            "results": res, "step_shapes": list(eng.step_shapes),
            "pool_rows": next(iter(eng._stream_state.values())).shape[0],
            "slot_buckets": eng._slot_buckets}
    if world == 2:
        eng, _ = asr_demo_engine(4, device="cpu", system=system,
                                 mesh=meshes.get("2x1") or parse_mesh("2x1"))
        for s in (0, 1, 3):
            eng.feed_slot(s, np.full((eng._need,), s + 1.0, np.float32))
        batch, idx = eng._assemble_batch([0, 1, 3], 1)
        windows = [eng.slot_windows(s) for s in (0, 1, 3)]
        eng._retire([0, 1, 3], 1)
        out["assemble"] = {"batch": batch, "idx": idx, "before": windows,
                           "after": [eng.slot_windows(s) for s in (0, 1, 3)],
                           "slots_per_shard": eng._slots_per_shard}
    return out


JOBS = {"layout": layout, "forward": forward, "serve": serve}
