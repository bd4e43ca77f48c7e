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


def run(world: int, workdir, job: str, payload, device="cpu") -> list:
    """Run `JOBS[job](payload)` on `world` spawned ranks on `device`
    ("cuda": all on the one card, gloo); returns their results in rank
    order.  Any rank's failure (or a hang past
    TIMEOUT_S) fails the caller with the rank's traceback."""
    ctx = mp.get_context("spawn")
    workdir = str(workdir)
    init = os.path.join(workdir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, job, payload, workdir,
                               device))
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


def _rank_main(rank, world, init, job, payload, workdir, device="cpu"):
    import torch
    torch.set_num_threads(1)
    from repro_torch.device import fp32_numerics
    from repro_torch.launch import mesh as meshlib
    try:
        meshlib.init_ranks(device, init_method=f"file://{init}", rank=rank,
                           world_size=world, timeout_s=120)
        fp32_numerics()
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
    """A numpy copy (the decode step writes its cache in place); bf16
    as fp32."""
    import torch
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


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


def guarded_step(payload):
    """A warmed step of the demo engine on each mesh of `payload["meshes"]`
    (the 2x1 'data'-sharded pool, the 2-rank 'model' contraction) under
    the engine's own guard made strict (`no_implicit_transfers(strict=
    True)`): the number of guarded blocks the engine opened, and the
    slot's words, beside the same steps with the guard taken out."""
    import contextlib
    import functools

    from repro_torch.analysis import guards
    from repro_torch.launch.serve import asr_demo_engine
    from repro_torch.serving import asr as asrmod
    real = asrmod.no_implicit_transfers
    out = {}
    for spec in payload["meshes"]:
        mesh = parse_mesh(spec)
        words = {}
        for strict in (True, False):
            eng, _ = asr_demo_engine(4, device="cpu", mesh=mesh)
            for s in range(4):
                eng.feed_slot(s, payload["utts"][s])
            eng._step_slots([0, 1, 2, 3], 1)            # warm-up
            entered = []

            def guard(strict=strict, entered=entered):
                entered.append(1)
                return (functools.partial(real, strict=True)()
                        if strict else contextlib.nullcontext())
            asrmod.no_implicit_transfers = guard
            try:
                eng._step_slots([0, 1, 2, 3], 1)
            finally:
                asrmod.no_implicit_transfers = real
            words[strict] = [eng.slot_best(s)["words"].tolist()
                             for s in range(4)]
            if strict:
                out[spec] = {"entered": len(entered),
                             "blocks_left": sum(
                                 b for b, _ in guards._owners.values()),
                             "lifts_left": sum(
                                 n for _, n in guards._owners.values())}
        out[spec]["words"] = words[True]
        out[spec]["unguarded_words"] = words[False]
    return out


JOBS = {"layout": layout, "forward": forward, "serve": serve,
        "guarded_step": guarded_step}


# ---------------------------------------------------------------------------
# the LM mesh's jobs
# ---------------------------------------------------------------------------
def _lm_mesh(spec: str):
    """"RxC" -> a ('data', 'model') mesh over the world's first R*C ranks
    (None on the others)."""
    from repro_torch.launch import mesh as meshlib
    r, c = (int(v) for v in spec.split("x"))
    return meshlib.make_mesh((r, c), ("data", "model"), ranks=range(r * c))


def _cfg(payload_cfg):
    import dataclasses

    from repro_torch.configs.base import MoESpec, ModelConfig, SSMSpec
    kw = dict(payload_cfg)
    if kw.get("moe"):
        kw["moe"] = MoESpec(**kw["moe"])
    if kw.get("ssm"):
        kw["ssm"] = SSMSpec(**kw["ssm"])
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in kw.items() if k in names})


def lm_cells(payload):
    """`build_cell` prefill and one decode step of each case (arch, mesh,
    dtype) whose mesh spans this world, on the given parameters' int8
    serving image (each rank keeps its blocks, `shard_tree`): the whole
    logits, the decode tokens and logits, this rank's cache blocks after
    prefill and after the step, and the cache specs."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.treeutil import tree_map
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shlib
    world = torch.distributed.get_world_size()
    plain = KernelPolicy("ref")
    out, meshes = {}, {}
    for case in payload["cases"]:
        spec = case["mesh"]
        if case["world"] != world:
            continue
        if spec not in meshes:      # every rank of the world makes it
            meshes[spec] = _lm_mesh(spec)
        mesh = meshes[spec]
        if mesh is None:            # a mesh of fewer ranks than the world
            continue
        cfg = _cfg(case["cfg"])
        B, S = case["tokens"].shape
        pre = ShapeSpec("p", S, B, "prefill")
        dec = ShapeSpec("d", S, B, "decode")
        fn_p, (p_loc, b_loc) = steps.build_cell(cfg, pre, mesh, policy=plain)
        fn_d, (_, c_loc, d_loc) = steps.build_cell(cfg, dec, mesh,
                                                   policy=plain)
        lm = steps.build_lm(cfg, mesh, plain)
        full = layers.quantize_params_for_serving(tree_map(
            lambda a, d: torch.from_numpy(a).to(getattr(torch, d)),
            case["params"], case["dtypes"]))
        params = shlib.shard_tree(full, lm.param_specs(True), mesh)
        tok = torch.from_numpy(case["tokens"])
        nxt = torch.from_numpy(case["next"])[:, None]
        b_spec = shlib.batch_shardings({"t": tok}, mesh)["t"]
        logits, cache = fn_p(params, {"tokens": shlib.local_block(
            tok, b_spec, mesh)})
        after_prefill = tree_map(_np, cache)
        d_batch = {"tokens": shlib.local_block(nxt, b_spec, mesh)}
        tk, cache2 = fn_d(params, cache, d_batch)
        lm2 = steps.build_lm(cfg, mesh, plain)
        _, cache3 = fn_p(params, {"tokens": shlib.local_block(
            tok, b_spec, mesh)})
        lg, tk2, _ = lm2.decode_step(params, cache3, d_batch,
                                     layout=lm2.layout(dec, int8=True))
        out[case["name"]] = {
            "logits": _np(logits), "dec_logits": _np(lg), "dec_tok": _np(tk),
            "dec_tok2": _np(tk2), "cache_prefill": after_prefill,
            "cache_decode": tree_map(_np, cache2),
            "cache_specs": lm.cache_specs(B, S), "coords": mesh.coords,
            "shapes": (_shapes(params) == _shapes(p_loc)
                       and _shapes(cache) == _shapes(c_loc)
                       and tuple(d_loc["tokens"].shape)
                       == tuple(d_batch["tokens"].shape))}
    return out


def moe_ep(payload):
    """`moe.apply_moe_ep` (through `apply_moe`'s dispatch) on each case
    whose mesh spans this world: this rank's rows of y, aux, the
    candidates dropped at the local capacity, the capacity."""
    import torch

    from repro_torch.configs.base import MoESpec
    from repro_torch.core.treeutil import params_from_numpy
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shlib
    world = torch.distributed.get_world_size()
    out = {}
    for case in payload["cases"]:
        r, c = (int(v) for v in case["mesh"].split("x"))
        if r * c != world:
            continue
        mesh = _lm_mesh(case["mesh"])
        sh = shlib.Sharder(mesh)
        spec = MoESpec(**case["spec"])
        full = params_from_numpy(case["params"])
        # the parameter rules' blocks: experts over 'model' where they
        # divide it, else each expert's d_ff (tensor parallel within)
        if spec.n_experts % mesh.shape["model"] == 0:
            specs = dict.fromkeys(("w_gate", "w_up", "w_down"),
                                  ("model", None, None))
        else:
            specs = {"w_gate": (None, None, "model"),
                     "w_up": (None, None, "model"),
                     "w_down": (None, "model", None)}
        p = {k: shlib.local_block(full[k], sp, mesh)
             for k, sp in specs.items()}
        p["router"] = full["router"]
        x = torch.from_numpy(case["x"])
        xl = shlib.local_block(x, ("data", None, None), mesh)
        moe.drops.clear()
        y, aux = moe.apply_moe(p, xl, spec, "silu", sharder=sh)
        out[case["name"]] = {"y": _np(y), "aux": float(aux),
                             "drops": [int(d) for d in moe.drops],
                             "coords": mesh.coords}
    return out


def decode_attn(payload):
    """`layers.attention_decode_sharded` on this rank's batch rows (over
    'data') and sequence block (over 'model') of each case."""
    import torch

    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shlib
    world = torch.distributed.get_world_size()
    out = {}
    for case in payload["cases"]:
        r, c = (int(v) for v in case["mesh"].split("x"))
        if r * c != world:
            continue
        mesh = _lm_mesh(case["mesh"])
        sh = shlib.Sharder(mesh)
        t = {k: torch.from_numpy(v) for k, v in case["inputs"].items()}

        def rows(a):
            return shlib.local_block(a, ("data",) + (None,) * (a.dim() - 1),
                                     mesh)
        kc, vc = (shlib.local_block(t[k], ("data", "model", None, None),
                                    mesh) for k in ("k", "v"))
        y = layers.attention_decode_sharded(
            rows(t["q"]), kc, vc, rows(t["qpos"]),
            shlib.local_block(t["kpos"], ("model",), mesh),
            window=case["window"], k_new=rows(t["k_new"]),
            v_new=rows(t["v_new"]), sharder=sh)
        out[case["name"]] = {"y": _np(y), "coords": mesh.coords}
    return out


def _shapes(tree) -> dict:
    """{path: shape} of a tree's leaves."""
    from repro_torch.core.treeutil import leaves_with_paths
    return {path: tuple(t.shape) for path, t in leaves_with_paths(tree)}


def lm_kernels(payload):
    """On the card: each case's prefill and one decode step through
    build_cell with the kernels (KernelPolicy("auto")) and with the
    plain versions, on the rank's blocks of one seeded init: the whole
    logits of both paths and the kernel path's launches per cell."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shlib
    dev = torch.device("cuda", 0)
    out = {}
    for name, arch, spec, dtype in payload["cases"]:
        mesh = _lm_mesh(spec)
        cfg = dataclasses.replace(get_config(arch).tiny(), dtype=dtype)
        B, S = payload["batch"], payload["seq"]
        tok = torch.from_numpy(np.random.RandomState(1).randint(
            0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
        nxt = tok[:, :1].clone()
        b_spec = shlib.batch_shardings({"t": tok}, mesh)["t"]
        res = {}
        for path, policy in (("kernel", KernelPolicy("auto")),
                             ("plain", KernelPolicy("ref"))):
            lm = steps.build_lm(cfg, mesh, policy)
            params = lm.init_local(torch.Generator(device=dev).manual_seed(0),
                                   int8=True)
            fn_p, _ = steps.build_cell(cfg, ShapeSpec("p", S, B, "prefill"),
                                       mesh, policy=policy)
            fn_d, _ = steps.build_cell(cfg, ShapeSpec("d", S, B, "decode"),
                                       mesh, policy=policy)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            logits, cache = fn_p(params, {"tokens": shlib.local_block(
                tok, b_spec, mesh)})
            torch.cuda.synchronize()
            n_pre = ops.launch_counts()
            ops.reset_launch_counts()
            tk, _ = fn_d(params, cache, {"tokens": shlib.local_block(
                nxt, b_spec, mesh)})
            torch.cuda.synchronize()
            res[path] = {"logits": _np(logits), "tok": _np(tk),
                         "prefill_launches": n_pre,
                         "decode_launches": ops.launch_counts()}
        out[name] = res
    return out


def collectives(_payload):
    """The LM's `MeshAxis` collectives on a ('data', 'model') mesh of the
    world (2 ranks: 1x2; 4: 2x2), each rank putting in tensors of its
    rank number: all-gather, all-to-all and the MAX
    all-reduce over 'model', an all-gather over ('data', 'model')."""
    import torch

    from repro_torch.launch import mesh as meshlib
    world = torch.distributed.get_world_size()
    mesh = _lm_mesh("1x2" if world == 2 else "2x2")
    me = torch.distributed.get_rank()
    ax = mesh.axis("model")
    t = torch.full((2, 3), float(me)) + torch.arange(3.0)
    out = {"gather": ax.all_gather(t, 1),
           "to_all": ax.all_to_all(torch.arange(4.0).reshape(2, 2) + 10 * me),
           "coords": mesh.coords}
    m = t.clone()
    ax.all_reduce_max(m)
    out["max"] = m
    out["both"] = mesh.axis(("data", "model")).all_gather(
        torch.tensor([float(me)]), 0)
    try:
        meshlib.make_production_mesh()
    except ValueError as e:
        out["production"] = str(e)
    return {k: (_np(v) if hasattr(v, "numpy") else v) for k, v in out.items()}


def lm_mesh(payload):
    """The LM mesh jobs in one world: {job: its results}."""
    return {"collectives": collectives(None),
            "lm_cells": lm_cells(payload["lm_cells"]),
            "moe_ep": moe_ep(payload["moe_ep"]),
            "decode_attn": decode_attn(payload["decode_attn"])}


JOBS.update(lm_mesh=lm_mesh, lm_kernels=lm_kernels)


# ---------------------------------------------------------------------------
# the network server on a mesh: rank 0 serves and leads, the others follow
# ---------------------------------------------------------------------------
SERVE_WATCHDOG_S = 2.0
SERVE_WAIT_S = 30.0           # the longest a scenario's condition waits
KEEPALIVE_CHANNEL_S = 3.0     # the keep-alive scenario's channel timeout
KEEPALIVE_IDLE_S = 2 * KEEPALIVE_CHANNEL_S + 0.5
POISON_SID = 1
# (name, mesh, n_slots, channel timeout): every rank runs them in order
SERVE_SCENARIOS = (("channel", "2x2", 2, 120.0),
                   ("wave 2", "2", 2, 120.0),
                   ("wave 2x2", "2x2", 2, 120.0),
                   ("deadline", "2x2", 2, 120.0),
                   ("watchdog", "2x2", 4, 120.0),
                   ("raise", "2x2", 4, 120.0),
                   ("keepalive", "2", 2, KEEPALIVE_CHANNEL_S),
                   ("in-process deadline", "2", 2, 120.0))


async def _until(pred, what):
    """Await `pred()` (a coroutine function) until it returns something
    true; raise after SERVE_WAIT_S."""
    import asyncio
    loop = asyncio.get_running_loop()
    deadline = loop.time() + SERVE_WAIT_S
    while loop.time() < deadline:
        res = await pred()
        if res:
            return res
        await asyncio.sleep(0.02)
    raise TimeoutError(f"{what} not reached within {SERVE_WAIT_S} s")


async def _client_stream(host, port, audio, stagger=0.0, chunk=3000):
    """Open after `stagger`, then `_drive`."""
    import asyncio

    from repro_torch.serving.server import AsrClient
    await asyncio.sleep(stagger)
    return await _drive(await AsrClient.open(host, port), audio, chunk)


async def _drive(client, audio, chunk=3000):
    """Push `chunk` samples at a time with a poll after each, then
    finish; an in-stream error ends the stream and is its result."""
    for off in range(0, len(audio), chunk):
        for op in (lambda: client.push(audio[off:off + chunk]),
                   client.poll):
            res = await op()
            if res.get("error"):
                await client.aclose()
                return res
    return await client.finish()


async def _sessions(host, port, key):
    from repro_torch.serving.server import fetch_metrics
    return (await fetch_metrics(host, port))["asr"]["sessions"][key]


async def _parked(server):
    """Stop the supervisor, so that a wedged worker stays in place until
    `_unpark`."""
    server._supervisor.cancel()
    try:
        await server._supervisor
    except BaseException:
        pass


def _unpark(server):
    import asyncio
    server._supervisor = asyncio.get_running_loop().create_task(
        server._supervise())


async def _wave(server, ctx):
    import asyncio
    h, p = server.host, server.port
    return {"finals": await asyncio.gather(*[
        _client_stream(h, p, a, 0.01 * i)
        for i, a in enumerate(ctx["utts"][:3])])}


async def _deadline(server, ctx):
    """Three sessions over 2 slots, opened at t = 100, 104 and 106 (the
    third queued), deadline 10 s: the clock moves to 111, 115 and 117,
    each move awaited until /metrics counts the reap; each reaped
    client then sees its fault; a fresh stream serves."""
    from repro_torch.serving.server import AsrClient
    h, p = server.host, server.port
    utts, clk = ctx["utts"], ctx["clock"]
    a = await AsrClient.open(h, p)
    await a.push(utts[0][:2000])
    clk[0] = 104.0
    b = await AsrClient.open(h, p)
    await b.push(utts[1][:2000])
    clk[0] = 106.0
    c = await AsrClient.open(h, p)
    for n, t in enumerate((111.0, 115.0, 117.0), 1):
        clk[0] = t

        async def reaped(n=n):
            return await _sessions(h, p, "deadline_evicted") >= n
        await _until(reaped, f"reap {n}")
    errors = []
    for client in (a, b, c):
        errors.append(await client.push(utts[0][:400]))
        await client.aclose()
    return {"errors": errors,
            "fresh": await _client_stream(h, p, utts[3])}


async def _watchdog(server, ctx):
    """A warm stream; a session in flight; a `pump` stall with the
    supervisor parked until the heartbeat ages past the watchdog
    (/healthz 503), then the restart (/healthz 200), the zombie released;
    the in-flight session's next command sees the quarantine; a fresh
    stream serves."""
    from repro_torch.serving.server import AsrClient, fetch_healthz
    h, p = server.host, server.port
    utts, arm = ctx["utts"], ctx["arm"]
    old = server._asr_worker
    warm = await _client_stream(h, p, utts[0])
    inflight = await AsrClient.open(h, p)
    await inflight.push(utts[1][:3000])
    await _parked(server)
    arm["on"] = True

    async def aged():
        return old.heartbeat_age() > SERVE_WATCHDOG_S
    await _until(aged, "the stalled worker's heartbeat age")
    arm["on"] = False
    wedged, _ = await fetch_healthz(h, p)
    _unpark(server)

    async def replaced():
        return server._asr_worker is not old
    await _until(replaced, "the restart")
    ctx["policy"].release()

    async def healthy():
        st, pl = await fetch_healthz(h, p)
        return (st, pl) if st == 200 else None
    status, payload = await _until(healthy, "/healthz 200")
    quarantined = await inflight.push(utts[1][3000:6000])
    await inflight.aclose()
    return {"warm": warm, "wedged_healthz": wedged, "healthz": status,
            "restarts": payload["engines"]["asr"]["restarts"],
            "quarantined": quarantined,
            "fresh": await _client_stream(h, p, utts[2])}


async def _raise(server, ctx):
    """Four clients opened in order (sids 0-3) stream at once; an
    `asr_step` raise matched on sid POISON_SID."""
    import asyncio

    from repro_torch.serving.server import AsrClient, fetch_healthz
    h, p = server.host, server.port
    clients = [await AsrClient.open(h, p) for _ in range(4)]
    finals = await asyncio.gather(*[_drive(c, a) for c, a in
                                    zip(clients, ctx["utts"])])
    return {"finals": finals,
            "healthz": (await fetch_healthz(h, p))[0]}


async def _keepalive(server, ctx):
    """Idle for twice the channel's timeout, then a stream."""
    import asyncio
    before = dict(server._leader.stats)
    await asyncio.sleep(KEEPALIVE_IDLE_S)
    idle = dict(server._leader.stats)
    return {"before": before, "idle": idle,
            "final": await _client_stream(server.host, server.port,
                                          ctx["utts"][0])}


def _lead(eng, channel, script, ctx):
    import asyncio

    from repro_torch.serving.server import EngineServer

    async def go():
        server = EngineServer(asr_engine=eng, channel=channel,
                              watch_interval=0.05)
        await server.start()
        try:
            res = await script(server, ctx)
        finally:
            await server.aclose(drain=True, timeout=SERVE_WAIT_S)
        res.update(stream=dict(server._leader.stats),
                   restarts=server._restarts["asr"], fatal=server.fatal)
        return res
    return asyncio.run(go())


class _RunawayClock:
    """A clock 1000 s later at every reading: by it, every session is
    overdue as soon as it is looked at."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 1000.0
        return self.t


def _in_process_deadline(eng, rank, ctx):
    """Every rank serves in process under a deadline of 10 s, each
    reading its own clock: rank 0's says 100, then 105, then 111; the
    others' run away (everything overdue, by their own reading).  Only
    rank 0's reading may decide."""
    from repro_torch.serving.engine import DeadlineExceeded
    from repro_torch.serving.metrics import EngineMetrics
    clk = [100.0]
    eng.metrics = EngineMetrics(clock=(lambda: clk[0]) if rank == 0
                                else _RunawayClock())
    a = eng.open().push(ctx["utts"][0][:2000])
    if rank == 0:
        clk[0] = 105.0
    steps = a.poll()["steps"]
    if rank == 0:
        clk[0] = 111.0
    try:
        a.poll()
        reaped = None
    except DeadlineExceeded as exc:
        reaped = exc.sid
    return {"steps_before": steps, "reaped": reaped,
            "fresh": eng.open().push(ctx["utts"][1]).finish()}


def _serve_engine(name, mesh, n_slots, rank, payload):
    """This rank's engine of a scenario, and the script's context."""
    from repro_torch.serving import (AsrEngine, AsrProgram, EngineConfig,
                                     FaultPolicy, FaultSpec)
    from repro_torch.serving.metrics import EngineMetrics
    tds_cfg, feat, lex, lm, dcfg, params = payload["system"]
    ctx = {"utts": payload["utts"]}
    kw = {}
    if name == "deadline":
        kw["session_deadline"] = 10.0
    elif name == "watchdog":
        ctx["arm"] = {"on": False}
        arm = ctx["arm"]
        ctx["policy"] = FaultPolicy(
            [FaultSpec("pump", action="stall", count=1,
                       match=lambda c: arm["on"])], stall_timeout=60.0)
        kw.update(faults=ctx["policy"], worker_watchdog=SERVE_WATCHDOG_S)
    elif name == "raise":
        kw["faults"] = FaultPolicy([FaultSpec(
            "asr_step", count=None, message="poisoned session",
            match=lambda c: POISON_SID in c.get("sids", ()))])
    elif name == "in-process deadline":
        kw["session_deadline"] = 10.0
    program = AsrProgram(tds_cfg, lex, lm, feat, dcfg)
    eng = AsrEngine(EngineConfig(program, n_slots=n_slots, mesh=mesh, **kw),
                    params, device="cpu")
    if name == "deadline":
        # rank 0's clock is the script's; any other rank's runs away, so
        # that by its own reading every session would be overdue
        ctx["clock"] = [100.0]
        clk = ctx["clock"]
        eng.metrics = EngineMetrics(clock=(lambda: clk[0]) if rank == 0
                                    else _RunawayClock())
    return eng, ctx


def serve_mesh(payload):
    """Each scenario of SERVE_SCENARIOS on its mesh of the world's first
    ranks (the rest wait at a barrier): rank 0 serves the scenario's
    engine with an EngineServer leading a command channel and runs its
    client script in process; the others `follow`.  Returns
    {scenario: rank 0's script results or the follower's counts, plus
    the engine's fault log, digest and step counts}."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib
    from repro_torch.serving.server import follow
    rank = dist.get_rank()
    scripts = {"wave 2": _wave, "wave 2x2": _wave, "deadline": _deadline,
               "watchdog": _watchdog, "raise": _raise,
               "keepalive": _keepalive}
    out = {}
    for name, spec, n_slots, timeout in SERVE_SCENARIOS:
        mesh = parse_mesh(spec)
        n = int(np.prod([int(v) for v in spec.split("x")]))
        channel = meshlib.make_channel(range(n), timeout_s=timeout)
        if mesh is not None and name == "channel":
            # pickled to exactly the head buffer's room, and one byte more
            room = meshlib.CHANNEL_HEAD_BYTES - 8
            over = len(pickle.dumps((1, b"x" * 1000))) - 1000
            msgs = [b"x" * 100_000, {"small": 1}, None,
                    b"y" * (room - over), b"z" * (room - over + 1)]
            if rank == 0:
                out[name] = [channel.send(m) for m in msgs]
                out["channel sent"] = msgs
            else:
                out[name] = [channel.recv() for _ in msgs]
        elif mesh is not None:
            eng, ctx = _serve_engine(name, mesh, n_slots, rank, payload)
            if name == "in-process deadline":
                res = _in_process_deadline(eng, rank, ctx)
            elif rank == 0:
                res = _lead(eng, channel, scripts[name], ctx)
            else:
                res = {"follow": follow(eng, channel)}
            res.update(fault_log=list(eng._fault_log), digest=eng._digest(),
                       n_steps=eng.n_steps,
                       slot_steps=eng._slot_steps.tolist())
            out[name] = res
        dist.barrier()
    return out


JOBS["serve_mesh"] = serve_mesh


# ---------------------------------------------------------------------------
# training on the LM mesh
# ---------------------------------------------------------------------------
def _whole(tree, spec_tree, mesh):
    """Every leaf of a rank's tree of blocks gathered whole, as numpy."""
    from repro_torch.core.treeutil import tree_map
    from repro_torch.parallel import sharding as shlib
    return tree_map(lambda t, sp: _np(shlib.gather_dims(t, sp, mesh)), tree,
                    spec_tree)


def train_mesh(payload):
    """Each case whose mesh covers this rank (the world's first ranks; the
    others wait at a barrier): `LM.loss_fn` under the mesh on the rank's
    blocks of the case's parameters and rows of its batch, its value,
    metrics and gradients (completed, `sharding.complete_grads`, then
    gathered whole on every rank); then two steps of `build_cell`'s
    train cell from `adamw.init`'s state, the rank's blocks of the state
    and the metrics after each, and whether the cell's local shapes are
    the state's and the batch's."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.treeutil import tree_map, value_and_grad
    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shlib
    out, meshes = {}, {}
    for case in payload["cases"]:
        spec = case["mesh"]
        if spec not in meshes:      # every rank of the world makes it
            meshes[spec] = _lm_mesh(spec)
        mesh = meshes[spec]
        if mesh is None:
            torch.distributed.barrier()
            continue
        cfg = _cfg(case["cfg"])
        B, S = case["tokens"].shape
        lm = steps.build_lm(cfg, mesh, KernelPolicy("ref"))
        specs = lm.param_specs(False)
        full = tree_map(torch.from_numpy, case["params"])
        params = shlib.shard_tree(full, specs, mesh)
        whole_b = {"tokens": torch.from_numpy(case["tokens"]),
                   "labels": torch.from_numpy(case["labels"])}
        b_spec = shlib.batch_shardings(whole_b, mesh)
        batch = {k: shlib.local_block(v, b_spec[k], mesh)
                 for k, v in whole_b.items()}
        shape = ShapeSpec("t", S, B, "train")
        layout = lm.layout(shape, int8=False)
        (loss, met), grads = value_and_grad(
            lambda p: lm.loss_fn(p, batch, layout=layout), params,
            has_aux=True)
        grads = shlib.complete_grads(grads, specs, mesh, layout["bl"])
        res = {"loss": float(loss),
               "metrics": {k: float(v) for k, v in met.items()},
               "grads": _whole(grads, specs, mesh), "coords": mesh.coords}
        ocfg = adamw.AdamWConfig(moment_dtype=case["moments"])
        fn, (s_loc, b_loc) = steps.build_cell(cfg, shape, mesh, opt_cfg=ocfg)
        o_specs = steps.opt_specs(lm, ocfg)
        state = {"params": params,
                 "opt": adamw.init(params, ocfg, mesh=mesh, specs=o_specs),
                 "step": torch.zeros((), dtype=torch.int32)}
        res["shapes"] = (_shapes(state) == _shapes(s_loc)
                         and _shapes(batch) == _shapes(b_loc))
        res["steps"] = []
        for i in range(2):
            state, met = fn(state, batch)
            res["steps"].append({
                "state": tree_map(_np, state),
                "metrics": {k: float(v) for k, v in met.items()}})
            if i == 0:
                res["whole_after_1"] = {
                    "params": _whole(state["params"], specs, mesh),
                    "opt": {"m": _whole(state["opt"]["m"], o_specs["m"],
                                        mesh),
                            "v": _whole(state["opt"]["v"], o_specs["v"],
                                        mesh),
                            "count": _np(state["opt"]["count"])}}
        res["specs"] = {"params": specs, "opt": o_specs}
        out[case["name"]] = res
        torch.distributed.barrier()
    return out


JOBS["train_mesh"] = train_mesh


def collective_grads(payload):
    """Each differentiable collective of `launch.mesh` inside a small
    computation on a 2-rank world, on the rank's part of the payload's
    whole inputs: the value and the gradients (the test redoes each
    computation whole in one process).  Then each serving collective of
    `MeshAxis` given a tensor that requires grad: the error it raises."""
    import torch

    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import layers
    me = torch.distributed.get_rank()
    t = {k: torch.from_numpy(v) for k, v in payload.items()}
    mm = _lm_mesh("1x2")                    # 'model' over the 2 ranks
    dm = _lm_mesh("2x1")                    # 'data' over the 2 ranks
    ax, bax = mm.axis("model"), dm.axis("data")
    out = {}

    def run(name, fn, *leaves):
        leaves = [x.detach().clone().requires_grad_() for x in leaves]
        val = fn(*leaves)
        gs = torch.autograd.grad(val, leaves)
        out[name] = {"value": float(val), "grads": [_np(g) for g in gs]}

    def blk(x, dim):                        # this rank's block, no graph
        n = x.shape[dim] // 2
        return x.narrow(dim, me * n, n)
    # reduce_from and copy_to: Megatron's MLP, w1 column-, w2 row-split
    run("mlp", lambda x, w1, w2: (meshlib.reduce_from(torch.relu(
        meshlib.copy_to(x, ax) @ w1) @ w2, ax) * t["c"]).sum(),
        t["x"], blk(t["w1"], 1), blk(t["w2"], 0))
    # gather_from (and copy_to): the column-parallel linear
    run("linear_col", lambda x, w: (layers.linear_col(
        {"w": w}, x, t["w1"].shape[1], ax) * t["c1"]).sum(),
        t["x"], blk(t["w1"], 1))
    # split_to: a replicated tensor's block, row-parallel after it
    run("split_to", lambda x, w: (layers.linear_row(
        {"w": w}, meshlib.split_to(x, ax, 1), ax) * t["c2"]).sum(),
        t["x"], blk(t["w3"], 0))
    # all_to_all: each rank's (2, 3, 4), weighted by the rank's own c
    run("all_to_all", lambda a: (meshlib.all_to_all(a, ax)
                                 * t["ca"][me]).sum(), t["a"][me])
    # gather_sum: an FSDP weight, its rows split over 'data'; each data
    # rank its own rows of x; the loss summed over 'data' (reduce_from)
    run("gather_sum", lambda x, w: meshlib.reduce_from(
        (x @ meshlib.gather_sum(w, bax, 0) * blk(t["c1"], 0)).sum(), bax),
        blk(t["x"], 0), blk(t["w1"], 0))
    # gather_from over 'data': a batch whole on both ranks, computing the
    # same on the gathered weight (its gradient: the rank's slice)
    run("gather_from", lambda x, w: (x @ meshlib.gather_from(w, bax, 0)
                                     * t["c1"]).sum(),
        t["x"], blk(t["w1"], 0))
    errors = {}
    g = torch.ones(3, requires_grad=True) * 1.0
    for op, call in (("all_reduce", lambda: ax.all_reduce(g)),
                     ("all_reduce_max", lambda: ax.all_reduce_max(g)),
                     ("all_gather", lambda: ax.all_gather(g, 0)),
                     ("all_to_all", lambda: ax.all_to_all(g[:2]))):
        try:
            call()
            errors[op] = None
        except RuntimeError as e:
            errors[op] = str(e)
    with torch.no_grad():                   # serving: grad mode off
        h = g.detach().clone()
        ax.all_reduce(h)
    out["errors"] = errors
    out["no_grad_sum"] = _np(h)
    out["rank"] = me
    return out


def moe_grads(payload):
    """`moe.apply_moe` on a 2x2 mesh through its GSPMD path (3 experts do
    not split over 'model' = 2: each rank its block of every expert's
    d_ff, and a whole shared expert of an odd d_ff that the rank at index
    0 adds), on the rank's rows of x: the value of sum(y * c) + aux and
    its gradients with respect to x and every parameter block, completed
    over the batch axes (`sharding.complete_grads`) and gathered whole."""
    import torch

    from repro_torch.configs.base import MoESpec
    from repro_torch.core.treeutil import tree_map, value_and_grad
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as shlib
    mesh = _lm_mesh("2x2")
    sh = shlib.Sharder(mesh)
    spec = MoESpec(**payload["spec"])
    specs = payload["specs"]
    full = tree_map(torch.from_numpy, payload["params"])
    params = shlib.shard_tree(full, specs, mesh)
    x = torch.from_numpy(payload["x"])
    c = torch.from_numpy(payload["c"])
    rows = ("data", None, None)
    params["x"] = shlib.local_block(x, rows, mesh).contiguous()
    cl = shlib.local_block(c, rows, mesh)
    bax = sh.batch_axis

    def loss(p):
        lp = tree_map(lambda t, sp: shlib.gather_dims(t, sp, mesh,
                                                      keep=("model",)),
                      {k: v for k, v in p.items() if k != "x"}, specs)
        y, aux = moe.apply_moe(lp, p["x"], spec, "silu", sharder=sh)
        return meshlib.reduce_from((y * cl).sum(), bax) + aux
    val, grads = value_and_grad(loss, params)
    gx = grads.pop("x")
    grads = shlib.complete_grads(grads, specs, mesh, True)
    return {"value": float(val), "x": _np(bax.all_gather(gx, 0)),
            "grads": _whole(grads, specs, mesh), "coords": mesh.coords}


def int8_moments(payload):
    """`adamw`'s int8 moment encoding on a 1x2 mesh, for a whole fp32 m
    whose last dimension (128) splits over 'model': this rank's q and
    scale blocks (`_encode` under the mesh) and the decoded block."""
    import torch

    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shlib
    mesh = _lm_mesh("1x2")
    if mesh is None:
        return None
    m = torch.from_numpy(payload["m"])
    spec = {"q": payload["q_spec"], "scale": payload["scale_spec"]}
    cfg = adamw.AdamWConfig(moment_dtype="int8")
    enc = adamw._encode(shlib.local_block(m, spec["q"], mesh), cfg, spec,
                        mesh)
    return {"q": _np(enc["q"]), "scale": _np(enc["scale"]),
            "decoded": _np(adamw._decode(enc, cfg, spec, mesh)),
            "coords": mesh.coords}


def launcher_fp32(payload):
    """`launch.train.main(payload["args"] + --mesh local --model-parallel
    2)` in this world of 2 ranks on the config in fp32 (its `get_config`
    patched to give fp32 configs): the losses this rank returns."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    train.get_config = lambda arch: dataclasses.replace(get_config(arch),
                                                        dtype="float32")
    return train.main(payload["args"] + ["--mesh", "local",
                                         "--model-parallel", "2"])


def mesh2_world(payload):
    """The jobs of the world of 2 (the launcher twice: without and with a
    checkpoint): {job: its results}."""
    return {"coll": collective_grads(payload["coll"]),
            "launcher": launcher_fp32(payload["launcher"]),
            "launcher_ckpt": launcher_fp32(payload["launcher_ckpt"])}


def train_mesh_world(payload):
    """The train mesh's jobs in one world of 4: {job: its results}."""
    return {"train_mesh": train_mesh(payload["train_mesh"]),
            "moe_grads": moe_grads(payload["moe_grads"]),
            "int8_moments": int8_moments(payload["int8_moments"])}


JOBS.update(mesh2_world=mesh2_world, train_mesh_world=train_mesh_world)


# ---------------------------------------------------------------------------
# the rest of the multi-device layer: compress, pipeline, elastic restart
# ---------------------------------------------------------------------------
def parallel_extras(payload):
    """On a world of 4: `compressed_psum` of each rank's gradient over a
    ('data',) mesh of the world's first 2 ranks and of all 4 (this
    rank's g_hat and new_err); `pipeline_apply` over a ('stage',) mesh
    of 4 for each microbatch count (its output and this rank's stage
    gradient of sum(out ** 2)); the ring shift's values and its
    refusal of a tensor that requires grad."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib
    from repro_torch.parallel import compress, pipeline
    rank = dist.get_rank()
    out = {"rank": rank}
    for n in (2, 4):
        mesh = meshlib.make_mesh((n,), ("data",), ranks=range(n))
        if mesh is None:
            continue
        g = torch.from_numpy(payload["g"][n][rank])
        err = torch.from_numpy(payload["err"][n][rank])
        g_hat, new_err = compress.compressed_psum(g, err, mesh.axis("data"))
        out[f"psum {n}"] = (_np(g_hat), _np(new_err))
    mesh = meshlib.make_mesh((4,), ("stage",))
    ax = mesh.axis("stage")
    w = torch.from_numpy(payload["w"])
    for m, x in payload["x"].items():
        blk = w[rank:rank + 1].clone().requires_grad_()
        y = pipeline.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]),
                                    {"w": blk}, torch.from_numpy(x), mesh)
        (gw,) = torch.autograd.grad((y ** 2).sum(), [blk])
        out[f"pipeline {m}"] = (_np(y), _np(gw))
    t = torch.full((2, 3), float(rank))
    out["shift"] = [_np(ax.ring_shift(t, s)) for s in (1, -1, 2)]
    try:
        ax.ring_shift(t.clone().requires_grad_() * 1.0)
        out["shift refusal"] = None
    except RuntimeError as e:
        out["shift refusal"] = str(e)
    return out


JOBS["parallel_extras"] = parallel_extras


def _state_on(mesh, cfg, ocfg, seed=0):
    """(lm, the rank's blocks of a fresh state, its spec tree) on `mesh`."""
    import torch

    from repro_torch.kernels.policy import KernelPolicy
    from repro_torch.launch import steps
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic
    lm = steps.build_lm(cfg, mesh, KernelPolicy("ref"))
    params = lm.init_local(torch.Generator().manual_seed(seed))
    specs = elastic.state_specs(cfg, mesh, ocfg.moment_dtype)
    state = {"params": params,
             "opt": adamw.init(params, ocfg, mesh=mesh, specs=specs["opt"]),
             "step": torch.zeros((), dtype=torch.int32)}
    return lm, state, specs


def _train_steps(lm, ocfg, mesh, state, start, n, batch, seq):
    """`n` train steps from `start` on the rank's rows of SyntheticLM's
    batches; (state, the last step's loss)."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shlib
    step = steps.make_train_step(lm, ocfg,
                                 shape=ShapeSpec("t", seq, batch, "train"))
    data = SyntheticLM(DataConfig(lm.cfg.vocab_size, seq, batch))
    b_spec = shlib.batch_shardings(
        {"x": torch.empty((batch,), device="meta")}, mesh)["x"]
    loss = None
    for s in range(start, start + n):
        b = {k: shlib.local_block(torch.from_numpy(v), b_spec + (None,),
                                  mesh).contiguous()
             for k, v in data.batch(s).items()}
        state, met = step(state, b)
        loss = float(met["loss"])
    return state, loss


def _sub_meshes(shape, names):
    """The mesh `shape` over ranks (0, 1) and over ranks (2, 3) of a world
    of 4: (this rank's, whether it is the first)."""
    from repro_torch.launch import mesh as meshlib
    a = meshlib.make_mesh(shape, names, ranks=(0, 1))
    b = meshlib.make_mesh(shape, names, ranks=(2, 3))
    return (a, True) if a is not None else (b, False)


def elastic_world(payload):
    """The elastic restart's scenarios in one world of 4 (tiny config in
    fp32, AdamW at lr 3e-4, SyntheticLM batches of (8, 32)):

      * phase 1 on `build_mesh(plan_remesh(4, 2, 8))` (2x2): 4 steps,
        saved at steps 2 and 4;
      * ranks (0, 1) on `plan_remesh(2, 2, 8)` (1x2): resume step 4
        through `replace_state` and take 2 steps, then the control
        (step 2's checkpoint taken for step 4); meanwhile ranks (2, 3)
        run a straight 6 steps on their own 1x2 mesh;
      * checkpoints for the reference: one step on 1x2 (ranks 0, 1) and
        on 2x1 (ranks 2, 3), fp32 and int8 moments, saved, with the
        state gathered whole;
      * the reference's checkpoints (fp32 and int8 moments) restored on
        2x2, then on 1x2 (ranks 0, 1) and 2x1 (ranks 2, 3): this rank's
        blocks;
      * `run_resilient`'s restore escalation on 1x2: every rank raises
        TransientError twice at step 3 (ranks 0, 1), against the same
        run uninterrupted (ranks 2, 3).
    Returns {scenario: results}; whole trees on their mesh's rank 0."""
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.core.treeutil import tree_map
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic, fault
    rank = dist.get_rank()
    cfg = _cfg(payload["cfg"])
    B, S = payload["batch"], payload["seq"]
    ocfg = adamw.AdamWConfig(lr=3e-4)
    ck1 = payload["dir"] + "/elastic"
    out = {"rank": rank}

    # phase 1: 2x2, 4 steps, saved at 2 and 4
    plan = elastic.plan_remesh(4, model_parallel=2, global_batch=B)
    mesh4 = elastic.build_mesh(plan)
    lm, state, specs = _state_on(mesh4, cfg, ocfg)
    ck = Checkpointer(ck1, mesh=mesh4, specs=specs)
    state, _ = _train_steps(lm, ocfg, mesh4, state, 0, 2, B, S)
    ck.save(2, state)
    state, loss = _train_steps(lm, ocfg, mesh4, state, 2, 2, B, S)
    ck.save(4, state)
    out["phase 1"] = {"plan": plan, "coords": mesh4.coords, "loss": loss}

    # phase 2 on 1x2 (ranks 0, 1) and the straight run (ranks 2, 3)
    plan2 = elastic.plan_remesh(2, model_parallel=2, global_batch=B)
    mesh, first = _sub_meshes(plan2.shape(), plan2.axis_names())
    lm, tmpl, specs = _state_on(mesh, cfg, ocfg, seed=1)
    runs = ((("resumed", 4), ("control", 2)) if first
            else (("straight", None),))
    for name, saved in runs:
        if saved is None:
            st, loss = _train_steps(lm, ocfg, mesh, _state_on(
                mesh, cfg, ocfg)[1], 0, 6, B, S)
        else:
            st = elastic.replace_state(cfg, Checkpointer(ck1), tmpl, mesh,
                                       step=saved)
            st, loss = _train_steps(lm, ocfg, mesh, st, 4, 2, B, S)
        whole = _whole(st["params"], specs["params"], mesh)
        out[name] = {"loss": loss, "plan": plan2,
                     "params": whole if mesh.rank in (0, 2) else None}
    dist.barrier()

    # checkpoints for the reference: 1x2 on (0, 1), 2x1 on (2, 3)
    from repro_torch.launch import mesh as meshlib
    a = meshlib.make_mesh((1, 2), ("data", "model"), ranks=(0, 1))
    b = meshlib.make_mesh((2, 1), ("data", "model"), ranks=(2, 3))
    sub, name = (a, "1x2") if a is not None else (b, "2x1")
    for moments in ("float32", "int8"):
        oc = adamw.AdamWConfig(lr=3e-4, moment_dtype=moments)
        lm, st, specs = _state_on(sub, cfg, oc)
        st, _ = _train_steps(lm, oc, sub, st, 0, 1, B, S)
        d = payload["dir"] + f"/to_ref_{name}_{moments}"
        Checkpointer(d, mesh=sub, specs=specs).save(1, st)
        whole = _whole(st, specs, sub)
        out[f"to ref {name} {moments}"] = {
            "dir": d, "whole": whole if sub.rank in (0, 2) else None}
    dist.barrier()

    # the reference's checkpoints on phase 1's 2x2 mesh, then on 1x2
    # (ranks 0, 1) and 2x1 (ranks 2, 3)
    for target, tname in ((mesh4, "2x2"), (sub, name)):
        for moments in ("float32", "int8"):
            oc = adamw.AdamWConfig(lr=3e-4, moment_dtype=moments)
            lm, tmpl, specs = _state_on(target, cfg, oc, seed=1)
            st = elastic.replace_state(cfg, Checkpointer(
                payload["from_ref"][moments]), tmpl, target)
            out[f"from ref {tname} {moments}"] = {
                "blocks": tree_map(_np, st), "specs": specs,
                "coords": target.coords, "shape": target.shape,
                "same_dtype": tree_map(lambda x, y: x.dtype == y.dtype, st,
                                       tmpl)}

    # run_resilient's restore escalation on 1x2
    mesh, first = _sub_meshes(plan2.shape(), plan2.axis_names())
    lm, st, specs = _state_on(mesh, cfg, ocfg)
    ck = Checkpointer(payload["dir"] + f"/escalation_{int(first)}",
                      mesh=mesh, specs=specs)
    failures = {"left": 2 if first else 0}

    def one_step(state, step):
        if step == 3 and failures["left"]:
            failures["left"] -= 1
            raise fault.TransientError("every rank at step 3")
        return _train_steps(lm, ocfg, mesh, state, step, 1, B, S)[0], {}
    st, stats = fault.run_resilient(one_step, st, 0, 5, checkpointer=ck,
                                    ckpt_every=2)
    whole = _whole(st, specs, mesh)
    out["escalation" if first else "uninterrupted"] = {
        "stats": stats, "steps": ck.all_steps(),
        "state": whole if mesh.rank in (0, 2) else None}
    return out


JOBS["elastic_world"] = elastic_world


# ---------------------------------------------------------------------------
# the dry run's collective record against a real world's
# ---------------------------------------------------------------------------
def materialize(tree, seed: int = 0):
    """Tensors of the meta shapes and dtypes of a tree: small seeded
    floats, zero integers (tokens, labels, int8 payloads, the step)."""
    import torch

    from repro_torch.core.treeutil import tree_map
    gen = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=gen)).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    return tree_map(one, tree)


def collective_log(payload):
    """Each (arch, kind, B, S) cell of `payload` built with `build_cell`
    on the world's ('data', 'model') mesh of `payload["mesh"]` and
    called once on seeded tensors of its argument shapes, under
    `count_collectives`: this rank's log as (kind, bytes, axis, size,
    ranks) tuples, by cell."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import steps
    mesh = _lm_mesh(payload["mesh"])
    out = {"coords": mesh.coords, "rank": mesh.rank,
           "axes": {str(k): (a.name, a.size, a.index, a.ranks)
                    for k, a in mesh.axes.items()}}
    for arch, kind, B, S in payload["cells"]:
        cfg = get_config(arch).tiny()
        fn, args = steps.build_cell(cfg, ShapeSpec("x", S, B, kind), mesh)
        real = tuple(materialize(a) for a in args)
        with meshlib.count_collectives() as log:
            fn(*real)
        out[f"{arch} {kind}"] = [tuple(c) for c in log]
    return out


JOBS["collective_log"] = collective_log
