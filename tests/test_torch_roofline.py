"""The port's dry-run and roofline tooling on the CPU: the op counter
(`launch/op_cost.py`, the counterpart of `repro/launch/hlo_cost.py`),
`launch/roofline.py`, `launch/dryrun.py` and `launch/report.py`.

  * the counter against hand counts, as `tests/test_hlo_cost.py` holds
    the reference's walker: a loop-free product chain exactly, Python
    loops (no trip-count correction needed), bytes of an elementwise op
    and of a view, a kernel wrapper as one fused op of its formula,
    dtype buckets, the peak of live bytes;
  * `model_flops` equal to the reference's for every arch and shape;
  * the collective record of a real gloo world of 4 ranks at (2, 2)
    equal, entry for entry, to the dry mesh's on every rank;
  * FLOPs a rank against the reference's loop-corrected HLO walker on
    the same tiny cells at (2, 2), compiled in a JAX subprocess on 4
    forced host devices with Auto axes (jax 0.9's Explicit default
    breaks the reference's `Sharder`; ROADMAP Queue 3).  Two
    differences are named and computed, both in the attention; every
    other product agrees exactly:
      - prefill: the reference's chunked attention computes every
        (q, kv) tile, masked ones included; the port's flash kernel
        counts the pairs its mask keeps (`kernels.cost.attn_pairs`).
        Difference: 4·D·H·B·(Sq·Skv − pairs) a layer (H, B the rank's).
      - train: the reference's attention sits under two nested
        `jax.checkpoint`s (its q-block and kv-step scans), so its
        backward recomputes each layer's score tiles twice more and
        its P·V once more than the port's plain attention under the
        layer's checkpoint alone.  Difference: 3 · 2·Sq·Skv·D·H·B a
        layer.
    With them added back, the totals agree within 1%; the decode cell
    agrees within 1% as it is;
  * every arch × {prefill, decode, train} dry at tiny size on a (2, 2)
    mesh (the decode and MoE cells pin the two repairs: a 0-d index
    and `bincount` read a value back to the host, and fail on meta);
  * ranks that differ (the query-block split) and the default rank;
  * argument bytes equal to the sum of the rank's blocks;
  * the report on synthetic records; one full-size cell in process.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import LM_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES,  # noqa: E402
                                 get_config)
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import cost as kcost, ops  # noqa: E402
from repro_torch.kernels.policy import KernelPolicy  # noqa: E402
from repro_torch.launch import (dryrun, mesh as meshlib,  # noqa: E402
                                op_cost, report, roofline, steps)
from repro_torch.models import layers  # noqa: E402
from repro_torch.parallel import sharding as shlib  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = dict(device="meta")
NAMES = ("data", "model")
# the parity cells (arch, kind, B, S): heads (4 / 2 kv of 16) divide
# 'model' = 2; h2o-danube's prefill at S = 128 masks a window of 64
PARITY = (("qwen2-72b", "prefill", 4, 64), ("qwen2-72b", "decode", 4, 64),
          ("qwen2-72b", "train", 4, 64), ("h2o-danube-1.8b", "prefill", 4,
                                          128))
WORLD_CELLS = (("qwen2-72b", "prefill", 4, 64), ("qwen2-72b", "train", 4, 64))
PARITY_RTOL = 0.01

JAX_HLO = textwrap.dedent("""
    import collections, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec
    from repro.launch import hlo_cost as hc
    from repro.launch.steps import build_cell

    def dots(hlo):
        # (all dots' operations, those of dots with outputs of rank >= 3:
        # the attention's batched tiles), each times its enclosing trips
        comps, entry = hc.parse_computations(hlo)
        mult = collections.Counter()
        def walk(c, m):
            mult[c] += m
            for i in comps.get(c, []):
                trip = 1
                if i["op"] == "while":
                    t = hc._TRIP.search(i["rest"])
                    trip = int(t.group(1)) if t else 1
                for callee in hc._CALLS.findall(i["rest"]):
                    walk(callee, m * trip)
        walk(entry, 1)
        total = attn = 0.0
        for c, instrs in comps.items():
            sym = {i["name"]: i["sig"] for i in instrs}
            for i in instrs:
                if i["op"] == "dot":
                    f = hc._dot_flops(i, sym) * mult[c]
                    total += f
                    if len(hc._shape_dims(i["sig"])) >= 3:
                        attn += f
        return total, attn

    out = {}
    for arch, kind, B, S in json.loads(sys.argv[1]):
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        with mesh:
            jfn, args = build_cell(get_config(arch).tiny(),
                                   ShapeSpec("x", S, B, kind), mesh)
            hlo = jfn.lower(*args).compile().as_text()
        total, attn = dots(hlo)
        out[f"{arch} {kind}"] = {"flops": hc.analyze_hlo(hlo, 4).flops,
                                 "dots": total, "attn": attn}
    print("JAX_HLO_OK " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_hlo():
    """The reference's cells compiled on 4 forced host devices: one
    subprocess, started first and awaited when a test needs it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_HLO, json.dumps(PARITY)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    box = {}

    def result():
        if not box:
            out, err = proc.communicate(timeout=600)
            assert "JAX_HLO_OK" in out, out + err[-3000:]
            box.update(json.loads(out.split("JAX_HLO_OK ", 1)[1]))
        return box
    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, **META)


def _cell(arch, kind, B, S, mesh):
    cfg = get_config(arch).tiny()
    return dryrun.count_cell(cfg, ShapeSpec("x", S, B, kind), mesh)


# ---------------------------------------------------------------------------
# the counter against hand counts
# ---------------------------------------------------------------------------
def test_loop_free_chain_counts_exactly():
    def f(x, w1, w2):
        return torch.tanh(x @ w1) @ w2
    _, c = op_cost.count(f, *(_meta(256, 256) for _ in range(3)))
    assert c.cost.flops == {"bf16": 0.0, "fp32": 2 * 2 * 256 ** 3,
                            "int8": 0.0}
    # mm, tanh, mm: each reads its inputs and writes its output once
    assert c.cost.bytes == (3 + 2 + 3) * 256 * 256 * 4


def test_python_loops_count_every_trip():
    def loop(x, w):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def nested(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x
    _, c = op_cost.count(loop, _meta(128, 128), _meta(128, 128))
    assert c.cost.total_flops == 8 * 2 * 128 ** 3
    _, c = op_cost.count(nested, _meta(128, 128), _meta(128, 128))
    assert c.cost.total_flops == 12 * 2 * 128 ** 3


def test_elementwise_bytes_and_views():
    x = _meta(64, 32)
    _, c = op_cost.count(torch.exp, x)
    assert c.cost.bytes == 2 * 64 * 32 * 4 and c.cost.total_flops == 0
    _, c = op_cost.count(lambda t: t.view(32, 64).t()[1:], x)
    assert c.cost.bytes == 0
    # an expanded operand is read once: its 32 distinct elements
    _, c = op_cost.count(lambda t, b: t + b.expand(64, 32), x, _meta(32))
    assert c.cost.bytes == (2 * 64 * 32 + 32) * 4


def test_flash_attention_is_one_op_of_its_pairs():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 256, 16), generator=gen)
    k, v = (torch.randn((1, 2, 256, 16), generator=gen) for _ in range(2))
    out, c = op_cost.count(ops.flash_attention, q, k, v, causal=True)
    pairs = 256 * 257 // 2
    assert kcost.attn_pairs(256, 256, None) == pairs
    assert c.kernel_ops == {"flash_attention": 1}
    assert c.flops_by_op == {"flash_attention": 4 * 16 * 4 * pairs}
    assert c.cost.flops["fp32"] == 4 * 16 * 4 * pairs
    assert c.cost.bytes == 4 * (2 * q.numel() + 2 * k.numel())
    np.testing.assert_array_equal(out, ops.flash_attention(q, k, v))
    # the plain policy launches nothing: its ops are counted as they run
    _, c = op_cost.count(ops.flash_attention, q, k, v, causal=True,
                         policy=KernelPolicy("ref"))
    assert c.kernel_ops == {} and c.flops_by_op.get("aten.bmm", 0) > 0


def test_flops_land_in_their_dtype_buckets():
    bf = _meta(32, 64, dtype=torch.bfloat16)
    _, c = op_cost.count(lambda a, b: a @ b, bf, _meta(64, 16,
                                                      dtype=torch.bfloat16))
    assert c.cost.flops == {"bf16": 2 * 32 * 64 * 16, "fp32": 0.0,
                            "int8": 0.0}
    x = torch.randn((8, 64))
    wq, ws = ops.prepare_int8_weights(torch.randn((64, 32)))
    _, c = op_cost.count(ops.int8_matmul_prepared, x, wq, ws)
    assert c.kernel_ops == {"int8_matmul": 1}
    assert c.cost.flops == {"bf16": 0.0, "fp32": 0.0, "int8": 2 * 8 * 64 * 32}


def test_peak_bytes_follow_storage_lifetimes():
    def f(x):
        a = x * 2
        b = a + 1
        del a
        c = b.view(-1) * 3          # b's view adds nothing
        return c
    _, c = op_cost.count(f, _meta(1000))
    assert c.peak_bytes == 2 * 4000
    # an in-place op on the argument creates nothing
    _, c = op_cost.count(lambda x: x.mul_(2), _meta(1000))
    assert c.peak_bytes == 0 and c.cost.bytes == 2 * 4000


def test_collective_bytes_ring_factors_and_links():
    C = meshlib.Collective
    log = [C("all-reduce", 64 * 64 * 4, "model", 8, tuple(range(8))),
           C("all-gather", 1000, "data", 2, (0, 8)),
           C("collective-permute", 10, "model", 8, tuple(range(8))),
           C("all-reduce", 500, "x", 1, (3,))]
    out = roofline.collective_bytes(log)
    ar = 64 * 64 * 4 * 2 * 7 / 8
    assert out["all-reduce"] == ar and out["all-gather"] == 500
    assert out["collective-permute"] == 10
    assert out["counts"]["all-reduce"] == 1
    assert out["total"] == ar + 510
    # ranks 0-7 share a node (NVLink), ranks 0 and 8 do not (InfiniBand)
    assert out["seconds"] == pytest.approx(
        (ar + 10) / roofline.NVLINK_BW + 500 / roofline.IB_BW)


# ---------------------------------------------------------------------------
# model_flops, the dry mesh, every arch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_model_flops_match_the_reference(arch):
    ref_shapes = {s.name: s for s in REF_SHAPES}
    for shape in LM_SHAPES:
        assert roofline.model_flops(get_config(arch), shape) == \
            ref_roofline.model_flops(ref_get_config(arch),
                                     ref_shapes[shape.name])


def test_dry_production_mesh_is_a_real_ranks_view():
    m = meshlib.make_production_mesh(multi_pod=True, dry_rank=300)
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.coords == {"pod": 1, "data": 2, "model": 12}
    assert m.axis("model").ranks == tuple(range(288, 304))
    assert m.axis(("data", "model")).size == 256
    assert all(isinstance(a, meshlib.DryAxis) for a in m.axes.values())
    with pytest.raises(ValueError, match="rank 512"):
        meshlib.make_production_mesh(multi_pod=True, dry_rank=512)


@pytest.mark.parametrize("kind", ("prefill", "decode", "train"))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_tiny_cell_runs_dry(arch, kind):
    rec = _cell(arch, kind, 4, 64, meshlib.make_dry_mesh((2, 2), NAMES, 3))
    assert rec["status"] == "ok", rec.get("traceback")
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["memory_analysis"]["total_hbm_bytes_per_device"] > 0
    if kind != "train":        # the serving cells launch the norm kernel
        assert rec["kernel_ops"].get("rmsnorm", 0) + rec["kernel_ops"].get(
            "layernorm", 0) > 0


def test_argument_bytes_are_the_rank_blocks():
    cfg = get_config("qwen2-72b").tiny()
    mesh = meshlib.make_dry_mesh((2, 2), NAMES, 1)
    rec = dryrun.count_cell(cfg, ShapeSpec("x", 64, 4, "prefill"), mesh)
    lm = steps.build_lm(cfg, mesh)
    p = layers.quantize_params_for_serving(lm.param_shapes())
    whole = {"params": p, "batch": steps.input_specs(cfg, ShapeSpec(
        "x", 64, 4, "prefill"))}
    specs = {"params": lm.param_specs(True),
             "batch": shlib.batch_shardings(whole["batch"], mesh)}
    want = 0
    for path, leaf in _leaves(whole):
        blk = shlib.local_block(leaf, _at(specs, path), mesh)
        want += blk.numel() * blk.element_size()
    assert rec["memory_analysis"]["argument_size_in_bytes"] == want
    assert rec["memory_analysis"]["alias_size_in_bytes"] == 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_ranks_differ_where_the_queries_split():
    """qwen2-72b's tiny 2 kv heads do not divide 'model' = 4: rank i of
    'model' attends its 16 query rows to keys [0, 16 (i + 1)) only."""
    recs = [_cell("qwen2-72b", "prefill", 2, 64,
                  meshlib.make_dry_mesh((1, 4), NAMES, r)) for r in (0, 3)]
    flash = [r["flops_by_op"]["flash_attention"] for r in recs]
    cfg = get_config("qwen2-72b").tiny()
    per = 4 * cfg.head_dim * cfg.n_heads * 2 * cfg.n_layers
    assert flash == [per * kcost.attn_pairs(16, 16 * (i + 1), None)
                     for i in (0, 3)]
    assert flash[1] > flash[0]
    rest = [r["roofline"]["flops_per_device"] - f
            for r, f in zip(recs, flash)]
    assert rest[0] == rest[1]


def test_full_size_cell_in_process_on_the_last_rank():
    rec = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", "single_pod",
                          save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["rank"] == 255 and rec["coords"] == {"data": 15, "model": 15}
    assert rec["mesh"] == "single_pod" and rec["n_devices"] == 256
    cfg = get_config("h2o-danube-1.8b")
    assert rec["kernel_ops"] == {"rmsnorm": 2 * cfg.n_layers + 1}
    r = rec["roofline"]
    assert r["t_compute"] > 0 and r["t_memory"] > 0 and r["t_collective"] > 0
    assert rec["hbm_fits"]
    assert rec["build_s"] + rec["count_s"] < 60
    skipped = dryrun.run_cell("qwen2-72b", "long_500k", "multi_pod",
                              save=False)
    assert skipped["status"] == "skipped" and skipped["rank"] == 511


def test_report_renders_ok_skipped_and_failed_records(tmp_path, monkeypatch):
    monkeypatch.setattr(report, "ART", tmp_path)
    ok = dryrun.run_cell("h2o-danube-1.8b", "decode_32k", "single_pod",
                         save=False)
    ok["memory_analysis"]["total_hbm_bytes_per_device"] = 90e9
    recs = [ok, {"arch": "qwen2-72b", "shape": "long_500k",
                 "mesh": "single_pod", "status": "skipped", "rank": 255},
            {"arch": "mamba2-1.3b", "shape": "train_4k",
             "mesh": "single_pod", "status": "FAIL", "rank": 255,
             "error": "RuntimeError: boom"}]
    for r in recs:
        (tmp_path / f"{r['arch']}__{r['shape']}__single_pod.json").write_text(
            json.dumps(r))
    table = report.fmt_table("single_pod")
    rows = table.splitlines()
    assert len(rows) == 2 + 3
    assert "h2o-danube-1.8b | decode_32k | 255 | 90.00 GB **over 80 GB**" \
        in table
    assert "skipped" in table and "FAIL: RuntimeError: boom" in table
    assert report.load("multi_pod") == []


# ---------------------------------------------------------------------------
# against a real world of ranks and against the reference's HLO walker
# ---------------------------------------------------------------------------
def test_collective_record_equals_a_real_worlds(tmp_path):
    """A gloo world of 4 at (2, 2) calls each cell once on real tensors;
    every rank's log equals its dry twin's, and so do its axes."""
    res = ranks.run(4, tmp_path, "collective_log",
                    {"mesh": "2x2", "cells": WORLD_CELLS})
    for got in res:
        r = got["rank"]
        dry = meshlib.make_dry_mesh((2, 2), NAMES, r)
        assert got["axes"] == {str(k): (a.name, a.size, a.index, a.ranks)
                               for k, a in dry.axes.items()}
        for arch, kind, B, S in WORLD_CELLS:
            fn, args = steps.build_cell(get_config(arch).tiny(),
                                        ShapeSpec("x", S, B, kind), dry)
            with meshlib.count_collectives() as log:
                fn(*args)
            want = [tuple(c) for c in log]
            assert want, (arch, kind)
            assert got[f"{arch} {kind}"] == want, (r, arch, kind)


def _named(arch, kind, B, S) -> float:
    """The operations the reference's attention does beyond the port's
    on one rank of (2, 2) (the module docstring)."""
    cfg = get_config(arch).tiny()
    H, b, D, L = cfg.n_heads // 2, B // 2, cfg.head_dim, cfg.n_layers
    if kind == "prefill":
        masked = S * S - kcost.attn_pairs(S, S, cfg.attn_window)
        return 4.0 * D * H * b * masked * L
    if kind == "train":
        return 3 * 2.0 * S * S * D * H * b * L
    return 0.0


@pytest.mark.parametrize("arch,kind,B,S", PARITY)
def test_flops_match_the_reference_hlo(arch, kind, B, S, jax_hlo):
    ref = jax_hlo()[f"{arch} {kind}"]
    assert ref["dots"] == ref["flops"]            # the walk is the walker's
    for r in range(4):
        rec = _cell(arch, kind, B, S, meshlib.make_dry_mesh((2, 2), NAMES, r))
        got = rec["roofline"]["flops_per_device"]
        attn = rec["flops_by_op"].get("flash_attention", 0.0) + \
            rec["flops_by_op"].get("aten.bmm", 0.0)
        # every product outside the attention agrees
        assert got - attn == pytest.approx(ref["flops"] - ref["attn"],
                                           rel=PARITY_RTOL)
        named = _named(arch, kind, B, S)
        if named:       # the named difference is the attention's
            assert attn + named == pytest.approx(ref["attn"],
                                                 rel=PARITY_RTOL)
        assert got + named == pytest.approx(ref["flops"], rel=PARITY_RTOL)
