"""Roofline terms of a counted cell on NVIDIA H100s, port of
`repro/launch/roofline.py`.

The reference derives its terms from a compiled XLA program and a TPU
v5e's constants; the port derives them from `launch/op_cost.py`'s count
of one rank's ops and from the published peaks of one H100 SXM card
(NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates without
sparsity):

  bf16 / fp16 tensor cores : 989 TFLOP/s
  fp32 (CUDA cores)        : 67 TFLOP/s  (the port keeps TF32 off:
                                          `device.fp32_numerics`)
  int8 tensor cores        : 1,979 TOP/s
  HBM3                     : 3.35 TB/s, 80 GB a card

and its links (NVIDIA DGX H100 system: 8 cards a node, each with 18
fourth-generation NVLinks, 900 GB/s both ways, and its own ConnectX-7
port of 400 Gb/s NDR InfiniBand to the other nodes):

  NVLink     : 450 GB/s a direction, for an axis whose ranks lie in
               one node (ranks row-major over the mesh, NODE_CARDS a
               node)
  InfiniBand : 50 GB/s a card, for an axis that spans nodes

Conventions, as the reference's:
  * per-device quantities over per-card peaks: the counted rank's ops,
    bytes and collectives (every rank does not do the same work in the
    port: `launch/dryrun.py` evaluates the last rank by default);
  * collective bytes: each collective's output tensor bytes on the rank
    times the ring algorithm's wire factor ((n-1)/n for all-gather,
    reduce-scatter and all-to-all, 2(n-1)/n for all-reduce, 1 for a
    permute), n the ranks of its group; the port records its
    collectives as it issues them (`launch.mesh.count_collectives`),
    so there is no HLO text to parse.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}
HBM_BW = 3.35e12
HBM_BYTES = 80e9
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_CARDS = 8

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def ring_factor(kind: str, n: int) -> float:
    """The wire bytes of a collective over `n` ranks per output byte."""
    if n <= 1:
        return 0.0
    ring = (n - 1) / n
    return {"all-gather": ring, "reduce-scatter": ring,
            "all-reduce": 2 * ring, "all-to-all": ring,
            "collective-permute": 1.0}[kind]


def link_bw(ranks) -> float:
    """Bytes a second a card moves over the link an axis of `ranks`
    (global, row-major) takes: NVLink inside a node, InfiniBand across
    nodes."""
    return NVLINK_BW if len({r // NODE_CARDS for r in ranks}) == 1 else IB_BW


def collective_bytes(log) -> dict:
    """Per-device wire bytes by collective kind from a
    `launch.mesh.count_collectives` log, with "total", "counts" (the
    number of each kind) and "seconds" (each collective's wire bytes
    over its axis's link, summed)."""
    out = dict.fromkeys(COLLECTIVES, 0.0)
    counts = dict.fromkeys(COLLECTIVES, 0)
    seconds = 0.0
    for c in log:
        wire = c.nbytes * ring_factor(c.kind, c.size)
        if wire == 0.0:
            continue
        out[c.kind] += wire
        counts[c.kind] += 1
        seconds += wire / link_bw(c.ranks)
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["counts"] = counts
    out["seconds"] = seconds
    return out


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float          # global useful FLOPs (6ND / 2ND)
    hlo_flops_global: float     # the counted rank's ops times the ranks
    useful_ratio: float
    peak_bytes_per_device: float = 0.0
    flops_by_dtype: dict = field(default_factory=dict)

    def asdict(self):
        return asdict(self)


def analyze(cost, n_devices: int, model_flops: float,
            peak_bytes: float = 0.0) -> Roofline:
    """Roofline terms of one rank's `op_cost.Cost`: each dtype's
    operations over its own peak, summed; bytes over HBM's rate; the
    collectives at their axes' links (`Cost.coll_seconds`).

    `useful_ratio` is `model_flops` over the counted rank's operations
    times `n_devices`: exact where every rank does the same work, and
    approximate where ranks differ (a query block split over 'model'
    gives the last rank the longest causal prefix)."""
    t_comp = sum(f / PEAK_FLOPS[k] for k, f in cost.flops.items())
    t_mem = cost.bytes / HBM_BW
    t_coll = cost.coll_seconds
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    flops = cost.total_flops
    hlo_global = flops * n_devices
    return Roofline(
        flops_per_device=flops,
        bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.coll_total,
        t_compute=t_comp, t_memory=t_mem, t_collective=t_coll,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        hlo_flops_global=hlo_global,
        useful_ratio=model_flops / hlo_global if hlo_global else 0.0,
        peak_bytes_per_device=peak_bytes,
        flops_by_dtype=dict(cost.flops))


def bound_s(flops: dict, nbytes: float) -> float:
    """The least time a card takes for `flops` ({dtype bucket:
    operations}) and `nbytes` of HBM traffic: the larger of the two."""
    return max(nbytes / HBM_BW,
               sum(f / PEAK_FLOPS[k] for k, f in flops.items()))


def model_flops(cfg, shape) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (decode; one token per sequence)."""
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch
