"""int8 matmul with the per-row / per-column fp32 rescale, on the tensor cores.

Replaces the TPU kernel `int8_matmul_pallas`
(src/repro/kernels/int8_matmul.py), ASRPU's 8-bit MAC (paper §3.4), and
in its fused form also the activation quantization of the reference's
`ops.int8_matmul_prepared`.  CUDA source: `csrc/int8_matmul.cu`.

    int8_matmul(xq, wq, xs, ws)      pre-quantized xq (M, K) i8, xs (M,)
    int8_matmul_fused(x, wq, ws)     fp32 x (M, K), quantized in the launch

out = (float(xq @ wq) * xs[:, None]) * ws[None, :], the integer product
exact, with xq, xs = `ref.quantize_rows(x)` in the fused form: bitwise
the plain versions' on every shape.

What bounds it on the H100: bytes.  On the main path M = b*T is 1-64
rows while the weight is 1.4-16.6 MB, so each call streams its weight
once at about M MACs per weight byte.  The kernel reads the weight
K-contiguous, as `wq.t()` (N, K) in row-major order;
`ops.prepare_int8_weights` returns wq as a (K, N) view of such storage,
so on the serving path that layout costs nothing; any other wq is copied
into it on each call.  `plan` splits K over a cluster of up to 8 blocks
so that the grid fills the card with up to two blocks a SM (see the CUDA
source).

`launches` counts the products of either form.  On a CPU tensor each
wrapper runs its plain version (`ref.int8_matmul`,
`ref.int8_matmul_prepared`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

launches = 0            # product launches made by these wrappers

CHUNK = 64              # K bytes per chunk of the kernel's weight ring
MAX_SPLIT = 8           # blocks per cluster (the portable maximum)
WARPS = 8               # warps a block (on its 16 rows)
MAX_SMEM = 200 * 1024   # shared memory a block may plan for
H100_SMS = 132


class Plan(NamedTuple):
    nt: int         # n8 column tiles per warp (2 or 4): BN = 64 * nt
    split: int      # blocks per cluster, each a K slice of cps chunks
    cps: int        # 64-byte K chunks per block

    @property
    def bn(self) -> int:
        return 8 * self.nt * WARPS


def smem_bytes(p: Plan) -> int:
    """Shared memory of one block (csrc/int8_matmul.cu `smem_bytes`): the
    per-row header, then the quantized activation slice and its fp32 rows,
    or the int32 partial tile of the split-K exchange where that is
    larger."""
    kspan = p.cps * CHUNK
    body = 16 * (kspan + (0 if p.cps & 1 else CHUNK) + 4 * kspan)
    red = 4 * 16 * p.bn if p.split > 1 else 0
    return 1024 + max(body, red)


def blocks(p: Plan, m: int, n: int) -> int:
    return -(-n // p.bn) * p.split * -(-m // 16)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, sms: int = H100_SMS) -> Plan:
    """The launch shape for an (m, k) @ (k, n) product: the column tile
    width (nt) and K split that give the most blocks up to two a SM, ties
    to the wider tile and then the fewer splits (a block is 8 warps on 16
    rows: it quantizes only its own rows, and its 256 threads keep 64 KB
    of the weight in flight).  Every block of a cluster
    gets a non-empty K slice.  The rule was read off a sweep of plans
    timed on an H100 at the FC/head shapes of a b=4, w=4 and a b=1, w=1
    step.  Raises ValueError where no plan fits shared memory."""
    if m < 1 or n < 1 or k < 0:
        raise ValueError(f"int8_matmul.plan: bad shape ({m}, {k}, {n})")
    nch = -(-k // CHUNK)
    best, best_key = None, None
    for nt in (4, 2):
        for split in range(1, MAX_SPLIT + 1):
            cps = -(-nch // split)
            if split > 1 and (not cps or -(-nch // cps) != split):
                continue                # an empty K slice
            p = Plan(nt, split, cps)
            if smem_bytes(p) > MAX_SMEM:
                continue
            nb = blocks(p, m, n)
            key = (nb <= 2 * sms, nb if nb <= 2 * sms else -nb, nt, -split)
            if best_key is None or key > best_key:
                best, best_key = p, key
    if best is None:
        raise ValueError(f"int8_matmul: K={k} does not fit a {MAX_SPLIT}-block "
                         f"cluster's shared memory")
    return best


def check_plan(p: Plan, m: int, k: int, n: int) -> None:
    """Raise ValueError for a plan the kernel refuses (the C entry point
    checks the same)."""
    nch = -(-k // CHUNK)
    ok = (p.nt in (2, 4) and 1 <= p.split <= MAX_SPLIT and p.cps >= 0
          and p.split * p.cps >= nch
          and (p.split == 1 or (p.split - 1) * p.cps < nch)
          and -(-m // 16) <= 65535 and smem_bytes(p) <= MAX_SMEM)
    if not ok:
        raise ValueError(f"int8_matmul: plan {p} does not cover ({m}, {k}, "
                         f"{n}) or does not fit")


_sms = {}


def _sm_count(dev) -> int:
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sms[dev]


def _weight(wq, dev, K):
    wqt = wq.t().contiguous()       # a no-op for prepared weights
    _build.require(wqt, "wq", torch.int8, 2, dev)
    if wqt.shape[1] != K:
        raise ValueError(f"int8_matmul: wq {tuple(wq.shape)} does not "
                         f"take K={K}")
    return wqt


def _launch(a, wqt, xs, ws, quant, p):
    global launches
    M, K = a.shape
    N = wqt.shape[0]
    dev = a.device
    if p is None:
        p = plan(M, K, N, _sm_count(dev))
    check_plan(p, M, K, N)
    row_bytes = 4 if quant else 16
    vec_a = K % row_bytes == 0 and a.data_ptr() % 16 == 0
    vec_w = K % 16 == 0 and wqt.data_ptr() % 16 == 0
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _build.lib().int8_matmul_launch(
        a.data_ptr(), wqt.data_ptr(), 0 if xs is None else xs.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, N, K, int(quant), p.nt, p.split,
        p.cps, int(vec_a), int(vec_w), _build.stream(dev))
    _build.check(err, "int8_matmul")
    launches += 1
    return out


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                ws: torch.Tensor, *, plan: Plan | None = None
                ) -> torch.Tensor:
    """xq: (M, K) i8; wq: (K, N) i8; xs: (M,) f32; ws: (N,) f32 ->
    (M, N) f32.  `plan` overrides the launch shape (`plan()`)."""
    if not xq.is_cuda:
        return ref.int8_matmul(xq, wq, xs, ws)
    _build.refuse_grad("int8_matmul", xq, wq, xs, ws)
    dev = xq.device
    _build.require(xq, "xq", torch.int8, 2, dev)
    wqt = _weight(wq, dev, xq.shape[1])
    _build.require(xs, "xs", torch.float32, 1, dev)
    _build.require(ws, "ws", torch.float32, 1, dev)
    if xs.shape[0] != xq.shape[0] or ws.shape[0] != wqt.shape[0]:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)}")
    return _launch(xq, wqt, xs, ws, False, plan)


def int8_matmul_fused(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
                      *, plan: Plan | None = None) -> torch.Tensor:
    """x: (M, K) f32; wq: (K, N) i8; ws: (N,) f32 -> (M, N) f32: the
    per-row quantization of x, the int8 product and the rescale in one
    launch (`ops.int8_matmul_prepared` on the card)."""
    if not x.is_cuda:
        return ref.int8_matmul_prepared(x, wq, ws)
    _build.refuse_grad("int8_matmul_fused", x, wq, ws)
    dev = x.device
    _build.require(x, "x", torch.float32, 2, dev)
    wqt = _weight(wq, dev, x.shape[1])
    _build.require(ws, "ws", torch.float32, 1, dev)
    if ws.shape[0] != wqt.shape[0]:
        raise ValueError(f"int8_matmul_fused: wq {tuple(wq.shape)}, ws "
                         f"{tuple(ws.shape)}")
    return _launch(x, wqt, None, ws, True, plan)
