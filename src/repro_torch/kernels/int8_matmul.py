"""int8 x int8 -> int32 matmul with the per-row / per-column fp32 rescale.

Replaces the TPU kernel `int8_matmul_pallas`
(src/repro/kernels/int8_matmul.py), ASRPU's 8-bit MAC (paper §3.4).
CUDA source: `csrc/int8_matmul.cu`.

xq (M, K) i8, wq (K, N) i8, xs (M,) f32, ws (N,) f32 -> (M, N) f32 =
(float(xq @ wq) * xs[:, None]) * ws[None, :], the integer product exact.

What bounds it on the H100: bytes.  On the main path M = b*T is 16-64
rows while the weight is 1.4-16.6 MB, so each call streams its weight
once and does about M MACs per weight byte.  The kernel reads the
weight K-contiguous, as `wq.t()` (N, K) in row-major order, so that the
four K values one `__dp4a` takes are adjacent bytes.
`ops.prepare_int8_weights` returns wq as a (K, N) view of such storage,
so on the serving path that layout costs nothing; any other wq is
copied into it on each call.

On a CPU tensor the wrapper runs the plain version (`ref.int8_matmul`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0        # kernel launches made by this wrapper


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor, xs: torch.Tensor,
                ws: torch.Tensor) -> torch.Tensor:
    """xq: (M, K) i8; wq: (K, N) i8; xs: (M,) f32; ws: (N,) f32 ->
    (M, N) f32."""
    global launches
    if not xq.is_cuda:
        return ref.int8_matmul(xq, wq, xs, ws)
    dev = xq.device
    _build.require(xq, "xq", torch.int8, 2, dev)
    wqt = wq.t().contiguous()       # a no-op for prepared weights
    _build.require(wqt, "wq", torch.int8, 2, dev)
    _build.require(xs, "xs", torch.float32, 1, dev)
    _build.require(ws, "ws", torch.float32, 1, dev)
    M, K = xq.shape
    N = wqt.shape[0]
    if wqt.shape[1] != K or xs.shape[0] != M or ws.shape[0] != N:
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)}, wq "
                         f"{tuple(wq.shape)}, xs {tuple(xs.shape)}, ws "
                         f"{tuple(ws.shape)}")
    vec = K % 16 == 0 and xq.data_ptr() % 16 == 0 \
        and wqt.data_ptr() % 16 == 0
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _build.lib().int8_matmul_launch(
        xq.data_ptr(), wqt.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        out.data_ptr(), M, N, K, int(vec), _build.stream(dev))
    _build.check(err, "int8_matmul")
    launches += 1
    return out
