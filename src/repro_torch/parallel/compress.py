"""int8 error-feedback gradient compression for the data-parallel
all-reduce, port of `repro/parallel/compress.py` on the port's
`core/quant.py`.

Each worker quantizes its gradient plus the residual it carried
(block-wise int8 over the last dim, fp32 block scales) and keeps the new
residual locally, so the compression noise is carried, not lost
(Seide et al. / EF-SGD):

    q, err  = quantize(g + err_prev)
    g_hat   = all_reduce(dequantize(q)) / n

As in the reference, the all-reduce carries the dequantized fp32
payload (its `pmean` of `decompress(qs)`): this is the exact-on-mean
variant, and a variant that saves wire bytes by sending the int8 blocks
is not part of either package.  `compressed_psum` takes the port's
`launch.mesh.MeshAxis` where the reference takes an axis name inside
`shard_map`.  Nothing in the reference calls this module, nor in the
port.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.treeutil import tree_map


def compress(g: torch.Tensor, err: torch.Tensor):
    """Returns (payload dict, new_err); g_hat = decompress(payload)."""
    target = g.float() + err
    qs = quant.quantize(target)
    deq = quant.dequantize(qs)
    new_err = (target - deq[..., :g.shape[-1]] if deq.shape != g.shape
               else target - deq)
    return qs, new_err


def decompress(qs: dict) -> torch.Tensor:
    return quant.dequantize(qs)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, axis):
    """Error-feedback int8 all-reduce of `g` over `axis` (a `MeshAxis`):
    the mean over the axis of every rank's dequantized payload, in
    `g`'s dtype, and this rank's new residual (fp32)."""
    qs, new_err = compress(g, err)
    g_hat = decompress(qs).contiguous()      # a view when D % 128 != 0
    axis.all_reduce(g_hat)
    g_hat = g_hat / axis.size
    return g_hat.to(g.dtype), new_err


def init_error(params):
    """fp32 zero residuals in the tree of `params`, on each leaf's
    device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
