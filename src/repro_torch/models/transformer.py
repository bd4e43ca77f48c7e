"""Generic decoder-only LM: dense / GQA / MoE / SSM / hybrid, port of
`repro/models/transformer.py`.

One code path over the reference's layer kinds: attention or Mamba-2
(SSD) mixers per `layer_pattern`, a gated MLP or an MoE block per
`moe_every` (or no MLP at all: mamba2's `d_ff = 0`); RoPE, 2D-RoPE,
M-RoPE (three head-dim sections at (B, S, 3) positions) or none; token
inputs, or frontend embeddings (`embed_inputs=False`: qwen2-vl-7b's
patch and musicgen-medium's frame embeddings, `{"embeds": (B, S, D)}`
batches, from the stub frontend the reference also has).

Parameters keep the reference's tree and its stacked layout: each leaf
under `params["layers"]["p{p}"]` carries a leading repeat axis R, layer
i = r*P + p with the period P = lcm(len(layer_pattern), moe_every), so
each period position p has one static sub-layer kind.  The reference
scans over that axis; here a Python loop indexes it (`_layer_params`).

Entry points (functions of (params, ...), as in the reference):
  loss_fn(params, batch, *, remat=True, loss_chunks=0)
      training loss: chunked cross-entropy with the z-loss and the MoE
      load-balancing term; autograd differentiates it.
  prefill(params, batch, lengths=None, cache_len=None)
      full-sequence forward: (last-token logits (B, Vp), decode cache).
  decode_step(params, cache, batch)
      one-token step against the cache: (logits, next token, cache).
      The new KV and the new conv/SSM states are written into the
      cache's own tensors, in place, after the layer loop (the serving
      pool is updated, not copied); `kpos` and `offset` come back as
      new tensors.
A batch holds "tokens" (B, S) or "embeds" (B, S, D) as the config
takes, and optionally "positions" ((B, S), or (B, S, 3) for M-RoPE;
else arange(S) + the cache offset).

Prefill attention goes through the flash-attention kernel (positions
given by the batch take the plain position-masked attention,
`layers.attention_chunked`) and every norm (Mamba's gated norm
included) through the norm kernel (`KernelPolicy`, per call); decode
attention, the SSD scan, the MoE dispatch and the matrix products
(int8 serving weights dequantized at use) are plain torch, as the
reference leaves them to XLA.  The kernels have no backward: `loss_fn`
runs with `KernelPolicy("ref")`, and a kernel given a tensor that
requires grad raises.

`LM(cfg, policy, sharder)` with a `parallel/sharding.Sharder` over a
mesh runs SPMD, one copy per rank, on the rank's blocks of the
parameters (`param_specs`, `init_local`) and of the cache
(`cache_specs`), with the collectives the reference's GSPMD inserts
called explicitly: the embedding vocab-parallel (rows outside the
rank's slice masked, then an all-reduce), FSDP blocks all-gathered at
use one layer at a time, the fused qkv column-parallel and all-gathered
(a rank's columns of Hq + 2·Hk are not a head slice), the flash kernel
on the rank's heads (or, where the heads do not divide 'model', on its
block of query rows, k/v up to the block's last row), wo and the MLP's
w_down row-parallel (fp32 partials all-reduced, rounded once), the
prefill cache left sequence-sharded, decode's flash-decoding over it
(`layers.attention_decode_sharded`, the reference's condition), the new
k/v written by the rank that owns the slot, the MoE and Mamba mixers as
their modules say, and vocab-sharded logits all-gathered (prefill's
output is replicated; decode's token is the argmax of the gathered
row).  The mesh serves (prefill and decode) and trains: `loss_fn`
under a mesh runs `_train_layers` with the cell's layout, each layer's
FSDP blocks gathered inside its checkpointed function, and the
collectives are `launch/mesh.py`'s differentiable ones (Megatron's f
and g over 'model'; FSDP's reduce-scatter over the batch axes), so
autograd gives each rank the gradient of its own blocks.
`sharder=None` is the one-device model.  A sharded cell's layout
(specs, batch split, cache axis) is computed once by `layout` when the
cell is built and passed down; the LM keeps no per-call state.

The mesh's serving path keeps its own layer loops and attention bodies
(`_prefill_sharded`, `_decode_sharded`, `_attn_*_sharded`) beside the
one-device ones rather than running them over a one-rank axis, because
the two do different arithmetic and carry different options: a
row-parallel product sums fp32 partials and rounds once, where the
one-device product is one bf16 GEMM whose results the earlier phases
and tests pin against the reference, so a one-rank axis would change
the one-device numerics; and the one-device loops carry the serving
pool's options (bucketed `lengths` with per-row last tokens and ring
assembly, `cache_len`, batch-given positions on the masked attention,
per-slot caches with per-row write slots) that the cells refuse, while
the mesh loops carry the per-layer FSDP gathers, the sequence-sharded
cache blocks, the slot owner's write and the vocab-parallel ends.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.treeutil import params_from_numpy  # noqa: F401
from repro_torch.core.treeutil import tree_map
from repro_torch.launch import mesh as meshlib
from repro_torch.models import layers, mamba, moe
from repro_torch.parallel import sharding as shlib

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Megatron-style vocab padding so embed/head shard evenly."""
    return -(-v // multiple) * multiple


class LM:
    """The LM over a `ModelConfig`.  `policy` (a `KernelPolicy`; the
    serving engine passes `EngineConfig.kernels`) selects the kernel or
    the plain path of the prefill attention and the norms."""

    def __init__(self, cfg: ModelConfig, policy=None, sharder=None):
        self.cfg = cfg
        self.policy = policy
        # a sharder over no mesh is the one-device model
        self.sh = (sharder if sharder is not None
                   and sharder.mesh is not None else None)
        self._p_specs = {}
        me = cfg.moe.moe_every if cfg.moe else 1
        self.P = math.lcm(cfg.period, me)
        if cfg.n_layers % self.P:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is no "
                             f"multiple of the period {self.P}")
        self.R = cfg.n_layers // self.P
        self.Vp = pad_vocab(cfg.vocab_size)
        self.dtype = DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def _kind(self, p: int) -> str:
        return self.cfg.layer_kind(p % self.cfg.period)

    def _is_moe(self, p: int) -> bool:
        return self.cfg.is_moe_layer(p)

    def _has_mlp(self, p: int) -> bool:
        return self._is_moe(p) or self.cfg.d_ff > 0

    def _init_sublayer(self, gen, device, p: int) -> dict:
        cfg = self.cfg
        d = cfg.d_model
        out = {"norm1": layers.init_norm(d, cfg.norm, device=device)}
        if self._kind(p) == "attn":
            qkv_out = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
            out["mixer"] = {
                "wqkv": layers.init_linear(gen, d, qkv_out, cfg.qkv_bias,
                                           self.dtype, device),
                "wo": layers.init_linear(gen, cfg.n_heads * cfg.head_dim, d,
                                         dtype=self.dtype, device=device)}
        else:
            out["mixer"] = mamba.init_mamba(gen, d, cfg.ssm, self.dtype,
                                            device)
        if self._has_mlp(p):
            out["norm2"] = layers.init_norm(d, cfg.norm, device=device)
            if self._is_moe(p):
                out["mlp"] = moe.init_moe(gen, d, cfg.moe, self.dtype, device)
            else:
                out["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, self.dtype,
                                             device)
        return out

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters with the reference's tree, shapes and std,
        drawn from `generator` on its own device (a CUDA generator draws
        them on the card).  Torch cannot reproduce JAX's random streams:
        parity tests carry the reference's parameters across with
        `params_from_numpy` instead.  `generator=None` gives meta
        tensors (`param_shapes`)."""
        cfg = self.cfg
        device = (generator.device if generator is not None
                  else torch.device("meta"))
        params = {"final_norm": layers.init_norm(cfg.d_model, cfg.norm,
                                                 device=device)}
        if cfg.embed_inputs or cfg.tie_embeddings:
            std = 1.0 / math.sqrt(cfg.d_model)
            w = layers.randn(generator, (self.Vp, cfg.d_model))
            params["embed"] = {"w": (w * std).to(device=device,
                                                 dtype=self.dtype)}
            del w
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.init_linear(
                generator, cfg.d_model, self.Vp, dtype=self.dtype,
                device=device)
        stacked = {}
        for p in range(self.P):
            per_layer = [self._init_sublayer(generator, device, p)
                         for _ in range(self.R)]
            stacked[f"p{p}"] = _stack(per_layer)
        params["layers"] = stacked
        return params

    def param_shapes(self) -> dict:
        """The parameter tree as meta tensors: every leaf's shape and
        dtype, with no storage (the reference's `jax.eval_shape` of
        `init`)."""
        return self.init(None)

    # ------------------------------------------------------------------
    # caches
    # ------------------------------------------------------------------
    def cache_len(self, seq_len: int) -> int:
        if self.cfg.attn_window is not None:
            return min(seq_len, self.cfg.attn_window)
        return seq_len

    def init_cache(self, batch: int, seq_len: int, *, per_slot: bool = False,
                   device="cpu") -> dict:
        """Decode cache.  per_slot=True gives every batch row its own
        position metadata — kpos (B, Sc) and offset (B,) — so a serving
        slot pool can hold streams at unequal positions; the default
        scalar offset / shared (Sc,) kpos assumes all rows aligned."""
        cfg = self.cfg
        Sc = self.cache_len(seq_len)
        lay = {}
        for p in range(self.P):
            if self._kind(p) == "attn":
                shp = (self.R, batch, Sc, cfg.n_kv_heads, cfg.head_dim)
                lay[f"p{p}"] = {name: torch.zeros(shp, dtype=self.dtype,
                                                  device=device)
                                for name in ("k", "v")}
            else:
                # the reference broadcasts one layer's zeros over R; the
                # decode step writes these in place, so each is its own
                one = mamba.init_cache(batch, cfg.d_model, cfg.ssm,
                                       self.dtype, device)
                lay[f"p{p}"] = {name: torch.zeros((self.R,) + a.shape,
                                                  dtype=a.dtype, device=device)
                                for name, a in one.items()}
        i32 = dict(dtype=torch.int32, device=device)
        if per_slot:
            return {"layers": lay, "kpos": torch.full((batch, Sc), -1, **i32),
                    "offset": torch.zeros((batch,), **i32)}
        return {"layers": lay, "kpos": torch.full((Sc,), -1, **i32),
                "offset": torch.zeros((), **i32)}

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------
    def _positions(self, batch: dict, B: int, S: int, device,
                   offset=0) -> torch.Tensor:
        """The batch's "positions" as given, else arange(S) + offset, (B,
        S), broadcast to (B, S, 3) for M-RoPE."""
        if "positions" in batch:
            return batch["positions"]
        pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
        pos = (pos + offset).expand(B, S)
        if self.cfg.rope == "mrope":
            pos = pos[..., None].expand(B, S, 3)
        return pos

    def _ipos(self, positions) -> torch.Tensor:
        """Token indices of `positions`: M-RoPE's temporal component."""
        return positions[..., 0] if self.cfg.rope == "mrope" else positions

    def _embed(self, params, batch) -> torch.Tensor:
        """The token embeddings, or the frontend's "embeds" in the
        model's dtype (`embed_inputs=False`)."""
        cfg = self.cfg
        if cfg.embed_inputs:
            return params["embed"]["w"][batch["tokens"].long()]
        if "embeds" not in batch:
            raise ValueError(
                f"{cfg.name} takes frontend embeddings (embed_inputs=False):"
                f" give the batch 'embeds' (B, S, {cfg.d_model}), not "
                f"{sorted(batch)}")
        return batch["embeds"].to(self.dtype)

    def _logits(self, params, x) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return torch.matmul(x, params["embed"]["w"].t())
        return layers.linear(params["lm_head"], x)

    def _rope_tables(self, positions):
        """RoPE cos/sin of `positions`, shared by every layer's q and k."""
        cfg = self.cfg
        return layers.rope_tables_for(positions, cfg.head_dim, cfg.rope,
                                      cfg.rope_theta)

    def _qkv(self, p_mix, x, positions, tables):
        return self._split_qkv(layers.linear(p_mix["wqkv"], x), positions,
                               tables)

    def _split_qkv(self, qkv, positions, tables):
        cfg = self.cfg
        B, S, _ = qkv.shape
        Hq = cfg.n_heads * cfg.head_dim
        Hk = cfg.n_kv_heads * cfg.head_dim
        q = qkv[..., :Hq].reshape(B, S, cfg.n_heads, cfg.head_dim)
        k = qkv[..., Hq:Hq + Hk].reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        v = qkv[..., Hq + Hk:].reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
        q = layers.apply_rope(q, positions, cfg.rope, cfg.rope_theta, tables)
        k = layers.apply_rope(k, positions, cfg.rope, cfg.rope_theta, tables)
        return q, k, v

    def _attn_full(self, p_mix, x, positions, tables, given_pos=False):
        """Prefill attention. Returns (out, (k, v)).  `given_pos`: the
        batch gave the positions, so the mask is the reference's on
        their token indices (the plain masked attention), not the flash
        kernel's on arange(S)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = self._qkv(p_mix, x, positions, tables)
        ipos = self._ipos(positions) if given_pos else None
        out = layers.attention_chunked(q, k, v, qpos=ipos, kpos=ipos,
                                       causal=True, window=cfg.attn_window,
                                       policy=self.policy)
        out = layers.linear(p_mix["wo"],
                            out.reshape(B, S, cfg.n_heads * cfg.head_dim))
        return out, (k, v)

    def _attn_decode(self, p_mix, x, positions, tables, kv_cache, kpos_m):
        """Decode attention: the cache is read-only here; the new (k, v)
        is attended as a separate softmax column and returned, so the
        layer loop emits only (B, 1, K, Dh) slices that the caller
        writes into the cache once, after the loop.  `kpos_m`: the
        cache positions with the slot being rewritten masked (-1)."""
        cfg = self.cfg
        B = x.shape[0]
        q, k, v = self._qkv(p_mix, x, positions, tables)
        out = layers.attention_decode(q, kv_cache["k"], kv_cache["v"],
                                      self._ipos(positions)[:, 0], kpos_m,
                                      window=cfg.attn_window,
                                      k_new=k, v_new=v)
        out = layers.linear(p_mix["wo"],
                            out.reshape(B, 1, cfg.n_heads * cfg.head_dim))
        return out, {"k": k, "v": v}

    def _sublayer(self, p, lp, x, positions, tables, cache_p, kpos_m,
                  decode, lengths=None, given_pos=False, layout=None):
        """One sub-layer: (x, its new cache, its MoE aux value, None
        without an MoE block).  `layout`: the sharded cell's (`layout`),
        None on one device."""
        cfg = self.cfg
        aux = None
        h = layers.apply_norm(lp["norm1"], x, cfg.norm, policy=self.policy)
        sh = self.sh
        if self._kind(p) == "attn":
            if decode and sh is None:
                out, new_cache = self._attn_decode(lp["mixer"], h, positions,
                                                   tables, cache_p, kpos_m)
            elif decode:
                out, new_cache = self._attn_decode_sharded(
                    lp["mixer"], h, positions, tables, cache_p, kpos_m,
                    layout)
            else:
                # causal: right-padding (bucketed prefill) cannot leak
                # into real positions, so no mask is needed here
                if sh is None:
                    out, (k, v) = self._attn_full(lp["mixer"], h, positions,
                                                  tables, given_pos)
                else:
                    out, (k, v) = self._attn_full_sharded(lp["mixer"], h,
                                                          positions, tables)
                new_cache = {"k": k, "v": v}
        else:
            out, new_cache = mamba.apply_mamba(lp["mixer"], h, cfg.ssm,
                                               cache_p, lengths=lengths,
                                               policy=self.policy,
                                               sharder=sh)
        x = x + out
        if self._has_mlp(p):
            h = layers.apply_norm(lp["norm2"], x, cfg.norm,
                                  policy=self.policy)
            if self._is_moe(p):
                if sh is None:
                    y, aux = moe.apply_moe(lp["mlp"], h, cfg.moe, cfg.act)
                else:
                    y, aux = moe.apply_moe(lp["mlp"], h, cfg.moe, cfg.act,
                                           sharder=sh,
                                           batch_local=layout["bl"])
            elif sh is None:
                y = layers.apply_mlp(lp["mlp"], h, cfg.act)
            else:
                y = layers.apply_mlp_sharded(lp["mlp"], h, cfg.act, cfg.d_ff,
                                             sh.model_axis)
            x = x + y
        return x, new_cache, aux

    def _layers(self, params, x, positions, cache=None, *, decode=False,
                lengths=None, given_pos=False):
        """The layer loop (the reference's `_scan_layers`).  Prefill
        returns (x, per-layer caches stacked to (R, ...): KV (R, B, S, K,
        Dh), Mamba conv/SSM states as `apply_mamba` returns them); decode
        reads each layer's cache slice, then writes every layer's new KV
        and new conv/SSM state into the cache tensors in place after the
        loop and returns (x, cache with new kpos/offset)."""
        tables = self._rope_tables(positions)
        if not decode:
            new = {f"p{p}": [] for p in range(self.P)}
            for r in range(self.R):
                for p in range(self.P):
                    lp = _layer_params(params["layers"][f"p{p}"], r)
                    x, nc, _ = self._sublayer(p, lp, x, positions, tables,
                                              None, None, False, lengths,
                                              given_pos)
                    new[f"p{p}"].append(nc)
            return x, {"layers": {name: _stack(t) for name, t in new.items()}}

        kpos = cache["kpos"]
        offset = cache["offset"]
        # per-slot serving cache: offset (B,), kpos (B, Sc) — each batch
        # row keeps its own write slot / positions (see init_cache)
        per_slot = offset.dim() == 1
        slot = offset % max(1, kpos.shape[-1])
        kpos = kpos.clone()
        # every layer masks the slot being (re)written: it holds the
        # evicted entry, and the new token is attended as its own column
        kpos_m = kpos.clone()
        if per_slot:
            # row b's slot[b], by a scatter: `kpos[rows, slot] = offset`
            # (an index_put_ of every dimension) waits on the host on the
            # card (chip_smoke.py phase 28, under the engine's guard)
            at = slot.long()[:, None]
            kpos.scatter_(1, at, offset[:, None].to(kpos.dtype))
            kpos_m.scatter_(1, at, -1)
        else:
            # a 1-element index: a 0-d one is read back to the host
            at = slot.long().reshape(1)
            kpos.index_put_((at,), offset.reshape(1).to(kpos.dtype))
            kpos_m.index_put_((at,), torch.full_like(at, -1,
                                                     dtype=kpos_m.dtype))
        new = {f"p{p}": [] for p in range(self.P)}
        for r in range(self.R):
            for p in range(self.P):
                lay = cache["layers"][f"p{p}"]
                cp = {name: a[r] for name, a in lay.items()}
                lp = _layer_params(params["layers"][f"p{p}"], r)
                x, nc, _ = self._sublayer(p, lp, x, positions, tables, cp,
                                          kpos_m, True)
                new[f"p{p}"].append(nc)
        for p in range(self.P):
            old = cache["layers"][f"p{p}"]
            for name, dst in old.items():
                if self._kind(p) != "attn":  # conv/SSM states: (B, ...)
                    for r, nc in enumerate(new[f"p{p}"]):
                        dst[r].copy_(nc[name])
                    continue
                upd = torch.stack([nc[name] for nc in new[f"p{p}"]])
                if per_slot:                 # KV: (R, B, 1, K, Dh)
                    # row b writes its own cache slot[b]
                    rows = torch.arange(dst.shape[1], device=upd.device)
                    dst[:, rows, slot] = upd[:, :, 0].to(dst.dtype)
                else:
                    dst.index_copy_(2, at, upd.to(dst.dtype))
        return x, {"layers": cache["layers"], "kpos": kpos,
                   "offset": offset + 1}

    def _train_layers(self, params, x, positions, remat: bool,
                      given_pos: bool = False, layout=None):
        """The training forward of the layer loop: (x, the MoE aux sum).
        No cache is kept; with `remat` each layer is recomputed in the
        backward (`torch.utils.checkpoint`), so only its input stays
        alive.  Under a mesh (`layout`: the cell's) `params` are the
        rank's blocks: each layer's FSDP blocks are gathered inside the
        checkpointed layer function, so that the backward's recompute
        gathers them again instead of keeping every layer's whole
        weights alive.

        The aux sum is the reference's: its scan body adds the aux value
        of the period's last sub-layer once per repeat (the loop over
        the period rebinds `aux`), so a period with several MoE layers
        (jamba: 4 of 8) counts only its last one's.  With one MoE layer
        a period, at its end, as in qwen2-moe, every layer counts."""
        tables = self._rope_tables(positions)
        aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        # each stacked leaf split once into its R layers: indexing it per
        # layer would make every layer's backward write a zero-filled
        # gradient of the whole (R, ...) leaf, R of them summed
        per_layer = {name: tree_map(lambda a: a.unbind(0), t)
                     for name, t in params["layers"].items()}
        lspec = None if layout is None else {
            name: tree_map(lambda sp: sp[1:], t)
            for name, t in layout["specs"]["layers"].items()}
        for r in range(self.R):
            for p in range(self.P):
                lp = tree_map(lambda ls: ls[r], per_layer[f"p{p}"])

                def layer(h, p=p, lp=lp):
                    if layout is not None:
                        lp = self._whole_dims(lp, lspec[f"p{p}"],
                                              layout["bl"])
                    h, _, aux = self._sublayer(p, lp, h, positions, tables,
                                               None, None, False,
                                               given_pos=given_pos,
                                               layout=layout)
                    return h, aux
                x, aux = (checkpoint(layer, x, use_reentrant=False)
                          if remat else layer(x))
            if aux is not None:
                aux_sum = aux_sum + aux
        return x, aux_sum

    def _chunk_loss(self, params, x, labels, layout=None):
        """Sums over one sequence chunk: (nll, squared log-partition,
        labelled tokens), labels of -1 masked.  Under a mesh the logits
        are the vocab-parallel head's, gathered whole."""
        logits = (self._logits(params, x) if layout is None else
                  self._logits_sharded(params, x, layout)).float()
        valid = labels >= 0
        lbl = torch.where(valid, labels, torch.zeros_like(labels))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
        zero = torch.zeros_like(lse)
        return (torch.where(valid, lse - gold, zero).sum(),
                torch.where(valid, lse.square(), zero).sum(), valid.sum())

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def loss_fn(self, params, batch, *, remat=True, loss_chunks=0,
                layout=None):
        """batch: tokens (B, S) or embeds (B, S, D), and labels (B, S)
        int (-1 = pad).

        Returns (loss + z-loss + MOE_AUX_COEF * aux, {"loss", "aux",
        "ntok"}).  Cross-entropy runs over the padded vocab in sequence
        chunks (16 when S % 16 == 0 and S >= 2048, else 1; `loss_chunks`
        overrides), each recomputed in the backward, so the fp32
        (B, S, Vp) logits never exist at once.

        Under a mesh `params` are the rank's blocks, the batch its rows
        (the whole batch where it does not split over the batch axes)
        and `layout` the cell's (`layout`).  The semantics are the
        reference's on the global batch: nll, the z-sum and ntok are
        summed over the batch axes, so the value and the metrics are
        replicated, and each rank back-propagates its own rows' share
        (the sums' backward is the identity, `launch.mesh.reduce_from`);
        `launch.steps.make_train_step` completes the gradients
        (`sharding.complete_grads`)."""
        cfg = self.cfg
        if self.sh is not None:
            layout = self._need_layout(layout)
            if "positions" in batch:
                raise NotImplementedError(
                    "LM.loss_fn under a mesh takes the train cell's batches "
                    "(tokens or embeds, positions arange(S)): batch-given "
                    "positions are a one-device option")
            x = self._embed_sharded(params, batch, layout)
        else:
            x = self._embed(params, batch)
        B, S = x.shape[:2]
        positions = self._positions(batch, B, S, x.device)
        x, aux = self._train_layers(params, x, positions, remat,
                                    "positions" in batch, layout)
        x = layers.apply_norm(params["final_norm"], x, cfg.norm,
                              policy=self.policy)
        labels = batch["labels"].to(device=x.device, dtype=torch.int64)
        if loss_chunks == 0:
            loss_chunks = 16 if S % 16 == 0 and S >= 2048 else 1
        if S % loss_chunks:
            raise ValueError(f"loss_fn: S={S} does not split into "
                             f"{loss_chunks} chunks")
        cs = S // loss_chunks
        nll = zsum = torch.zeros((), dtype=torch.float32, device=x.device)
        ntok = torch.zeros((), dtype=torch.int64, device=x.device)
        for c in range(loss_chunks):
            sl = slice(c * cs, (c + 1) * cs)
            n, z, k = checkpoint(self._chunk_loss, params, x[:, sl],
                                 labels[:, sl], layout, use_reentrant=False)
            nll, zsum, ntok = nll + n, zsum + z, ntok + k
        if self.sh is not None and layout["bl"]:
            bax = self.sh.batch_axis
            nll = meshlib.reduce_from(nll, bax)
            zsum = meshlib.reduce_from(zsum, bax)
            ntok = meshlib.reduce_from(ntok, bax)
        ntok = torch.clamp(ntok, min=1)
        loss = nll / ntok
        zloss = Z_LOSS_COEF * zsum / ntok
        return loss + zloss + MOE_AUX_COEF * aux, {
            "loss": loss, "aux": aux, "ntok": ntok}

    def prefill(self, params, batch, lengths=None, cache_len=None, *,
                layout=None):
        """Full-seq forward. Returns (last-token logits (B, Vp), cache).

        `lengths` (B,) enables the masked (bucketed) path: each row's
        tokens beyond lengths[b] are right-padding — logits come from
        position lengths[b]-1, recurrent state stops before the padding
        (see `mamba.apply_mamba`), and the cache is assembled with
        PER-ROW position metadata (kpos (B, Sc), offset (B,)) so rows
        drop straight into a per-slot serving pool.  `cache_len` overrides
        the assembled ring width (the pool's ring may be narrower than
        the padded bucket).

        Under a mesh `params` and the batch are this rank's blocks and
        `layout` is the cell's (`layout`); the logits come back whole
        (B, Vp) on every rank, the cache as the rank's blocks
        (`cache_specs`)."""
        if self.sh is not None:
            return self._prefill_sharded(params, batch, lengths, cache_len,
                                         layout)
        cfg = self.cfg
        x = self._embed(params, batch)
        B, S = x.shape[:2]
        dev = x.device
        positions = self._positions(batch, B, S, dev)
        if lengths is not None:
            lengths = lengths.to(device=dev, dtype=torch.int64)
        x, cache = self._layers(params, x, positions, lengths=lengths,
                                given_pos="positions" in batch)
        if lengths is None:
            x = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm,
                                  policy=self.policy)
            logits = self._logits(params, x)[:, 0]
            # assemble the decode cache; SWA ring by the decode path
            Sc = self.cache_len(S)
            if Sc != S:
                cache["layers"] = self._map_kv(lambda a: a[:, :, -Sc:],
                                               cache["layers"])
                cache["kpos"] = torch.arange(S - Sc, S, dtype=torch.int32,
                                             device=dev)
            else:
                cache["kpos"] = torch.arange(S, dtype=torch.int32, device=dev)
            cache["offset"] = torch.full((), S, dtype=torch.int32, device=dev)
            return logits, cache

        # ---- masked path: per-row last token + per-row ring assembly ----
        last = torch.clamp(lengths - 1, 0, S - 1)                 # (B,)
        brow = torch.arange(B, device=dev)
        xl = x[brow, last][:, None]                               # (B,1,D)
        xl = layers.apply_norm(params["final_norm"], xl, cfg.norm,
                               policy=self.policy)
        logits = self._logits(params, xl)[:, 0]
        Sc = self.cache_len(S) if cache_len is None else int(cache_len)
        # cache row j of stream b holds position start_b + j, where
        # start_b = max(len_b - Sc, 0): the last min(len, Sc) real
        # positions land in rows 0.. (prompts longer than the ring
        # arrive trimmed, mirroring the SWA decode convention)
        start = torch.clamp(lengths - Sc, min=0)                  # (B,)
        pos_rows = start[:, None] + torch.arange(Sc, device=dev)[None, :]
        rows = torch.clamp(pos_rows, max=S - 1)                   # (B, Sc)
        cache["layers"] = self._map_kv(lambda a: a[:, brow[:, None], rows],
                                       cache["layers"])
        cache["kpos"] = torch.where(pos_rows < lengths[:, None], pos_rows,
                                    torch.full_like(pos_rows, -1)
                                    ).to(torch.int32)
        cache["offset"] = lengths.to(torch.int32)
        return logits, cache

    def _map_kv(self, fn, lay: dict) -> dict:
        """`fn` over the attention layers' k/v leaves; the Mamba layers'
        conv/SSM states (no sequence axis) are kept as they are."""
        return {name: (tree_map(fn, t) if self._kind(int(name[1:])) == "attn"
                       else t) for name, t in lay.items()}

    def decode_step(self, params, cache, batch, *, layout=None):
        """One-token step. batch: tokens (B, 1) or embeds (B, 1, D).

        Returns (logits (B, Vp) f32, next_token (B,) int64, cache): the
        cache's KV and conv/SSM tensors are updated in place (see the module
        docstring).  Under a mesh, as `prefill` (`layout` the cell's);
        logits and tokens come back whole on every rank."""
        if self.sh is not None:
            return self._decode_sharded(params, cache, batch, layout)
        cfg = self.cfg
        x = self._embed(params, batch)
        B = x.shape[0]
        pos = cache["offset"]
        if pos.dim() == 1:                 # per-slot offsets: (B,) -> (B, 1)
            pos = pos[:, None]
        positions = self._positions(batch, B, 1, x.device, offset=pos)
        x, new_cache = self._layers(params, x, positions, cache, decode=True)
        x = layers.apply_norm(params["final_norm"], x, cfg.norm,
                              policy=self.policy)
        logits = self._logits(params, x)[:, 0].float()
        # mask vocab padding before sampling
        logits[:, cfg.vocab_size:] = -torch.inf
        next_tok = torch.argmax(logits, dim=-1)
        return logits, next_tok, new_cache

    # ------------------------------------------------------------------
    # the mesh: this rank's blocks, explicit collectives (SPMD)
    # ------------------------------------------------------------------
    def param_specs(self, int8: bool = False) -> dict:
        """The spec tree of the parameters (`sharding.param_shardings` of
        `param_shapes`, or of their int8 serving image with `int8`)."""
        if int8 not in self._p_specs:
            shapes = self.param_shapes()
            if int8:
                shapes = layers.quantize_params_for_serving(shapes)
            self._p_specs[int8] = shlib.param_shardings(self.cfg, shapes,
                                                        self.sh.mesh)
        return self._p_specs[int8]

    def cache_specs(self, global_batch: int, seq_len: int) -> dict:
        """The spec tree of the decode cache of a cell
        (`sharding.cache_shardings` of `init_cache`'s global shapes)."""
        meta = self.init_cache(global_batch, seq_len, device="meta")
        return shlib.cache_shardings(self.cfg, meta, self.sh.mesh,
                                     global_batch)

    def init_local(self, generator: torch.Generator, *,
                   int8: bool = False) -> dict:
        """This rank's blocks of `init(generator)` (with `int8`, of its
        `quantize_params_for_serving` image), bitwise: every leaf is
        drawn whole from the same stream, in `init`'s order, quantized
        whole where int8 (a block of a row-parallel `wq` keeps the
        scales of its full rows), and only its block kept.  The stacked
        layer leaves are drawn one repeat at a time, so a rank never
        holds the whole tree, nor one whole stacked leaf."""
        cfg, mesh = self.cfg, self.sh.mesh
        device = generator.device
        specs = self.param_specs(int8)
        quant = layers.quantize_params_for_serving if int8 else (
            lambda t: t)

        def blocks(tree, spec):
            return shlib.shard_tree(tree, spec, mesh)
        params = {"final_norm": blocks(
            layers.init_norm(cfg.d_model, cfg.norm, device=device),
            specs["final_norm"])}
        if cfg.embed_inputs or cfg.tie_embeddings:
            std = 1.0 / math.sqrt(cfg.d_model)
            w = layers.randn(generator, (self.Vp, cfg.d_model))
            params["embed"] = blocks(
                {"w": (w * std).to(device=device, dtype=self.dtype)},
                specs["embed"])
            del w
        if not cfg.tie_embeddings:
            head = layers.init_linear(generator, cfg.d_model, self.Vp,
                                      dtype=self.dtype, device=device)
            params["lm_head"] = blocks(quant({"lm_head": head})["lm_head"],
                                       specs["lm_head"])
            del head
        stacked = {}
        for p in range(self.P):
            lspec = tree_map(lambda sp: sp[1:], specs["layers"][f"p{p}"])
            out = None
            for r in range(self.R):
                sub = blocks(quant(self._init_sublayer(generator, device, p)),
                             lspec)
                if out is None:
                    out = tree_map(lambda a: a.new_empty((self.R,) + a.shape),
                                   sub)
                tree_map(lambda dst, a: dst[r].copy_(a), out, sub)
                del sub
            stacked[f"p{p}"] = out
        params["layers"] = stacked
        return params

    def layout(self, shape, *, int8: bool) -> dict:
        """The layout of a sharded cell of `shape` (a `ShapeSpec`: the
        global batch and the sequence length) on int8 serving weights or
        not, computed once when the cell is built: the parameter specs,
        whether the batch splits over the batch axes ("bl"), the cache
        specs, the axis the cache's sequence blocks split over ("cax")
        and whether decode runs flash-decoding (the reference's
        condition: not the baseline, Sc divides 'model')."""
        sh = self.sh
        cs = self.cache_specs(shape.global_batch, shape.seq_len)
        return {"specs": self.param_specs(int8),
                "bl": sh.batch_split(shape.global_batch),
                "seq_len": shape.seq_len, "cache": cs,
                "cax": shlib.split_axis(sh.mesh, cs["kpos"][0]),
                "flash_decode": (not sh.baseline and
                                 self.cache_len(shape.seq_len) % sh.nm == 0)}

    @staticmethod
    def _need_layout(layout) -> dict:
        if layout is None:
            raise ValueError("an LM under a mesh takes the cell's layout= "
                             "(LM.layout(shape, int8=...); build_cell "
                             "passes it)")
        return layout

    def _whole_dims(self, tree, spec_tree, batch_split: bool):
        """A parameter subtree with its FSDP blocks all-gathered (the
        'model' blocks kept).  `batch_split`: the layout's "bl", whether
        the ranks of the batch axes hold different rows (the gathers'
        backward then sums, `sharding.gather_dims`)."""
        m = self.sh.mesh
        return tree_map(lambda t, sp: shlib.gather_dims(
            t, sp, m, keep=("model",), summed=batch_split), tree, spec_tree)

    def _layer_local(self, params, layout, p: int, r: int) -> dict:
        """Layer (p, r)'s parameters: its FSDP blocks gathered at use."""
        lspec = tree_map(lambda sp: sp[1:],
                         layout["specs"]["layers"][f"p{p}"])
        return self._whole_dims(_layer_params(params["layers"][f"p{p}"], r),
                                lspec, layout["bl"])

    def _embed_sharded(self, params, batch, layout) -> torch.Tensor:
        """Token embeddings from the vocab-parallel table: the rank's
        rows of the vocabulary looked up, the others zero, summed over
        'model' (exact: one nonzero term a row)."""
        if not self.cfg.embed_inputs:
            return self._embed(params, batch)
        w = self._whole_dims(params["embed"], layout["specs"]["embed"],
                             layout["bl"])["w"]
        tok = batch["tokens"].long()
        if w.shape[0] == self.Vp:
            return w[tok]
        ax = self.sh.model_axis
        n = w.shape[0]
        loc = tok - ax.index * n
        mine = (loc >= 0) & (loc < n)
        x = w[torch.clamp(loc, 0, n - 1)]
        x = torch.where(mine[..., None], x, torch.zeros_like(x))
        return meshlib.reduce_from(x, ax)

    def _logits_sharded(self, params, x, layout) -> torch.Tensor:
        """(..., Vp) logits: the rank's vocab block, all-gathered over
        'model' (x, replicated, meets the rank's block of the head: its
        gradient is the ranks' partials summed)."""
        specs, bl, ax = layout["specs"], layout["bl"], self.sh.model_axis
        if self.cfg.tie_embeddings:
            w = self._whole_dims(params["embed"], specs["embed"], bl)["w"]
            split = w.shape[0] < self.Vp
            y = torch.matmul(meshlib.copy_to(x, ax) if split else x, w.t())
        else:
            head = self._whole_dims(params["lm_head"], specs["lm_head"], bl)
            split = layers.out_features(head) < self.Vp
            y = layers.linear(head, meshlib.copy_to(x, ax) if split else x)
        if split:
            y = meshlib.gather_from(y, ax, y.dim() - 1)
        return y

    def _wo(self, p_wo, o: torch.Tensor) -> torch.Tensor:
        """The attention output projection of o (..., Hq·D), whole on
        every rank: row-parallel on the rank's block where wo's rows are
        split."""
        ax = self.sh.model_axis
        if layers.in_features(p_wo) < o.shape[-1]:
            return layers.linear_row(p_wo, layers.feature_block(o, ax), ax)
        return layers.linear(p_wo, o)

    def _attn_full_sharded(self, p_mix, x, positions, tables):
        """Prefill attention on a rank: (out, (k, v)) with k, v whole
        (B, S, K, Dh).  qkv column-parallel, all-gathered; the flash
        kernel on the rank's heads where both head counts divide
        'model', else on the rank's block of query rows (k/v up to the
        block's last row: the kernel right-aligns q to the end of kv),
        else on everything; wo row-parallel."""
        cfg, ax = self.cfg, self.sh.model_axis
        B, S, _ = x.shape
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = layers.linear_col(p_mix["wqkv"], x, (H + 2 * K) * D, ax)
        q, k, v = self._split_qkv(qkv, positions, tables)
        win, n, i = cfg.attn_window, ax.size, ax.index
        if H % n == 0 and K % n == 0:
            hq = H // n
            o = layers.attention_chunked(
                meshlib.split_to(q, ax, 2), meshlib.split_to(k, ax, 2),
                meshlib.split_to(v, ax, 2), window=win, policy=self.policy)
            # wo's rows split with the heads: row-parallel on these
            return layers.linear_row(p_mix["wo"], o.reshape(B, S, hq * D),
                                     ax), (k, v)
        if S % n == 0:
            hi = (i + 1) * (S // n)
            # k/v up to the block's last row: a prefix that differs per
            # rank, so their gradients are the ranks' partials summed
            o = layers.attention_chunked(
                meshlib.split_to(q, ax, 1), meshlib.copy_to(k, ax)[:, :hi],
                meshlib.copy_to(v, ax)[:, :hi], window=win, policy=self.policy)
            o = meshlib.gather_from(o, ax, 1).reshape(B, S, H * D)
        else:
            o = layers.attention_chunked(q, k, v, window=win,
                                         policy=self.policy)
            o = o.reshape(B, S, H * D)
        return self._wo(p_mix["wo"], o), (k, v)

    def _attn_decode_sharded(self, p_mix, x, positions, tables, kv_cache,
                             kpos_m, layout):
        """Decode attention on a rank against its block of the cache
        (B, Sc_l, K, Dh) and of kpos_m (Sc_l,).  Flash-decoding under the
        reference's condition (not the baseline, Sc divides 'model'):
        over the cache's own sequence axis, or over 'model' on the rank's
        slice of a whole cache; otherwise the cache is gathered and the
        one-device attention runs."""
        cfg, sh = self.cfg, self.sh
        ax = sh.model_axis
        B = x.shape[0]
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qkv = layers.linear_col(p_mix["wqkv"], x, (H + 2 * K) * D, ax)
        q, k, v = self._split_qkv(qkv, positions, tables)
        qpos = self._ipos(positions)[:, 0]
        kc, vc, kp = kv_cache["k"], kv_cache["v"], kpos_m
        cax = layout["cax"]
        if layout["flash_decode"]:
            if cax is None:         # a whole cache: this rank's slice
                n = kc.shape[1] // ax.size
                sl = slice(ax.index * n, (ax.index + 1) * n)
                kc, vc, kp, cax = kc[:, sl], vc[:, sl], kp[sl], ax
            out = layers.attention_decode_sharded(
                q, kc, vc, qpos, kp, window=cfg.attn_window, k_new=k,
                v_new=v, sharder=sh, axis=cax)
        else:
            if cax is not None:
                kc, vc, kp = (cax.all_gather(kc, 1), cax.all_gather(vc, 1),
                              cax.all_gather(kp, 0))
            out = layers.attention_decode(q, kc, vc, qpos, kp,
                                          window=cfg.attn_window,
                                          k_new=k, v_new=v)
        out = self._wo(p_mix["wo"], out.reshape(B, 1, H * D))
        return out, {"k": k, "v": v}

    def _gather_batch(self, t: torch.Tensor, layout) -> torch.Tensor:
        """The whole batch of a per-row result split over the batch axes."""
        return self.sh.batch_axis.all_gather(t, 0) if layout["bl"] else t

    def _prefill_sharded(self, params, batch, lengths, cache_len, layout):
        if lengths is not None or cache_len is not None \
                or "positions" in batch:
            raise NotImplementedError(
                "LM.prefill under a mesh takes the cells' batches (tokens "
                "or embeds, positions arange(S)): bucketed lengths, ring "
                "widths and batch-given positions are one-device options")
        cfg, mesh = self.cfg, self.sh.mesh
        layout = self._need_layout(layout)
        x = self._embed_sharded(params, batch, layout)
        B, S = x.shape[:2]
        if S != layout["seq_len"]:
            raise ValueError(f"a prefill of {S} tokens in a cell of "
                             f"{layout['seq_len']}")
        dev = x.device
        positions = self._positions(batch, B, S, dev)
        tables = self._rope_tables(positions)
        Sc = self.cache_len(S)
        cspec = layout["cache"]["layers"]
        new = {f"p{p}": [] for p in range(self.P)}
        for r in range(self.R):
            for p in range(self.P):
                lp = self._layer_local(params, layout, p, r)
                x, nc, _ = self._sublayer(p, lp, x, positions, tables, None,
                                          None, False, layout=layout)
                if self._kind(p) == "attn":
                    # leave sequence-sharded, as Sharder.seq and
                    # cache_shardings place the cache; batch as x's
                    sp = cspec[f"p{p}"]["k"][1:]
                    nc = {name: shlib.local_block(
                        a[:, S - Sc:], (None,) + sp[1:], mesh).contiguous()
                        for name, a in nc.items()}
                new[f"p{p}"].append(nc)
        xl = layers.apply_norm(params["final_norm"], x[:, -1:], cfg.norm,
                               policy=self.policy)
        logits = self._gather_batch(
            self._logits_sharded(params, xl, layout)[:, 0], layout)
        kpos = torch.arange(S - Sc, S, dtype=torch.int32, device=dev)
        cache = {"layers": {name: _stack(t) for name, t in new.items()},
                 "kpos": shlib.local_block(kpos, layout["cache"]["kpos"],
                                           mesh).clone(),
                 "offset": torch.full((), S, dtype=torch.int32, device=dev)}
        return logits, cache

    def _decode_sharded(self, params, cache, batch, layout):
        cfg = self.cfg
        layout = self._need_layout(layout)
        Sc = self.cache_len(layout["seq_len"])
        if cache["offset"].dim() != 0:
            raise NotImplementedError(
                "LM.decode_step under a mesh takes the cells' cache (one "
                "offset, kpos (Sc,)); per-slot caches are one-device")
        x = self._embed_sharded(params, batch, layout)
        B = x.shape[0]
        offset = cache["offset"]
        positions = self._positions(batch, B, 1, x.device, offset=offset)
        tables = self._rope_tables(positions)
        # the slot offset % Sc is written by the rank whose block holds
        # it; every rank masks it in its copy of kpos if it holds it
        kpos = cache["kpos"].clone()
        cax = layout["cax"]
        n_loc = kpos.shape[0]
        lo = cax.index * n_loc if cax is not None else 0
        slot = offset.long() % max(1, Sc) - lo
        mine = (slot >= 0) & (slot < n_loc)
        ls = torch.clamp(slot, 0, max(0, n_loc - 1))
        kpos_m = kpos.clone()
        if n_loc:
            # a 1-element index: a 0-d one is read back to the host
            at = ls.reshape(1)
            kpos.index_put_((at,), torch.where(mine, offset, kpos[at]).to(
                kpos.dtype))
            kpos_m.index_put_((at,), torch.where(
                mine, torch.full_like(offset, -1), kpos_m[at]).to(
                    kpos_m.dtype))
        new = {f"p{p}": [] for p in range(self.P)}
        for r in range(self.R):
            for p in range(self.P):
                lay = cache["layers"][f"p{p}"]
                cp = {name: a[r] for name, a in lay.items()}
                lp = self._layer_local(params, layout, p, r)
                x, nc, _ = self._sublayer(p, lp, x, positions, tables, cp,
                                          kpos_m, True, layout=layout)
                new[f"p{p}"].append(nc)
        for p in range(self.P):
            old = cache["layers"][f"p{p}"]
            for name, dst in old.items():
                if self._kind(p) != "attn":  # conv/SSM states: (B, ...)
                    for r, nc in enumerate(new[f"p{p}"]):
                        dst[r].copy_(nc[name])
                    continue
                upd = torch.stack([nc[name] for nc in new[f"p{p}"]])
                if n_loc:
                    dst.index_copy_(2, at, torch.where(mine, upd[:, :, :1].to(
                        dst.dtype), dst.index_select(2, at)))
        x = layers.apply_norm(params["final_norm"], x, cfg.norm,
                              policy=self.policy)
        logits = self._gather_batch(
            self._logits_sharded(params, x, layout)[:, 0].float(), layout)
        logits[:, cfg.vocab_size:] = -torch.inf
        next_tok = torch.argmax(logits, dim=-1)
        return logits, next_tok, {"layers": cache["layers"], "kpos": kpos,
                                  "offset": offset + 1}


def _stack(trees: list) -> dict:
    """A list of identical trees -> one tree of (R, ...) leaves.  The
    leaves are popped from the given trees as they are stacked, so a
    full-width parameter tree is held about once, not twice."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(first)}
    return torch.stack(trees)


def _layer_params(tree: dict, r: int) -> dict:
    """Layer r's parameters: every stacked leaf indexed on its R axis
    (int8 serving weights too: `wq` (R, din, dout), `wscale` (R, dout))."""
    return tree_map(lambda a: a[r], tree)

