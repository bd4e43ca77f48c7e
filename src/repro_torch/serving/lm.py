"""Batched LM serving engine: a fixed (batch, cache) slot pool.

Port of `repro/serving/lm.py` for one device.  Admission prefills
requests into their slots of the pooled decode cache through BUCKETED
prefill: prompts are right-padded to the smallest covering length
bucket (`LmProgram.buckets()`) and run through ONE masked multi-row
prefill per bucket — the model reads each row's logits at its true last
token and returns per-row cache metadata (see `LM.prefill(lengths=)`).
The prefill batch is padded to the smallest covering pow-2 BATCH
sub-bucket, so admitting one request pays a 1-row prefill, not an
n_slots-row one.  Every engine step is one fused `decode_step` over all
slots (idle slots decode garbage that is never read).  Cache position
metadata is per slot — `kpos` (B, Sc) and `offset` (B,) — so staggered
admissions with unequal prompt lengths keep their own rotary positions
and cache-write slots.

On the card the prefill's attention runs the flash-attention kernel and
every norm the RMSNorm kernel (`EngineConfig.kernels` selects kernel or
plain path); decode attention, the SSD scan, the MoE dispatch and the
matrix products are plain torch.  The decode step writes each new KV
and each Mamba layer's new conv/SSM state into the pool's cache tensors
in place; a prefill group's rows are scattered into them only after the
prefill succeeded (isolation probes write nothing).  An attention-free
model (mamba2) keeps the per-slot position metadata all the same: its
ring width is the program's cache length, and no layer reads it.

Each decode step runs inside `no_implicit_transfers()`
(`analysis.guards`; on the card the sync debug mode in error): its
inputs live on the device, and its one host read, the step's tokens,
comes after the guarded block.

Session protocol: `push(prompt)` submits the request (prefill happens at
admission); `poll()` drives the engine — admitted requests generate
their full `program.max_new` tokens, batched across slots — and returns
this session's tokens (`done=False` only while no prompt has been
pushed).  `finish()` is optional for LM sessions; finishing a session
that never pushed a prompt closes it with an empty result.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.analysis.guards import no_implicit_transfers
from repro_torch.device import resolve_device
from repro_torch.models.transformer import LM, params_from_numpy
from repro_torch.serving.config import EngineConfig, LmProgram
from repro_torch.serving.engine import (Engine, Session, SessionFaulted,
                                        copy_result, worker_only)


class LmEngine(Engine):
    """`device=None` runs on the card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions).
    `params` is the model's parameter tree (torch tensors, or arrays
    such as the reference's, carried across with `params_from_numpy`)."""

    def __init__(self, config: EngineConfig, params, device=None):
        if not isinstance(config.program, LmProgram):
            raise TypeError(f"LmEngine needs an LmProgram, got "
                            f"{type(config.program)!r}")
        if config.mesh is not None:
            raise NotImplementedError(
                "EngineConfig.mesh (model-parallel serving) is wired for "
                "the ASR engine; LM serving shards through launch/steps.py "
                "build_cell instead")
        self.device = resolve_device(device)
        super().__init__(config)
        self.program: LmProgram = config.program
        self.lm = LM(self.program.model_cfg, policy=config.kernels)
        self.params = params_from_numpy(params, self.device)
        self._buckets = self.program.buckets()
        self._batch_buckets = self._make_batch_buckets()
        # sliding-window archs clamp the allocated ring to attn_window;
        # all admission-time position metadata must use the real width
        self._ring_len = self.lm.cache_len(self.program.cache_len)
        self._reset_pool()
        assert self._ring == self._ring_len, (self._ring, self._ring_len)

    def _make_batch_buckets(self):
        """Ascending prefill batch sizes (powers of two, topped by
        n_slots): an admission group is padded to the smallest covering
        one, so a lone admit prefills 1 row instead of n_slots."""
        out, b = [], 1
        while b < self.n_slots:
            out.append(b)
            b *= 2
        out.append(self.n_slots)
        return tuple(sorted(set(out)))

    def prefill_cache_entries(self) -> Optional[int]:
        """Number of compiled prefill variants: None, as the reference
        reports when its jit cache does not expose a size (PyTorch runs
        eagerly; the prefill shapes are bounded by the buckets all the
        same)."""
        return None

    # ---- slot-pool state ---------------------------------------------
    def _reset_pool(self) -> None:
        B = self.n_slots
        self.cache = self.lm.init_cache(B, self.program.cache_len,
                                        per_slot=True, device=self.device)
        self._ring = int(self.cache["kpos"].shape[1])
        self._tokens = torch.zeros((B, 1), dtype=torch.int64,
                                   device=self.device)
        self._gen: List[Optional[list]] = [None] * B
        self._rem = np.zeros((B,), np.int64)

    # ---- session mechanics -------------------------------------------
    def _admittable(self, session: Session) -> bool:
        return session._pending is not None    # prompt pushed

    def _push(self, session: Session, prompt) -> None:
        if session._pending is not None or session.admitted or session.done:
            raise RuntimeError(
                f"session {session.sid}: LM sessions take one prompt")
        # validate before the int32 cast (which would mask a float or
        # garbage dtype) and before any reshape (which would mask a
        # matrix pushed where a token vector belongs)
        self.program.validate_input(np.asarray(prompt))
        session._pending = np.asarray(prompt, np.int32)
        self._admit()          # prefill now if a slot is free

    def _poll(self, session: Session) -> dict:
        self._advance()
        if session.done:
            return copy_result(session.result)
        # _advance runs admitted generation to completion and drains the
        # queue through freed slots, so the only session left un-done is
        # one whose prompt has not been pushed yet
        return {"tokens": [], "done": False}

    def _empty_result(self) -> dict:
        return {"tokens": [], "done": True}

    # ---- bucketed admission ------------------------------------------
    def _bucket(self, plen: int) -> int:
        for b in self._buckets:
            if plen <= b:
                return b
        return self._buckets[-1]   # unreachable: validate_prompt caps plen

    @worker_only
    def _admit(self) -> bool:
        """Admit every admissible queued session into the free slots,
        grouped by prompt-length bucket: one masked multi-row prefill
        per bucket."""
        free = [s for s in range(self.n_slots) if self._owner[s] is None]
        ready = [s for s in self._queue if self._admittable(s)][:len(free)]
        if not ready:
            return False
        groups: dict = {}
        for sess, slot in zip(ready, free):
            self._queue.remove(sess)
            self._owner[slot] = sess
            sess.slot = slot
            b = self._bucket(int(sess._pending.shape[0]))
            groups.setdefault(b, []).append((sess, slot))
        for b, group in sorted(groups.items()):
            self._prefill_isolated(b, group)
        for sess in ready:
            if sess.fault is None:      # prefill isolation may have evicted
                sess._pending = None
                self.metrics.on_admit(sess)
        self.metrics.sample_queue_depth(len(self._queue))
        return True

    def _prefill_isolated(self, bucket: int, group) -> None:
        """Run one bucket's batched prefill with poison-prompt
        isolation: on failure, bisection PROBES
        (`_prefill_group(..., commit=False)`) pin the failure to its
        (session, slot) rows, only those sessions are evicted
        (`SessionFaulted`; their slots release for the next admit), and
        the healthy rest re-prefills together in one committed call.
        Replays are safe because probes write nothing and the committed
        prefill rewrites its group's cache rows wholesale from the
        still-pending prompts.  A failure no probe reproduces gets one
        committed full-group retry, then propagates to the pool
        quarantine."""
        try:
            self._prefill_group(bucket, group)
            return
        except Exception as exc:
            if len(group) == 1:
                sess, _slot = group[0]
                self._fault_session(sess, SessionFaulted(
                    sess.sid, f"prefill failed: {exc}", cause=exc))
                return
            root = exc
        mid = len(group) // 2              # the full group just failed:
        bad = (self._probe_prefill_faults(bucket, group[:mid])
               + self._probe_prefill_faults(bucket, group[mid:]))
        if not bad:
            try:
                self._prefill_group(bucket, group)
            except Exception:
                raise root
            return
        for (sess, _slot), exc in bad:
            self._fault_session(sess, SessionFaulted(
                sess.sid, f"prefill failed: {exc}", cause=exc))
        bad_sids = {sess.sid for (sess, _slot), _ in bad}
        survivors = [(s, slot) for s, slot in group
                     if s.sid not in bad_sids]
        if survivors:
            self._prefill_isolated(bucket, survivors)

    def _probe_prefill_faults(self, bucket: int, group):
        """Bisection probe: non-committing `_prefill_group` replays that
        pin a batched-prefill failure to its rows.  Returns
        [((sess, slot), exc)] for every row whose singleton replay
        fails."""
        try:
            self._prefill_group(bucket, group, commit=False)
            return []
        except Exception as exc:
            if len(group) == 1:
                return [(group[0], exc)]
            mid = len(group) // 2
            return (self._probe_prefill_faults(bucket, group[:mid])
                    + self._probe_prefill_faults(bucket, group[mid:]))

    def _admit_to_slot(self, session: Session, slot: int) -> None:
        # kept for the Engine slot-mechanics contract; the overridden
        # `_admit` batches admissions, so this is the 1-session case
        self._prefill_group(self._bucket(int(session._pending.shape[0])),
                            [(session, slot)])

    def _prefill(self, tokens: torch.Tensor, lengths: torch.Tensor):
        """One masked prefill of a padded (B, bucket) batch, its cache
        assembled at the pool's ring width."""
        return self.lm.prefill(self.params, {"tokens": tokens},
                               lengths=lengths, cache_len=self._ring_len)

    def _prefill_group(self, bucket: int, group, commit: bool = True) -> None:
        # pad to the smallest covering batch sub-bucket: a 1-request
        # admission runs a 1-row prefill instead of n_slots rows
        if self._faults is not None:
            self._faults.check("lm_prefill",
                               sids=tuple(s.sid for s, _ in group))
        B = next(b for b in self._batch_buckets if b >= len(group))
        toks = np.zeros((B, bucket), np.int32)
        lens = np.ones((B,), np.int32)
        for i, (sess, _) in enumerate(group):
            prompt = sess._pending
            assert prompt is not None, f"session {sess.sid} pushed no prompt"
            toks[i, :prompt.shape[0]] = prompt
            lens[i] = prompt.shape[0]
        logits, pc = self._prefill(torch.from_numpy(toks).to(self.device),
                                   torch.from_numpy(lens).to(self.device))
        if not commit:                # isolation probe: discard
            return
        # scatter the whole group at once: rows 0..G-1 of the prefill
        # cache land in the group's pool slots with one advanced-index
        # write per cache leaf — KV (rows ring-aligned already) and the
        # Mamba layers' conv/SSM states alike — and one host read takes
        # every first token
        G = len(group)
        slots = torch.tensor([slot for _, slot in group], device=self.device)
        for name, lay in self.cache["layers"].items():
            for leaf, dst in lay.items():
                dst[:, slots] = pc["layers"][name][leaf][:, :G].to(dst.dtype)
        self.cache["kpos"][slots] = pc["kpos"][:G]
        self.cache["offset"][slots] = pc["offset"][:G]
        vocab = self.program.model_cfg.vocab_size
        firsts = torch.argmax(logits[:G, :vocab], dim=-1)
        self._tokens[slots, 0] = firsts
        for (sess, slot), first in zip(group, firsts.tolist()):
            self._gen[slot] = [first]
            self._rem[slot] = self.program.max_new - 1
            self.metrics.on_first_result(sess)
        # the padded prefill batch is one dispatch of B bucket rows
        self.metrics.on_step(len(group), B)

    @worker_only
    def _step(self) -> bool:
        live = [s for s in range(self.n_slots)
                if self._owner[s] is not None and self._rem[s] > 0]
        if not live:
            return False
        with no_implicit_transfers():   # decode inputs live on device
            _, tok, self.cache = self.lm.decode_step(
                self.params, self.cache, {"tokens": self._tokens})
        self._tokens = tok[:, None]
        self.n_steps += 1
        self.metrics.on_step(len(live), self.n_slots)
        toks = tok.tolist()            # one host read per step
        for s in live:
            self._gen[s].append(toks[s])
            self._rem[s] -= 1
        return True

    def _ready_to_close(self, session: Session, slot: int) -> bool:
        return self._rem[slot] <= 0

    def _finalize_slot(self, slot: int) -> dict:
        out = {"tokens": list(self._gen[slot]), "done": True}
        self._gen[slot] = None
        return out

    def _release_slot(self, slot: int) -> None:
        # evicted mid-generation: drop the generation bookkeeping; the
        # cache rows are rewritten wholesale by the slot's next prefill
        self._gen[slot] = None
        self._rem[slot] = 0

    # ---- whole-batch convenience -------------------------------------
    def serve(self, prompts) -> List[list]:
        """Continuous batching over a list of prompts; returns the
        generated token lists in input order."""
        sessions = [self.open() for _ in prompts]
        for sess, prompt in zip(sessions, prompts):
            sess.push(prompt)      # admission/prefill only — steps batch
        results = [sess.poll() for sess in sessions]
        assert all(r["done"] for r in results), results
        return [r["tokens"] for r in results]
