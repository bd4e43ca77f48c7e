"""Streaming ASR engine: B utterance slots, ONE slot-batched decoding step.

Port of `repro/serving/asr.py`.  The decoding step — acoustic scoring
(MFCC with the fused logmel tail, then the TDS kernel sequence) and one
hypothesis expansion per emitted acoustic frame — runs over a GATHERED
sub-batch of slots: every TDS product sees the slot axis folded into
its rows, and the expansion gathers the shared lexicon trie and bigram
table once over the flattened slot index set.
Each slot keeps its own sample buffer; TDS left context and `BeamState`
carry a leading slot axis on the engine's device.

Window bookkeeping is the setup-thread arithmetic from core/features:
`frames_producible` decides whether a slot can step, `consumed_samples`
how many samples a step retires (the MFCC framing overlap stays
buffered).  With several windows buffered (`serve(utterances)`), one
step consumes up to `AsrProgram.max_windows_per_step` of them, each
extracted exactly as a one-window step would see it.  The scheduler
picks the window count w retiring the most windows (w x eligible slots,
largest w on ties) and gathers exactly the eligible slots into the
smallest covering power-of-two slot bucket.

Under a serving mesh (`EngineConfig.mesh`, a `launch.mesh.Mesh`) the
engine runs SPMD, one copy per rank: every rank is fed the same sessions
and holds the same host state (sample buffers, owners, schedule), so
every rank makes the same scheduling decisions and calls the same
collectives in the same order.  FC/head weights are this rank's
feature-axis shards (the forward all-reduces over 'model').  With a
'data' axis each rank holds only its data shard's slots, global slots
[d*sps, (d+1)*sps) (sps = n_slots / n_data): a step assembles a
shard-aligned batch, every shard the same local bucket, and each rank
steps its own rows and writes back only its real ones.  A readout of a
slot held by another data shard reaches every rank by an object
broadcast over the 'data' axis, so `serve()` returns the same list on
every rank.  No host decision reads a rank's own clock, id or thread:
session deadlines are rank 0's (`_reap_deadlines` broadcasts the sids
its clock finds overdue over the whole mesh; the network server's rank 0
sends them in its command stream instead, `serving.server`).

Commit discipline: a step builds new pool tensors and assigns them only
after the whole step succeeded, so a step that raises leaves pool state,
sample buffers and metrics as they were — the invariant the
probe-bisection quarantine (`_step_isolated`) replays depend on.

Transfer discipline: the step runs inside `no_implicit_transfers()`
(`analysis.guards`; on the card the sync debug mode in error), so a
host read in it raises.  Its only host-to-device traffic is the batch
and slot uploads, through pinned memory with `non_blocking=True`.

Two API layers:
  * slot level — `feed_slot` / `pump` / `slot_best` / `reset_slot`
    (what the deprecated ASRPU command shims in core/scheduler drive).
  * session level — `open()` -> Session.push/poll/finish, plus the
    `serve(utterances)` convenience (continuous batching over whole
    utterances, results in input order).
"""
from __future__ import annotations

from collections import deque
from typing import List

import numpy as np
import torch

from repro_torch.analysis.guards import no_implicit_transfers
from repro_torch.core import decoder as dec
from repro_torch.core import features, treeutil
from repro_torch.device import resolve_device
from repro_torch.models import tds
from repro_torch.serving.config import AsrProgram, EngineConfig
from repro_torch.serving.engine import (Engine, Session, SessionFaulted,
                                        copy_result, worker_only)


def empty_hypothesis() -> dict:
    """Readout when no beam exists yet (nothing decoded): same keys as a
    real `decoder.materialize_best` payload, -inf score."""
    return {"words": np.zeros((0,), np.int32),
            "tokens": np.zeros((0,), np.int32), "score": -np.inf}


class AsrEngine(Engine):
    """`device=None` runs on the card and raises when there is none; pass
    ``device="cpu"`` to run on the CPU (the kernels' plain versions)."""

    def __init__(self, config: EngineConfig, params, device=None):
        if not isinstance(config.program, AsrProgram):
            raise TypeError(f"AsrEngine needs an AsrProgram, got "
                            f"{type(config.program)!r}")
        self.device = resolve_device(device)
        super().__init__(config)
        self.program: AsrProgram = config.program
        self.plan = self.program.step_plan()
        fc = self.program.feat_cfg
        nfr = self.plan.feat_frames_per_step
        # samples retired per step / needed buffered for a full window
        self._spp = features.consumed_samples(nfr, fc)
        self._need = fc.frame_len + (nfr - 1) * fc.frame_shift
        # samples a step retains for MFCC framing overlap: buffered
        # samples beyond this were never covered by a decoded frame
        self._overlap = self._need - self._spp
        assert self._spp == self.plan.samples_per_step, \
            (self._spp, self.plan.samples_per_step)
        assert features.frames_producible(self._need, fc) == nfr
        mesh = config.mesh
        # 2D ('data', 'model') mesh: the slot pool itself is sharded, each
        # data shard holding n_slots / n_data contiguous slots (slot s on
        # shard s // slots_per_shard); mesh=None and 1D ('model',) meshes
        # keep the whole pool on every rank
        self._model_axis = mesh.axis("model") if mesh is not None else None
        self._data_axis = (mesh.axis("data") if mesh is not None
                           and "data" in mesh.axis_names else None)
        self._n_data = self._data_axis.size if self._data_axis else 1
        # every rank of a multi-rank mesh: where rank 0's decisions go
        self._whole = (mesh.axis(tuple(mesh.axis_names))
                       if mesh is not None and mesh.size > 1 else None)
        self._slots_per_shard = self.n_slots // self._n_data
        # the first global slot this rank's pool rows hold
        self._slot0 = (self._data_axis.index * self._slots_per_shard
                       if self._data_axis else 0)
        self._buckets = self.program.step_buckets()
        self._slot_buckets = self._make_slot_buckets()
        self.params, self._prepared = self.program.prepare_params(
            params, self.device, mesh)
        self._lex = self.program.lex.to(self.device)
        self._lm = self.program.lm.to(self.device)
        # the MFCC's tables go to the device now, not in a first step
        # (which runs under the host-sync guard)
        features._tables(fc, self.device)
        self._reset_pool()

    # ---- the fused decoding step -------------------------------------
    def _make_slot_buckets(self):
        """Ascending per-shard sub-batch sizes a gathered step may run
        at: powers of two, topped by slots_per_shard (n_slots without a
        'data' axis).  With one, the step's batch is bucket * n_data
        rows, every shard the same local bucket."""
        out, b = [], 1
        while b < self._slots_per_shard:
            out.append(b)
            b *= 2
        out.append(self._slots_per_shard)
        return tuple(sorted(set(out)))

    def acoustic(self, samples: torch.Tensor, stream_state: dict,
                 kernels=None):
        """Acoustic scoring of a gathered batch: samples (b, w, need)
        -> (log_probs (b, w*frames, V), new stream state).  `kernels`
        overrides the engine's policy (used to compare the two paths on
        one batch)."""
        prog = self.program
        nfr = self.plan.feat_frames_per_step
        kernels = self.config.kernels if kernels is None else kernels
        b, w, _ = samples.shape
        feats = features.mfcc(samples, prog.feat_cfg, use_logmel=True,
                              kernels=kernels)[:, :, :nfr]
        feats = feats.reshape(b, w * nfr, -1)
        return tds.forward_batched(self.params, prog.tds_cfg, feats,
                                   stream_state, use_int8=prog.use_int8,
                                   kernels=kernels, prepared=self._prepared,
                                   axis=self._model_axis,
                                   overlap=self.config.overlap_psum)

    def _run_step(self, stream_state, beam_state, samples, slots,
                  write=None):
        """One slot-batched decoding step over a GATHERED sub-batch.
        samples: (b, w, need) — w buffered windows for each of the b
        gathered slots; slots: (b,) pool rows.  `write` (data-sharded
        pools): a (n,) tensor of the batch rows to write back, this
        shard's real ones; the pad rows (which read pool row 0) write
        nothing.  Index -1 cannot mark them, as in the reference's
        drop-mode scatter: torch wraps it to the last row.  Every input
        is on the engine's device already (`_step_slots` uploads them),
        so nothing here moves data to or from the host.  Returns NEW
        pool tensors; the inputs are not modified."""
        prog = self.program
        ss = treeutil.tree_map(lambda a: a[slots], stream_state)
        bs = treeutil.tree_map(lambda a: a[slots], beam_state)
        logp, new_ss = self.acoustic(samples, ss)
        for t in range(logp.shape[1]):     # one frame, all gathered slots
            bs = dec.expand_step_batched(bs, logp[:, t], self._lex,
                                         self._lm, prog.dec_cfg,
                                         self.config.kernels)

        # Scatter back into copies of the pool.  Bucket padding repeats
        # row 0's slot index; its duplicate rows computed the same update
        # (up to the unordered atomics of the plain version's
        # scatter_add on the card), so index_put's choice among
        # duplicate writes is safe.
        if write is None:
            def put(full, new):
                return full.index_put((slots,), new)
        else:
            dst = slots[write]

            def put(full, new):
                return full.index_put((dst,), new[write])
        return (treeutil.tree_map(put, stream_state, new_ss),
                treeutil.tree_map(put, beam_state, bs))

    # ---- slot-pool state ---------------------------------------------
    def _reset_pool(self) -> None:
        self._slot_bufs: List[np.ndarray] = [
            np.zeros((0,), np.float32) for _ in range(self.n_slots)]
        self._slot_steps = np.zeros((self.n_slots,), np.int64)
        self._stream_state = None
        self._beam = None
        # (n_active, slot bucket b, window bucket w) per fused step,
        # bounded so a long-lived streaming engine does not grow
        self.step_shapes: deque = deque(maxlen=4096)

    def _ensure_state(self) -> None:
        if self._stream_state is not None:
            return
        # build both, then commit both: a failure cannot leave the pool
        # with a stream state but no beam.  This rank's rows only: its
        # data shard's slots
        stream_state = tds.init_batched_stream_state(
            self.program.tds_cfg, self._slots_per_shard, self.device)
        beam = dec.init_batched_state(
            self._slots_per_shard, self.program.dec_cfg.beam_size, self._lm,
            self.device)
        self._stream_state = stream_state
        self._beam = beam

    def adopt_state(self, old: "AsrEngine") -> None:
        """Take over another engine's in-flight slot-pool state (sample
        buffers, left context, beam, step counts).  The deprecated
        configure-command shims use it: they rebuild the engine on
        reconfiguration without losing mid-utterance state."""
        if old.n_slots != self.n_slots or old.device != self.device:
            raise ValueError(f"adopt_state: {old.n_slots} slots on "
                             f"{old.device} into {self.n_slots} slots on "
                             f"{self.device}")
        self._slot_bufs = old._slot_bufs
        self._slot_steps = old._slot_steps
        self._stream_state = old._stream_state
        self._beam = old._beam
        self.n_steps = old.n_steps

    def reset_slot(self, slot: int) -> None:
        """Utterance boundary in one slot: clear its buffer, left
        context and hypothesis memory; other slots are untouched.  The
        device reset runs first (on the ranks holding the slot) and
        commits both trees together."""
        row = self._local_row(slot)
        if self._stream_state is not None and row is not None:
            new_stream = tds.reset_stream_slot(self._stream_state, row,
                                               self.program.tds_cfg)
            new_beam = dec.reset_slot(self._beam, row, self._lm)
            self._stream_state, self._beam = new_stream, new_beam
        self._slot_bufs[slot] = np.zeros((0,), np.float32)
        self._slot_steps[slot] = 0

    def _local_row(self, slot: int):
        """This rank's pool row of global `slot`, or None when another
        data shard holds it."""
        row = slot - self._slot0
        return row if 0 <= row < self._slots_per_shard else None

    def feed_slot(self, slot: int, samples) -> None:
        """Append raw samples to one slot's stream buffer (initializing
        the carried state, so a readout after a partial first chunk sees
        a fresh beam)."""
        self._ensure_state()
        self._slot_bufs[slot] = np.concatenate(
            [self._slot_bufs[slot], np.asarray(samples, np.float32)])

    def slot_windows(self, slot: int) -> int:
        """Setup-thread check: whole step_ms windows buffered in a slot."""
        return features.frames_producible(
            self._slot_bufs[slot].shape[0],
            self.program.feat_cfg) // self.plan.feat_frames_per_step

    def slot_can_step(self, slot: int) -> bool:
        """A full window of whole frames buffered."""
        return self.slot_windows(slot) >= 1

    @worker_only
    def _step(self) -> bool:
        """One fused decoding step over a gathered sub-batch: the window
        count `w` retiring the most buffered windows (largest w on
        ties), over exactly the slots holding >= w windows, padded to
        the smallest covering slot bucket.  False (and nothing runs)
        when no slot can produce output."""
        self._flush_finished_tails()
        avail = np.array([self.slot_windows(s)
                          for s in range(self.n_slots)])
        if not (avail >= 1).any():
            return False
        w = max((b for b in self._buckets if (avail >= b).any()),
                key=lambda b: (b * int((avail >= b).sum()), b))
        slots = [s for s in range(self.n_slots) if avail[s] >= w]
        self._ensure_state()
        self._step_isolated(slots, w)
        return True

    def _step_isolated(self, slots, w) -> None:
        """Run one gathered step with poison-slot isolation.  On failure
        the step is REPLAYED on bisected halves in probe mode
        (`_step_slots(..., commit=False)`) until the failure pins to
        single slots; probes commit nothing, and assembly is
        non-destructive, so every replay sees the same inputs.  The
        pinned sessions alone are evicted with a typed `SessionFaulted`,
        then the survivors step together in one committed call.  A
        failure no probe reproduces gets one committed full-set retry; a
        second failure propagates to the pool quarantine.  Slot-level
        callers have no session to evict, so the fault re-raises."""
        try:
            self._step_slots(slots, w)
            return
        except Exception as exc:
            if len(slots) == 1:
                sess = self._owner[slots[0]]
                if sess is None:      # slot-level API: nothing to evict
                    raise
                self._fault_session(sess, SessionFaulted(
                    sess.sid, f"decoding step failed: {exc}", cause=exc))
                return
            root = exc
        mid = len(slots) // 2              # the full set just failed:
        bad = (self._probe_step_faults(slots[:mid], w)     # probe halves
               + self._probe_step_faults(slots[mid:], w))
        if not bad:
            # unreproducible under probes: one committed full-set retry,
            # then give up to the pool quarantine
            try:
                self._step_slots(slots, w)
            except Exception:
                raise root
            return
        for s, exc in bad:
            sess = self._owner[s]
            if sess is None:          # slot-level API: nothing to evict
                raise exc
            self._fault_session(sess, SessionFaulted(
                sess.sid, f"decoding step failed: {exc}", cause=exc))
        survivors = [s for s in slots if s not in {b for b, _ in bad}]
        if survivors:
            self._step_isolated(survivors, w)

    def _probe_step_faults(self, slots, w):
        """Bisection probe: non-committing `_step_slots` replays that pin
        a gathered-step failure to its slots.  Returns [(slot, exc)] for
        every slot whose singleton replay fails."""
        try:
            self._step_slots(slots, w, commit=False)
            return []
        except Exception as exc:
            if len(slots) == 1:
                return [(slots[0], exc)]
            mid = len(slots) // 2
            return (self._probe_step_faults(slots[:mid], w)
                    + self._probe_step_faults(slots[mid:], w))

    def _step_slots(self, slots, w, commit: bool = True) -> None:
        """One fused step over exactly `slots` at window count `w`,
        committed ONLY on success.  `commit=False` runs the step and
        discards the result (the isolation probe)."""
        batch, idx = self._assemble_batch(slots, w)
        b = idx.shape[0]
        # injection site: before anything goes to the device, so a raised
        # or stalled check leaves no work in flight and nothing committed
        if self._faults is not None:
            self._faults.check(
                "asr_step", slots=tuple(slots),
                sids=tuple(self._owner[s].sid for s in slots
                           if self._owner[s] is not None))
        write = None
        if self._data_axis is not None:
            # this shard's rows of the shard-aligned batch; pad rows
            # (index -1) read pool row 0 and write nothing
            bloc = b // self._n_data
            mine = slice(self._data_axis.index * bloc,
                         (self._data_axis.index + 1) * bloc)
            valid = idx[mine] >= 0
            batch = batch[mine]
            idx = np.where(valid, idx[mine] - self._slot0, 0)
            write = np.flatnonzero(valid)
        # transfer-guarded: the uploads are the only host-to-device
        # traffic of a step, and nothing in it may wait on the card (a
        # host read inside raises; the mesh's collectives lift the guard
        # for their own staging)
        with no_implicit_transfers():
            kw = {} if write is None else {"write": self._upload(write)}
            new_ss, new_beam = self._run_step(
                self._stream_state, self._beam, self._upload(batch),
                self._upload(idx), **kw)
        if not commit:
            return
        self._stream_state, self._beam = new_ss, new_beam
        self._retire(slots, w)
        self._slot_steps[slots] += w
        self.n_steps += 1
        self.step_shapes.append((len(slots), b, w))
        self.metrics.on_step(len(slots), b)
        for s in slots:
            if self._owner[s] is not None:      # slot-level API has no owner
                self.metrics.on_first_result(self._owner[s])

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device without a host wait: on
        the card through pinned memory, `non_blocking` (a blocking copy
        of pageable memory synchronises)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _assemble_batch(self, slots, w):
        """Gather each eligible slot's next `w` buffered windows into a
        bucket-padded (b, w, samples_per_window) batch plus its (b,)
        int64 slot-index vector.  Assembly is non-destructive: `_retire`
        consumes the samples only after the step succeeded.

        Without a 'data' axis, b is the smallest slot bucket covering
        len(slots); padding duplicates row 0 and its slot index.  With
        one, the batch is shard-aligned: slots group by home shard,
        every shard gets the same local bucket `bloc` (the smallest
        covering the largest group), so shard d's slots sit at rows
        [d*bloc, (d+1)*bloc); pad rows are zeros with index -1 (a shard
        with no eligible slot has no row to duplicate)."""
        if self._data_axis is None:
            b = next(x for x in self._slot_buckets if x >= len(slots))
            batch = np.zeros((b, w, self._need), np.float32)
            for j, s in enumerate(slots):
                self._fill_row(batch, j, s, w)
            batch[len(slots):] = batch[0]  # bucket padding: duplicate rows
            idx = np.array(slots + slots[:1] * (b - len(slots)), np.int64)
            return batch, idx
        sps = self._slots_per_shard
        groups = [[s for s in slots if s // sps == d]
                  for d in range(self._n_data)]
        bloc = next(x for x in self._slot_buckets
                    if x >= max(len(g) for g in groups))
        batch = np.zeros((bloc * self._n_data, w, self._need), np.float32)
        idx = np.full((bloc * self._n_data,), -1, np.int64)
        for d, group in enumerate(groups):
            for j, s in enumerate(group):
                self._fill_row(batch, d * bloc + j, s, w)
                idx[d * bloc + j] = s
        return batch, idx

    def _fill_row(self, batch, row, slot, w):
        """Extract slot's next w windows into one batch row, window by
        window, exactly as w=1 steps would see them."""
        for i in range(w):
            off = i * self._spp
            batch[row, i] = self._slot_bufs[slot][off:off + self._need]

    def _retire(self, slots, w):
        """Retire the samples a successful step consumed, keeping the
        MFCC framing overlap buffered."""
        for s in slots:
            self._slot_bufs[s] = self._slot_bufs[s][w * self._spp:]

    def _flush_finished_tails(self) -> None:
        """Zero-pad the trailing partial window of finished slots so the
        next step decodes it (otherwise up to a window of tail audio,
        often the end of the last word, is dropped).  Only slots whose
        buffer holds samples never covered by a decoded frame (more than
        the retained framing overlap) are padded, to exactly one full
        window, so a flush runs at most once per session.  Programs
        with `flush_tail=False` (the command shims) never flush."""
        if not self.program.flush_tail:
            return
        for slot, sess in enumerate(self._owner):
            if sess is None or not sess.finished:
                continue
            n = self._slot_bufs[slot].shape[0]
            if n > self._overlap and not self.slot_can_step(slot):
                self._slot_bufs[slot] = np.concatenate(
                    [self._slot_bufs[slot],
                     np.zeros((self._need - n,), np.float32)])

    def pump(self) -> int:
        """Run decoding steps until no slot has a full window left;
        returns the number of steps."""
        n = 0
        while self._step():
            n += 1
        return n

    def slot_best(self, slot: int, final: bool = False) -> dict:
        """Best hypothesis of one slot as host arrays; final=True commits
        a pending utterance-final word (the stored beam is not
        advanced).  Under a 'data' axis the ranks holding the slot read
        it out and broadcast it over 'data' (every rank calls this
        alike)."""
        if self._beam is None:
            return empty_hypothesis()
        row = self._local_row(slot)
        res = None
        if row is not None:
            st = dec.slot_state(self._beam, row)
            if final:
                st = dec.finalize(st, self._lex, self._lm,
                                  self.program.dec_cfg)
            res = dec.materialize_best(dec.best(st))
        if self._data_axis is None:
            return res
        return self._data_axis.broadcast_object(
            res, slot // self._slots_per_shard)

    def _reap_deadlines(self) -> bool:
        """Reap the overdue sessions.  Under a mesh of several ranks
        rank 0's clock decides, and its sids reach every rank by an
        object broadcast over the whole mesh (every rank pumps in
        lockstep), so the ranks evict the same sessions."""
        if self._whole is None or self.session_deadline is None:
            return super()._reap_deadlines()
        return self._reap(self._whole.broadcast_object(self._overdue(), 0))

    def _digest(self) -> tuple:
        return super()._digest() + (
            tuple(self._slot_steps.tolist()),
            tuple(b.shape[0] for b in self._slot_bufs))

    # ---- session mechanics -------------------------------------------
    def _readout(self, session: Session) -> dict:
        """Current best hypothesis WITHOUT driving the engine (the
        in-process `Session.poll` would run `_advance` to quiescence).
        Under a 'data' axis a live readout is a broadcast over it, which
        every rank must make alike."""
        if session.done:
            return copy_result(session.result)
        if session.admitted:
            res = self.slot_best(session.slot)
            res["steps"] = int(self._slot_steps[session.slot])
            return copy_result(res)
        return self._empty_result()

    def _push(self, session: Session, chunk) -> None:
        chunk = np.asarray(chunk, np.float32)
        # reject poison input BEFORE buffering
        self.program.validate_input(chunk)
        if session.admitted:
            self.feed_slot(session.slot, chunk)
        elif session._pending is None:
            session._pending = chunk
        else:
            session._pending = np.concatenate([session._pending, chunk])
        self._admit()          # fill freed slots; stepping waits for poll

    def _poll(self, session: Session) -> dict:
        self._advance()
        if session.done:
            return copy_result(session.result)
        if session.admitted:
            res = self.slot_best(session.slot)
            res["steps"] = int(self._slot_steps[session.slot])
            return copy_result(res)
        return self._empty_result()

    def _empty_result(self) -> dict:
        return dict(empty_hypothesis(), steps=0)

    def _admit_to_slot(self, session: Session, slot: int) -> None:
        self.reset_slot(slot)
        if session._pending is not None:
            self.feed_slot(slot, session._pending)

    def _ready_to_close(self, session: Session, slot: int) -> bool:
        if not (session.finished and not self.slot_can_step(slot)):
            return False
        # not closeable while a tail flush is pending
        return (not self.program.flush_tail
                or self._slot_bufs[slot].shape[0] <= self._overlap)

    def _finalize_slot(self, slot: int) -> dict:
        self._ensure_state()   # finish() before any step still finalizes
        res = self.slot_best(slot, final=True)
        res["steps"] = int(self._slot_steps[slot])
        return copy_result(res)   # stored as session.result: must own it

    def _release_slot(self, slot: int) -> None:
        # eviction mid-utterance: same scrub as an utterance boundary
        self.reset_slot(slot)

    # ---- whole-utterance convenience ---------------------------------
    def serve(self, utterances) -> List[dict]:
        """Continuous batching over whole utterances (audio arrays):
        queued utterances are admitted into freed slots, one step
        advances every eligible slot, drained slots are finalized and
        reused.  Results come back in input order."""
        sessions = [self.open() for _ in utterances]
        for sess, audio in zip(sessions, utterances):
            sess.push(audio)       # buffers + admits only — no steps yet,
        for sess in sessions:      # so admitted slots step batched below
            sess.finish()
        if not all(sess.done for sess in sessions):
            raise RuntimeError(f"sessions left undone: {sessions}")
        return [copy_result(sess.result) for sess in sessions]
