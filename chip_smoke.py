#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: the streaming ASR decode path,
batched LM serving (dense, SSM and MoE families), the standalone
beam-threshold prune, the network front-end, training (CTC training
of the full-width TDS model, the LM trainer at full width), the rest
of the LM stack (M-RoPE and frontend embeddings, the LM's bf16 LayerNorm,
int8 LM serving weights), the sharded ASR serving step (a mesh of
`torch.distributed` ranks, here sharing the one card), the sharded
LM serving cells (`launch/steps.build_cell` on such a mesh), the
network server on such a mesh (`--serve --mesh`), LM training on
such a mesh (`launch/train.py --mesh`), the rest of the multi-device
layer (elastic restart with a sharded checkpoint, int8 gradient
compression, the pipeline) and the dry-run tooling's counts against
measured cells (`launch/dryrun.py`, `op_cost.py`, `roofline.py`).

    python3 chip_smoke.py [--before DIR] [--only-phase 24|25|26|27|28]

`--before DIR` (a checkout of the parent commit) also times DIR's
logmel and beam_prune kernels beside this checkout's.  `--only-phase
N` builds, then runs phase N alone (24 after serving phase 5's system
for its references) and prints no ok line.

Phases, in order; any failure exits non-zero (no phase is caught):
  1. build   — nvcc builds the eight Hopper kernels from the seven sources
               in src/repro_torch/kernels/csrc/ (one process per source).
  2. kernels — each kernel vs its plain PyTorch version on the card at
               the main path's shapes: the fused MFCC (`logmel.mfcc`, the
               whole of `features.mfcc` in one launch) at the (b, w,
               1520) sample blocks of a b=4, w=4 and a b=1, w=1 step and
               a 1-D signal of 23 frames, the logmel tail on power rows;
               int8_matmul bitwise at the FC/head
               shapes of a b=4, w=4 and a b=1, w=1 step and two ragged
               ones, fused with the row quantization (the main path's)
               and on pre-quantized rows; tds_conv at every conv of a
               b=4, w=4 and a b=1, w=1 step, the 17 with their LayerNorm
               fused in (`tds_conv_ln`) in both designs (a cluster per row, a
               block per row); layernorm at every LayerNorm launched on
               its own (`bias_residual_layernorm`: fc2's bias and the FC
               block's residual in, and final_ln without); int8_matmul
               also at the sharded step's shapes (K = 600/760/920 over 2
               ranks, 300/380/460 over 4; the full N and the overlap's
               two column chunks), pre-quantized, bitwise.
  3. demo    — the demo system through `AsrEngine` at 1 and 4 slots,
               fp32 and int8 programs, KernelPolicy("kernel") vs
               KernelPolicy("ref"): equal words and tokens, scores close.
  4. shim    — the deprecated ASRPU command API streams one demo
               utterance through the int8 program on the card and must
               match `AsrEngine`'s result; every kernel launches.
  5. full    — the paper's TDS_CONFIG (widths 1200/1520/1840, V=9000)
               with the default decoder (K=128, C=32) and seeded random
               weights serves 8 synthetic utterances over 4 slots, once
               with the fp32 and once with the int8 program; every
               kernel's launch count must match the steps taken (one
               logmel, the whole MFCC, with torch.fft.rfft called no
               time; 18 tds_conv, 17 of them with the LayerNorm fused,
               and 15 layernorm launches per step; 29 int8_matmul launches per
               int8 step, each quantizing its own rows: the plain
               `quantize_rows` must run no time), the kernel path's
               log-probs must match the plain path's (int8: also bitwise
               equal with int8_matmul's plain version substituted) and
               its words must equal the plain path's; the warm engine
               serves the 8 again, timed (phase 16's in-process
               throughput).  Then the
               candidate rows the fp32 engine feeds the hypothesis unit
               in a b=4, w=4 step (the utterances' first, and their third
               after two committed steps) are captured by a hook around
               its wrapper, checked against the plain version, and their
               live count L and head count H printed.
  6. timing  — each kernel, its plain version and the library call
               (where one exists) at the full-width step shapes, the
               bound, step times per (b, w) for both programs, a profiler
               breakdown of one step of each.  The fused MFCC beside its
               plain pipeline and an rfft + matmul yardstick.  logmel,
               tds_conv and layernorm also at the b=1, w=1 shapes, the
               fused conv also in its
               block-per-row design, both beside a composite yardstick
               (F.conv2d through cuDNN without TF32, ReLU, residual,
               F.layer_norm; F.layer_norm((y + b) + res)).  The
               hypothesis unit on the captured decoder rows, beside
               synthetic (4, 8320) rows; int8_matmul from fp32 rows
               (quantization included) at b=4, w=4 and b=1, w=1, beside
               pre-quantized rows, the plain `quantize_rows` and
               `quantize_rows` + `torch._int_mm` + rescale.
  LM phases (h2o-danube-1.8b, mamba2-1.3b and qwen2-moe-a2.7b at full
  width, seeded random weights):
  7. lm kernels — flash_attention and rmsnorm vs their plain versions in
               bf16 and fp32 at the three LM paths' shapes: GQA 32/8 with
               D = 80 (h2o-danube), Sq < Skv, a window smaller than S,
               ragged S; MHA 16/16 with D = 128 (qwen2-moe), causal, S =
               512 and 2048 at 1 and 2 rows; rmsnorm at D = 2560, 2048
               and 4096 (mamba2's gated norm over d_inner), rows 1 to
               8192.  bf16 flash runs on the tensor cores (wgmma, P
               rounded to bf16 before P·V) in the TMA design at D = 64,
               80 and 128: each bf16 check must launch it and only it, as
               the C library records the kernel it launched, and names
               it; fp32 flash on the CUDA cores; rmsnorm keeps the row
               in registers with 16-byte loads.
  8. lm serve — bf16 `LmEngine` for h2o-danube-1.8b (4 slots, buckets
               512/2048/6144, 32 new tokens) serves 8 prompts of
               100-6144 tokens, three longer than the 4096 window; launch
               counts must be 24 flash launches per prefill, each of the
               TMA design (`launches_by_design`), and 49 rmsnorm
               launches per forward; prefill time per bucket,
               decode step time, tokens/s.
  9. lm parity — the same model in fp32 served with the kernel and the
               plain policy (4 prompts, one past the window): equal
               tokens, prefill logits close; bf16 prefill logits close.
 10. lm timing — each LM kernel, its plain version and the library call
               at the three paths' bf16 prefill and decode shapes, bounds,
               each flash time with its design, as a share of its bound
               and of the bf16 peak and against SDPA (kernel/sdpa: SDPA
               with `is_causal` where h2o-danube's window of 4096 does
               not bind, S = 512 and 2048, else with the band as a mask;
               both times are kept), each
               rmsnorm time as a share of its bytes bound and
               against F.rms_norm; a profiler breakdown of an h2o-danube
               prefill and decode step.
 11. mamba serve — bf16 `LmEngine` for mamba2-1.3b (48 Mamba-2 layers,
               attention-free; 4 slots, buckets 512/2048/6144, 32 new
               tokens) serves the 8 prompts of phase 8; 97 rmsnorm
               launches a forward (48 norm1, 48 gated, the final one)
               and no flash launch; prefill time per bucket, decode step
               time, tokens/s; a profiler breakdown of a 2048-token
               prefill and a decode step.
 12. moe serve — the same for qwen2-moe-a2.7b (24 layers, 60 experts
               top-4 and a shared expert; buckets 512/2048, 8 prompts of
               100-2048 tokens): 49 rmsnorm launches a forward and 24
               flash launches a prefill; the MoE capacity of each
               prefill printed.
 13. lm2 parity — kernel vs plain policy: fp32 mamba2-1.3b at full width
               (4 prompts, one of 4500 tokens: past 2048, no multiple of
               the SSD chunk) and fp32 qwen2-moe-a2.7b cut to its first 4
               layers (every width kept): equal tokens; qwen2-moe's fp32
               prefill logits close.  Every layer of both at full depth,
               fp32 and bf16, fed the same hidden state on both policies
               at a served prefill shape: outputs within LM_TOL
               (`layer_parity`).  The whole-model logit gaps the random
               deep models amplify (mamba2 fp32 and bf16, qwen2-moe bf16)
               are printed, not held to a limit (see LM_LOGIT_RTOL).
  Prune phases (no serving path calls beam_prune, as in the reference):
 14. prune check — beam_prune vs its plain version, bitwise, at N = 1 to
               8448 with beam 1/5/25, at a ragged N = 4,194,307 (the
               grid path: a max across blocks), just below and above the
               scores the grid path stages in shared memory, and on rows
               holding a NaN, only -inf, +inf, and a score exactly on the
               fp32 threshold; one launch a call at every N.
 15. prune path — `ops.beam_prune` at the reference benchmark's shape
               (N = 8448, beam 25), launch counts checked; then the
               kernel, its plain version and the bound at N = 8448 and
               N = 4,194,307.
  Network phase:
 16. network — the port's front-end (`serving/server.py`) on the card:
               phase 5's fp32 system behind an `EngineServer` of 4 slots
               and a queue of 4 (127.0.0.1, port 0).  A warm-up wave,
               then the measured wave: 8 `AsrClient` streams arriving
               20 ms apart, pushing 80 ms chunks with a poll after each
               (launch counts set to 0 just before it, read just after,
               held against the steps the worker took); then the same 8
               streams hold every slot and the queue while a burst of 4
               more, with no stagger, opens with
               `AsrClient.open(retries=)`: the holders finish only once
               /metrics counts a 503 for each of the 4, and the burst
               must ride them out.
               Every stream's words, tokens and steps equal phase 5's
               in-process kernel-path result, scores rtol 1e-4.
               First-result and finalize latency (p50, p99, as
               benchmarks/load.py defines them), throughput in multiples
               of real time over the wire beside phase 5's warm
               in-process `engine.serve`, and the
               /metrics queue high-water, rejections and restarts are
               printed.  On the demo system at 4 slots: an ``asr_step``
               raise matched on one session quarantines its stream while
               the other three equal a fault-free run; a ``pump`` stall
               with `worker_watchdog` armed after a warm stream gives
               /healthz 503, then 200 after the restart, and a fresh
               stream equals the clean run; `aclose(drain=True)` under
               load returns every result.  Last, `python -m
               repro_torch.launch.serve --serve --port 0` as a
               subprocess answers an /asr stream, an LM request and
               /metrics, and SIGTERM drains it with exit code 0.  The
               phase must take at most 60 s.
  Training phases (no kernel has a backward: training runs
  KernelPolicy("ref"), and every CUDA wrapper refuses a tensor that
  requires grad):
 17. asr train — the paper's TDS_CONFIG at full width (93.0 M fp32
               parameters, TF32 off), seeded weights, a batch of 8
               SyntheticASR utterances over phase 5's lexicon words.
               (a) CTC loss and gradients on the card against the CPU on
               the same weights and batch (ASR_LOSS_RTOL; the gradients
               against the CPU's fp64 ones, ASR_GRAD_RTOL);
               (b) 20 AdamW steps on the card: losses finite, the last
               below the first, ms a step, seconds of audio a second, a
               profiler breakdown of one step; (c) the trained weights
               decode 4 held-out utterances through `AsrEngine` at 4
               slots, fp32 and int8 programs, kernel against plain
               policy: words equal, scores close, every ASR kernel's
               launches (counts set to 0 just before each kernel-policy
               serve, read just after) equal to the steps'; the WER;
               (d) each CUDA wrapper given a weight that requires grad
               raises and launches nothing.
 18. lm train — `repro_torch.launch.train.main` for h2o-danube-1.8b at
               full width (bf16 parameters, fp32 AdamW moments), batch 2
               x 2048 tokens: 4 steps; 2 steps with a checkpoint at step
               2; a 2-step --resume from it, whose losses must equal the
               4-step run's last two.  Step time, tokens/s and the model
               FLOPs' share of the bf16 peak, a profiler breakdown of one
               step; then the model cut to its first 2 layers (every
               width kept) in fp32 at S = 256: `loss_fn` and gradients on
               the card against the CPU (LM_LOSS_RTOL, LM_GRAD_RTOL).
  The rest of the LM stack (qwen2-vl-7b, musicgen-medium and int8 LM
  weights at full width, seeded random weights; embeddings from a seeded
  generator stand in for the stub frontends):
 19. lm3 kernels — flash_attention at GQA 28/4 with D = 128 and MHA
               24/24 with D = 64 (S = 512 and 2048, 1 and 2 rows) and
               rmsnorm at D = 3584, bf16 and fp32; layernorm on bf16 rows
               at D = 1536 (1 to 8192 rows, a misaligned row and D =
               1540: the scalar kernel) and on the TDS model's fp32 rows
               with its bias + residual; each against its plain version
               (each bf16 flash launch must run the TMA design, and only
               it, as the C library records the kernel it launched),
               then timed beside it, the library call (SDPA with
               `enable_gqa`, F.rms_norm, F.layer_norm) and its bound.
 20. vlm      — qwen2-vl-7b (28 layers, d_model 3584, 28/4 heads of 128,
               M-RoPE, QKV bias; 7.07 B parameters) in bf16: (a) 2 rows of
               embeddings prefilled at lengths 1800 and 2048 in the 2048
               bucket (ring 2064), then 16 decode steps fed each row's
               next embeddings; 28 flash launches a prefill, 57 rmsnorm a
               forward; each step's logits within 2e-2 of a prefill of
               the same prefix; times and profiler breakdowns; (b) at 4
               layers in fp32, the kernel and the plain policy: prefill
               logits within LM_LOGIT_RTOL, greedy tokens equal; (c)
               batch-given (1, 1024, 3) positions (one temporal index over
               a 32 x 32 h/w grid): the plain position-masked attention
               (no flash launch), the card's logits against the CPU's.
 21. audio, int8 — (a) musicgen-medium (48 layers, d_model 1536, 24
               heads of 64, LayerNorm, GELU; 1.81 B parameters) as 20(a)
               and (b): 97 layernorm launches a forward on bf16 rows, 48
               flash a prefill, no rmsnorm; (b) qwen2-vl-7b's bf16 tree
               quantized on the card (`quantize_params_for_serving`):
               three leaves bitwise against the CPU's quantization, both
               trees' resident bytes, prefill and decode on int8 weights
               and their logits' gap to the bf16 weights' (printed);
               h2o-danube-1.8b on int8 weights through `LmEngine` with
               phase 8's prompts and slots, beside phase 8; in fp32 its
               kernel and plain policies give equal tokens on 4 prompts.
 22. mesh     — the sharded ASR serving step: 4 ranks spawned on the one
               card (gloo over CUDA tensors: NCCL refuses two ranks on
               one device; a file:// rendezvous under build/chip_smoke/;
               every collective bounded by 120 s), the kernel library
               built before they start.  Phase 5's system and
               utterances, fp32 and int8, through `AsrEngine.serve` at
               meshes 2 ('model'), 2x1 and 2x2 ('data', 'model') and 2
               with the overlapped all-reduce.  On every rank: launches
               per step as phase 5's (29 int8_matmul, 58 with the
               overlap's two chunks) and 29 (58) all-reduces with a
               'model' axis; fp32 words and tokens equal phase 5's,
               scores within 1e-3; the first step's log-probs within
               MESH_LOGP_ATOL (int8: INT8_LOGP_ATOL) of the unsharded
               forward's; int8 serving and log-probs bitwise equal with
               the plain sharded products substituted; every rank's
               results equal.  Step times, all-reduces and bytes a step
               are printed as "N ranks sharing one card, gloo
               host-staged collectives: not a multi-card figure".  At
               most 150 s.
 23. lm mesh  — the sharded LM serving cells: `build_cell` prefill and
               decode on ('data', 'model') meshes of the 4 ranks sharing
               the card (gloo): h2o-danube-1.8b at 1x2, 1x4 and 2x2
               (B = 4), qwen2-moe-a2.7b at 1x2 and 1x4 (B = 2, expert
               parallel), mamba2-1.3b at 1x2 (B = 4); prefill S = 2048,
               then 8 decode steps fed the unsharded run's tokens, on
               int8 serving weights (`LM.init_local`: each rank draws the
               stream whole and keeps its blocks).  The unsharded
               references are computed in this process first, written
               under build/chip_smoke/lm_mesh/ and freed.  On every rank:
               its parameter blocks bitwise the unsharded serving tree's
               (fingerprints of the bits); launches per cell as one
               device's (rmsnorm 2 L + 1 a forward of L layers; flash L
               a prefill, none for mamba2).  In bf16 at LM_MESH_DEEP
               layers (the depth cut, every width kept, so that the
               whole run keeps within 1000 s) and at LM_MESH_LAYERS
               layers in fp32 and bf16, the kernel path and the mesh's
               plain path (replaying the kernel path's MoE routes) run
               prefill and the decode steps.  The kernels, isolated from
               the shards: the kernel path's logits within the limit of
               the plain path's (bf16: EMB_DEPTH_RATIO x the unsharded
               kernel-vs-plain gap or one bf16 ulp of max |logit| if
               that is larger; fp32: LM_LOGIT_RTOL), its decode
               tokens equal the plain path's where the plain margin is
               sure.  The shards: in fp32 both paths' logits within
               LM_LOGIT_RTOL of max |logit| of the unsharded paths', the
               caches' blocks within LM_MESH_CACHE_RTOL of max |value|
               (the control bug, a first projection skipped, at least
               LM_MESH_CONTROL x each limit), decode tokens equal the
               unsharded run's where sure; in bf16 at LM_MESH_LAYERS
               layers each path's gap from an fp32 evaluation of the
               same weights on the mesh within EMB_DEPTH_RATIO x the
               unsharded path's.  qwen2-moe's expert-parallel prefill
               drops tokens at its local capacity, so its shards are
               held to the mesh's plain path only.
               Times, collectives and bytes per cell, peak memory per
               rank printed ("not a multi-card figure").  At most
               LM_MESH_PHASE_LIMIT_S.
 24. serve mesh — the network server on the mesh: MESH_WORLD ranks
               spawned on the card as in phase 22; rank 0 serves an
               `EngineServer` leading a command channel
               (`launch.mesh.make_channel`), the other ranks replay its
               stream (`serving.server.follow`).  (a) Phase 5's system
               at 4 slots and a queue of 4, fp32 at meshes 2 and 2x2 and
               int8 at 2x2: rank 0 tells this process its port through
               a file; this process runs phase 16's warm-up and measured
               wave (8 streams 20 ms apart, 80 ms pushes with a poll
               after each) and then writes a stop file.  Every stream's
               words, tokens and steps equal phase 5's in-process
               result, scores within MESH_SCORE_ATOL (int8: within
               INT8_SCORE_RTOL of |score|; its control, the 2x2 fp32
               wave held to phase 5's int8 results, must miss that
               limit); every rank ends
               with rank 0's step count, per-slot steps and state
               digest, and replayed every message; on every rank the
               launches of each kernel (counts set to 0 just before the
               case, read just after) equal the steps it took times the
               per-step counts (1 logmel, 18 tds_conv, 15 layernorm, w
               hypothesis_unit, 29 int8_matmul an int8 step).  (b) On
               the demo system at 2x2, clients run by rank 0: an
               ``asr_step`` raise matched on one session faults that
               stream alone, the other three equal the clean in-process
               run; a stalled client is reaped by SERVE_MESH_DEADLINE_S
               on rank 0's clock, the same sid faulted on every rank; a
               ``pump`` stall with the watchdog gives /healthz 503, then
               200 after one restart, every rank's fault log holds the
               quarantine, a fresh stream equals the clean run; a drain
               under load returns every result.  (c) `python -m
               torch.distributed.run --standalone --nproc-per-node 2 -m
               repro_torch.launch.serve --serve --mesh 2 --port 0`
               answers /asr, /lm and /metrics; SIGTERM to each rank (as
               torchrun forwards it) drains it and torchrun exits 0,
               which it does only when every rank did.  First-result and
               finalize p50 / p99, realtime over the wire beside phase
               16's, command messages and bytes a stream and the
               keep-alives are printed as "N ranks sharing one card,
               gloo host-staged collectives: not a multi-card figure".
               At most SERVE_MESH_PHASE_LIMIT_S.
 25. train mesh — training on the mesh, ranks spawned on the card as in
               phase 22 (gloo), the plain paths (no kernel has a
               backward; the phase must launch none).  (a) `launch.train
               .main` on full-width h2o-danube-1.8b (bf16, fp32 AdamW
               moments), TRAIN_MESH_STEPS steps at (TRAIN_MESH_BATCH,
               TRAIN_MESH_SEQ), at --mesh local --model-parallel 2 on a
               world of 2 ranks (1x2) and of 4 (2x2), against the
               one-device launcher on the same batches in this process:
               every rank's losses equal, each step's within
               TRAIN_MESH_LOSS_RTOL of the one device's; the control, the
               one-device launcher at half the learning rate, must miss
               that limit.  (b) At TRAIN_MESH_LAYERS layers in fp32
               (every width kept; h2o-danube at 1x2 and 2x2, mamba2-1.3b
               at 1x2): `LM.loss_fn` under the mesh, its gradients
               completed and gathered whole on rank 0, each leaf within
               TRAIN_MESH_GRAD_RTOL of its max |g| of the one-device
               port's on the card, the clip's gradient norm within the
               same; the control, one replicated leaf's gradient doubled,
               must miss it.  The floor: rank 0 also computes the
               one-device gradients in fp64 (`Fp64Mode`), and the
               mesh's worst gap to them must lie within
               TRAIN_MESH_FLOOR_RATIO of the one device's fp32 worst
               gap (the doubled leaf must miss that too).
               Synchronized step times, the collectives a step by kind
               with their bytes, and each rank's peak memory are printed
               as "N ranks sharing one card, gloo host-staged
               collectives: not a multi-card figure".  At
               most TRAIN_MESH_PHASE_LIMIT_S.
 26. elastic — one world of ELASTIC_WORLD ranks spawned on the card
               (gloo), the plain paths (the phase must launch no kernel).
               (a) Elastic restart: h2o-danube-1.8b at every width, cut
               to ELASTIC_LAYERS layers (a checkpoint of ~5.3 GB; full
               depth would be ~22 GB a save, and the phase must fit its
               budget), fp32 parameters and moments at (ELASTIC_BATCH,
               ELASTIC_SEQ): ELASTIC_STEPS straight steps on 2x2, saved
               (whole leaves, `Checkpointer` under the mesh) after steps
               ELASTIC_CONTROL and ELASTIC_SAVED; ranks 0-1 resume step
               ELASTIC_SAVED on 1x2 through `elastic.replace_state`
               while ranks 2-3 run straight on 1x2.  Every restored block
               equals `local_block` of its leaf read back with numpy;
               the resumed run's final loss and worst parameter gap to
               the straight 1x2 run lie within ELASTIC_FLOOR_RATIO times
               the straight 2x2 run's (the topology's floor), floored at
               ELASTIC_MIN_REL; the control (step ELASTIC_CONTROL
               resumed as step ELASTIC_SAVED) must miss.  int8 moments
               saved and restored on 1x2: bitwise.  (b) `compressed_psum`
               over 2 ranks at every gradient shape of (a)'s model:
               bitwise the mean of both ranks' dequantized payloads,
               timed against plain all-reduces; the EF drift over
               COMPRESS_ROUNDS rounds within the reference's bound.
               (c) `pipeline_apply` over 4 stages of tanh(h @ w) (d =
               PIPE_D, PIPE_MICRO microbatches of PIPE_ROWS rows, fp32):
               within PIPE_OUT_RTOL of the sequential run, gradients
               within PIPE_GRAD_RTOL of max |g| (a swap of two stages'
               gradients must miss).  Checkpoint bytes, gather / write /
               restore seconds, step and pipeline times and peak memory
               per rank are printed as "N ranks sharing one card, gloo
               host-staged collectives: not a multi-card figure".  At
               most ELASTIC_PHASE_LIMIT_S.
 27. roofline — the dry run's op counter against the card.  (a)
               ROOF_ARCH at full width on a 1x1 mesh through
               `build_cell` (ROOF_CELLS: a prefill at (1, 4096), a decode
               step at 8 slots over a 4096-token cache, a train step at
               (1, 2048) with fp32 moments; int8 serving weights and
               KernelPolicy("auto") for the serving cells, the train
               cell's own plain paths), each counted on meta by
               `dryrun.count_cell`, then on the card: one call's kernel
               launches must equal the counter's kernel ops; the median
               of ROOF_REPS calls (CUDA events, after a warm-up), the
               device busy time of one call (profiler) and its peak of
               allocated memory beside the predicted high-water mark.
               Printed: FLOPs by dtype, bytes, t_compute / t_memory, the
               bound (derived from NVIDIA H100 SXM published peaks) and
               its term, measured ms, share (bound / measured), busy
               share.  A share above ROOF_SHARE_MAX fails (no card beats
               its peak: the count would be wrong).  (b) ROOF_DRY dry on
               this host at rank 0 and at the last rank: both ranks'
               terms and HBM a rank printed; the last rank's attention
               operations must exceed rank 0's.  There is no CPU
               fallback.  At most ROOF_PHASE_LIMIT_S.
 28. analysis — (a) the port's linter (`repro_torch.analysis`) in
               process over src/repro_torch: 0 findings; every C entry
               point KERNEL_REGISTRY names resolves in the built library.
               (b) GUARD_STEPS warmed steps of phase 5's full-width
               system, fp32 and int8, at GUARD_SLOTS slots and each w of
               GUARD_WINDOWS, under the engine's own host-sync guard
               (`no_implicit_transfers`: the sync debug mode in error)
               inside `compilation_budget(0)`; their words equal those
               of the same steps with the guard taken out, and the
               path's kernels launched as a step launches them.  (c) the
               same for GUARD_LM_STEPS LmEngine decode steps of LM_ARCH
               at full width, bf16, GUARD_SLOTS slots: equal tokens.  A
               guarded step that syncs fails with every sync's site
               (warn mode).  (d) controls that must raise inside the
               guard: an `.item()` on a CUDA tensor, a blocking upload of
               pageable memory.  (e) under warn mode, the synchronizing
               calls of one LM prefill, one `slot_best` readout and one
               TDS training step, counted and printed with their sites
               (not failures).  At most GUARD_PHASE_LIMIT_S.
The last lines are the card (nvidia-smi name, power limit), the kernels
JSON and the ok JSON.  Needs a CUDA device; without one it exits 1.
Detailed results (build log, timings, profile) go to build/chip_smoke/.
"""
from __future__ import annotations

import asyncio
import contextlib
import ctypes
import json
import math
import os
import gc
import pathlib
import pickle
import shutil
import signal
import subprocess
import sys
import time
import traceback
import types
import warnings
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))     # the port, from this checkout

import repro_torch.analysis as lint  # noqa: E402
from repro_torch.analysis import guards  # noqa: E402
from repro_torch.ckpt.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.tds_asr import (DECODER_CONFIG,  # noqa: E402
                                         FEATURE_CONFIG, TDS_CONFIG)
from repro_torch.core import ctc, features, lexicon as lx  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, SyntheticASR,  # noqa: E402
                                       SyntheticLM)
from repro_torch.device import fp32_numerics  # noqa: E402
from repro_torch.core.scheduler import ASRPU  # noqa: E402
from repro_torch.core.stepplan import make_step_plan  # noqa: E402
from repro_torch.kernels import (_build, ops, ref,  # noqa: E402
                                 beam_prune as kbp, flash_attention as kfa,
                                 hypothesis_unit as khu, int8_matmul as kim,
                                 layernorm as kln, logmel as klm,
                                 tds_conv as ktc)
from repro_torch.kernels.cost import attn_pairs, flash_flops  # noqa: E402
from repro_torch.kernels.policy import (KERNEL_REGISTRY,  # noqa: E402
                                        KernelPolicy)
from repro_torch.launch import (dryrun, mesh as meshlib,  # noqa: E402
                                roofline, steps, train)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.serve import (asr_demo_engine,  # noqa: E402
                                      asr_demo_system)
from repro_torch.models import LM, layers, moe, tds  # noqa: E402
from repro_torch.core.treeutil import (leaves_with_paths,  # noqa: E402
                                       tree_map, value_and_grad)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.parallel import (compress, pipeline,  # noqa: E402
                                  sharding as shlib)
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.serving import (AsrEngine, AsrProgram,  # noqa: E402
                                 EngineConfig, FaultPolicy, FaultSpec,
                                 LmEngine, LmProgram)
from repro_torch.serving import asr as asrmod, lm as lmmod  # noqa: E402
from repro_torch.serving.server import (AsrClient,  # noqa: E402
                                        EngineServer,
                                        fetch_healthz, fetch_metrics,
                                        follow, lm_generate)

OUT = ROOT / "build" / "chip_smoke"
SEED = 0

# H100 SXM peaks (NVIDIA data sheet; launch/roofline.py): HBM3 bytes/s,
# fp32 (non-tensor) FLOP/s, dense int8 and bf16 tensor-core rates, for
# the bounds.
PEAK_BYTES = roofline.HBM_BW
PEAK_FP32, PEAK_INT8, PEAK_BF16 = (roofline.PEAK_FLOPS[k]
                                   for k in ("fp32", "int8", "bf16"))
KERNELS = ("logmel", "tds_conv", "layernorm", "hypothesis_unit",
           "int8_matmul")
LM_KERNELS = ("rmsnorm", "flash_attention")
PRUNE_KERNELS = ("beam_prune",)

# tolerances of the kernel checks (kernel vs plain version on the card)
TOL = {"logmel": dict(rtol=1e-4, atol=1e-3),
       "layernorm": dict(rtol=1e-5, atol=1e-5),
       "tds_conv": dict(rtol=1e-5, atol=1e-5),
       "hypothesis_unit": dict(rtol=1e-5, atol=0.0),
       "int8_matmul": dict(rtol=0.0, atol=0.0)}      # bitwise
# int8 program, kernel vs plain path: the int8 products are bitwise
# equal, but an fp32 activation one ulp off (tds_conv/layernorm sum in
# another order) can quantize to the neighbouring int8 value.  On the
# demo system that moves best scores by about 1e-3 relative; at full
# width (28 FC layers) the flips cascade and the two paths' log-probs
# differ by up to ~0.2, the order of the int8 quantization noise itself
# (int8 vs fp32 log-probs are printed beside).  That the kernel itself
# is exact on the main path is checked bitwise: the kernel path with
# int8_matmul's plain version substituted gives the same bits.
INT8_LOGP_ATOL = 0.5
INT8_SCORE_RTOL = 1e-2
SOURCES = {"rmsnorm": "layernorm"}      # kernel -> csrc file stem


def replaces(name: str) -> str:
    """The TPU kernel that kernel `name` ports (KERNEL_REGISTRY's
    `replaces`)."""
    return KERNEL_REGISTRY[SOURCES.get(name, name)]["replaces"]


# LM kernels vs their plain versions.  rmsnorm: both compute in fp32 and
# round once to the output type, so bf16 may differ by one bf16 ulp (2^-8
# relative) where the fp32 values straddle a rounding boundary.  bf16
# flash_attention also rounds P to bf16 before the P·V product on the
# tensor cores (the plain version keeps P in fp32): at most 2^-9 relative
# per probability, so the output moves by at most 2^-9·max|v| before its
# own rounding to bf16.  fp32 flash attention runs on the CUDA cores (no
# TF32) and differs only in summation order.
LM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
          torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# LM prefill logits, kernel path vs plain path, as max|diff| over
# max|logit|: fp32 paths differ only in summation order (~1e-6 per
# attention output), bf16 paths by bf16 roundings compounded over 24
# layers.  h2o-danube-1.8b (both) and qwen2-moe-a2.7b at 4 layers (fp32)
# are held to these limits.  The deep random SSM and MoE models amplify
# such differences through depth far more (mamba2-1.3b's fp32 logits
# ~2e-3 apart, its bf16 ones ~0.2-0.5 of max|logit|, qwen2-moe-a2.7b's
# bf16 ones ~4-6e-2; PERF.md §6), so there each layer is held to
# LM_TOL on the same input instead (`layer_parity`): depth cannot
# amplify that check, and the whole-model gaps are printed.
LM_LOGIT_RTOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
LM_ARCH = "h2o-danube-1.8b"
LM_BUCKETS = (512, 2048, 6144)
LM_MAX_NEW = 32
LM_SLOTS = 4
# 8 prompts for the bf16 serve: three past the 4096 window; the first
# four admit alone, the second four after the first wave finishes, as
# one group per bucket (2048: two rows).  4 prompts for the fp32
# kernel-vs-plain serve, one past the window: each admits alone, so no
# multi-row group reaches the plain path's 6144 bucket (its scores are
# 4.8 GB per row there).
LM_PROMPTS = (100, 6144, 700, 4500, 1800, 5000, 300, 2048)
LM_PARITY_PROMPTS = (4500, 300, 1500, 100)
# the SSM and MoE families at full width (seeded random weights):
# mamba2-1.3b over the same buckets and prompts as h2o-danube-1.8b (its
# fp32 parity prompts hold one past 2048 that is no multiple of the SSD
# chunk of 256); qwen2-moe-a2.7b over buckets 512/2048, its 8 prompts
# admitted as for h2o-danube (first four alone, then one group per
# bucket: two rows each), its fp32 parity at 4 of its 24 layers (the
# full depth in fp32 is ~57 GB before caches, beside the bf16 weights)
MAMBA_ARCH, MOE_ARCH = "mamba2-1.3b", "qwen2-moe-a2.7b"
MOE_BUCKETS = (512, 2048)
MOE_PROMPTS = (100, 2048, 700, 1500, 1800, 450, 300, 2000)
MOE_PARITY_PROMPTS = (1500, 300, 2000, 100)
MOE_PARITY_LAYERS = 4
# (rmsnorm launches a forward, flash launches a prefill) of each LM path:
# h2o-danube-1.8b's and qwen2-moe-a2.7b's 24 layers each launch norm1,
# norm2 and one flash, plus the final norm; mamba2-1.3b's 48 launch norm1
# and the gated norm, plus the final norm, and no flash
LM_LAUNCHES = {LM_ARCH: (49, 24), MAMBA_ARCH: (97, 0), MOE_ARCH: (49, 24)}
# the LM kernels' checks, (B, H, K, Sq, Skv, D, causal, window) and (rows,
# D): h2o-danube-1.8b's GQA 32/8 with D = 80 at its three prefill buckets,
# a 2-row group, Sq < Skv, a window smaller than S, a ragged S;
# qwen2-moe-a2.7b's MHA 16/16 with D = 128 at its 1- and 2-row prefills;
# rmsnorm at h2o-danube's width 2560, at 2048 (both other models) and at
# mamba2's d_inner 4096 (its gated norm), decode rows to 4 prefill rows
LM_FLASH_CASES = (
    [(1, 32, 8, S, S, 80, True, 4096) for S in LM_BUCKETS]
    + [(2, 32, 8, 2048, 2048, 80, True, 4096),
       (2, 32, 8, 77, 2100, 80, True, 4096),
       (1, 32, 8, 1000, 1000, 80, True, 300),
       (1, 32, 8, 300, 300, 80, True, 4096)]
    + [(b, 16, 16, S, S, 128, True, None) for b in (1, 2) for S in (512, 2048)])
LM_NORM_CASES = ([(rows, 2560) for rows in (1, 4, 512, 2048, 6144)]
                 + [(rows, d) for d in (2048, 4096)
                    for rows in (1, 4, 512, 2048, 6144, 8192)])
# the timed shapes, (B, H, K, S, D, window) in bf16 at one row and (rows, D)
LM_FLASH_TIMED = ([(1, 32, 8, S, 80, 4096) for S in LM_BUCKETS]
                  + [(1, 16, 16, S, 128, None) for S in MOE_BUCKETS])
LM_NORM_TIMED = ([(rows, d) for d in (2560, 2048)
                  for rows in (1, LM_SLOTS) + LM_BUCKETS]
                 + [(rows, 4096) for rows in (LM_SLOTS,) + LM_BUCKETS])
# beam_prune: the reference benchmark's shape (benchmarks/run.py:365), and
# a ragged N of ~4 M that spreads the max over 1024 blocks
BP_N, BP_BEAM, BP_BIG = 8448, 25.0, 4_194_307
BP_CALLS = 4
# the network front-end (phase 16): phase 5's fp32 system behind an
# EngineServer of 4 slots and a queue of 4, its 8 utterances streamed in
# 80 ms pushes by clients arriving 20 ms apart (benchmarks/load.py's
# default stagger), then a burst of 4 more with no stagger while those 8
# fill the slots and the queue; the fault checks on the demo system
NET_SLOTS, NET_MAX_QUEUE, NET_BURST = 4, 4, 4
NET_STAGGER_S = 0.02
NET_RETRIES = 200               # the burst's open retries
NET_RTOL = 1e-4                 # a stream's score against in process
NET_WAIT_S = 30.0               # the longest a phase 16 condition waits
NET_LAUNCHER_WAIT_S = 120.0     # the --serve subprocess's drain and exit
NET_WATCHDOG_S = 1.0
NET_POISON_SID = 1
NET_PHASE_LIMIT_S = 60.0
# training (phases 17, 18) runs the kernels' plain versions
PLAIN = KernelPolicy("ref")
# phase 22: the sharded ASR step, MESH_WORLD ranks sharing the one card;
# (mesh spec, overlap_psum) cases, each over the world's first ranks
MESH_WORLD = 4
MESH_CASES = (("2", False), ("2x1", False), ("2x2", False), ("2", True))
MESH_TIMEOUT_S = 120.0          # each collective's (and the rendezvous's)
MESH_PHASE_LIMIT_S = 150.0
MESH_SCORE_ATOL = 1e-3          # the reference's sharded-serving bound
# the fp32 first step's log-probs, sharded vs unsharded forward: the
# partial products are summed in another order (cuBLAS at K/2, then one
# add); 4.77e-6 on every mesh on an H100, the limit 10x that
MESH_LOGP_ATOL = 5e-5
# phase 23: the sharded LM serving cells, (arch, mesh, global batch);
# prefill (B, LM_MESH_SEQ), then LM_MESH_STEPS decode steps
LM_MESH_CASES = ((LM_ARCH, "1x2", 4), (LM_ARCH, "1x4", 4), (LM_ARCH, "2x2", 4),
                 (MOE_ARCH, "1x2", 2), (MOE_ARCH, "1x4", 2),
                 (MAMBA_ARCH, "1x2", 4))
LM_MESH_SEQ = 2048
LM_MESH_STEPS = 8
LM_MESH_LAYERS = 4              # the fp32 and the shallow bf16 checks' depth
# the deep bf16 check's depth, every width kept: the models' 24 (48 for
# mamba2-1.3b) layers cut so that the whole run, phase 27 included, keeps
# within 1000 s (984.7 s before the cut, phase 23 263-323 s at full depth)
LM_MESH_DEEP = 8
# fp32 at LM_MESH_LAYERS layers, sharded vs unsharded: prefill logits
# within LM_LOGIT_RTOL of max |logit|, cache blocks within
# LM_MESH_CACHE_RTOL of the cache's largest |value|.  Relative: the
# shards' products sum in another order (cuBLAS picks its algorithm by
# the shard's width).  Set from two readings on an H100 (PERF.md, PR
# 24): the largest sound gap (mamba2-1.3b: logits 1.81e-4 on 4.69, cache
# 1.11e-4 on 4.63, 2.4e-5 of it) and the control bug, the first layer's
# output projection skipped, which must move each by LM_MESH_CONTROL
# times its limit or more; the mesh's plain path is held to the same
# limits against the unsharded plain path (the shards' roundings alone)
LM_MESH_CACHE_RTOL = 1e-4
LM_MESH_CONTROL = 10.0
# a decode token must equal the other path's where that path's top-two
# margin is above LM_MESH_SURE times the allowed logit gap
LM_MESH_SURE = 2.0
LM_MESH_TIMEOUT_S = 300.0       # each collective's (ranks wait at barriers)
LM_MESH_PHASE_LIMIT_S = 450.0
LM_MESH_DIR = ROOT / "build" / "chip_smoke" / "lm_mesh"
# phase 24: the network server on the mesh (`--serve --mesh`), MESH_WORLD
# ranks sharing the card: phase 16's wave at each (mesh, int8) case, the
# faults on the demo system at SERVE_MESH_DEMO, the torchrun launcher
SERVE_MESH_CASES = (("2", False), ("2x2", False), ("2x2", True))
# int8 over the wire is held to phase 5's int8 as phase 5 holds its int8
# kernel path to the plain one: words, tokens and steps equal, scores
# within INT8_SCORE_RTOL of |score|, not MESH_SCORE_ATOL.  At full width
# a step's activations one ulp apart (the 'model' all-reduce's order;
# over the wire, another batching of the windows) quantize to
# neighbouring int8 values.  The limit sits between two readings on an
# H100 (PERF.md §6): the int8 wave, at most ~3e-3 of |score|, and
# the control, the same mesh's fp32 wave held to phase 5's int8 results,
# which must miss it (its largest gap ~2.8e-2 of |score|).
SERVE_MESH_DEMO = "2x2"
SERVE_MESH_DEADLINE_S = 4.0
SERVE_MESH_PHASE_LIMIT_S = 150.0
SERVE_MESH_DIR = ROOT / "build" / "chip_smoke" / "serve_mesh"
# phase 25: training on the mesh.  (a) the launcher (`launch.train.main
# --mesh local --model-parallel 2`) on full-width LM_ARCH (bf16, fp32
# AdamW moments) for TRAIN_MESH_STEPS steps at (TRAIN_MESH_BATCH,
# TRAIN_MESH_SEQ) on each mesh of TRAIN_MESH_MESHES, every rank on the
# one card, against the one-device launcher on the same steps' batches:
# each step's loss within TRAIN_MESH_LOSS_RTOL of the one-device run's
# (bf16: the mesh's row-parallel products round fp32 partials once, the
# one device's bf16 products each); its control, the one-device
# launcher at half the learning rate, must miss that limit at the second
# step.  (b) the numerics at TRAIN_MESH_LAYERS layers in fp32 (every
# width kept) at (TRAIN_MESH_BATCH, TRAIN_MESH_NUM_SEQ): every leaf's
# gradient, completed and gathered whole, within TRAIN_MESH_GRAD_RTOL of
# its max |g| of the one-device port's on the card (rank 0 computes it),
# the clip's gradient norm within the same, relative; the control, one
# replicated leaf's gradient doubled, must miss it
TRAIN_MESH_BATCH, TRAIN_MESH_SEQ, TRAIN_MESH_STEPS = 4, 1024, 2
TRAIN_MESH_MESHES = ("1x2", "2x2")
TRAIN_MESH_NUMERICS = {"1x2": (LM_ARCH, MAMBA_ARCH), "2x2": (LM_ARCH,)}
TRAIN_MESH_LAYERS, TRAIN_MESH_NUM_SEQ = 4, 256
TRAIN_MESH_GRAD_RTOL = 1e-4
# and the floor: each fp32 gradient's gap to the one-device fp64
# gradient (worst leaf); the mesh's within TRAIN_MESH_FLOOR_RATIO of the
# one device's (read 0.59-1.34; mamba2-1.3b 9.476e-5 against 7.049e-5)
TRAIN_MESH_FLOOR_RATIO = 2.0
TRAIN_MESH_LOSS_RTOL = 2e-3
TRAIN_MESH_TIMEOUT_S = 300.0
TRAIN_MESH_PHASE_LIMIT_S = 300.0
TRAIN_MESH_DIR = ROOT / "build" / "chip_smoke" / "train_mesh"
# phase 26: the rest of the multi-device layer, on one world of
# ELASTIC_WORLD ranks sharing the card.  (a) elastic restart: LM_ARCH at
# every width, cut to ELASTIC_LAYERS layers (its checkpoint, fp32
# parameters and fp32 moments, ~5.3 GB; full depth would be ~22 GB a
# save), in fp32 at (ELASTIC_BATCH, ELASTIC_SEQ): ELASTIC_STEPS straight
# steps on 2x2, saved after steps ELASTIC_CONTROL and ELASTIC_SAVED;
# step ELASTIC_SAVED resumed on 1x2 for the rest, against straight runs
# on 1x2 and 2x2, whose gap is the topology's own floor: the resumed
# run's worst parameter gap (||d|| / ||p|| a leaf) and its final loss
# within ELASTIC_FLOOR_RATIO times the floor, floored at ELASTIC_MIN_REL
# relative; the control (step ELASTIC_CONTROL resumed as step
# ELASTIC_SAVED) must miss.  (b) compressed_psum over 2 ranks on the
# gradient shapes of (a)'s model, bitwise the mean of the two ranks'
# dequantized payloads; the EF drift over COMPRESS_ROUNDS rounds on the
# embedding within the reference's bound (max |g| / 127 + 1e-5).
# (c) pipeline_apply over 4 stages of tanh(h @ w), d = PIPE_D, PIPE_MICRO
# microbatches of PIPE_ROWS rows, fp32: the output within PIPE_OUT_RTOL
# of the sequential application (relative to its max), each stage's
# gradient within PIPE_GRAD_RTOL of max |g|
ELASTIC_WORLD, ELASTIC_LAYERS = 4, 4
ELASTIC_BATCH, ELASTIC_SEQ = 4, 256
ELASTIC_STEPS, ELASTIC_SAVED, ELASTIC_CONTROL = 3, 2, 1
ELASTIC_FLOOR_RATIO, ELASTIC_MIN_REL = 2.0, 1e-6
COMPRESS_ROUNDS = 20
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS, PIPE_D = 4, 8, 4 * 256, 2560
PIPE_OUT_RTOL, PIPE_GRAD_RTOL = 1e-5, 1e-4
ELASTIC_TIMEOUT_S = 300.0
ELASTIC_PHASE_GOAL_S = 150.0
ELASTIC_PHASE_LIMIT_S = 300.0
ELASTIC_DIR = ROOT / "build" / "chip_smoke" / "elastic"
# phase 27: the dry-run tooling's counts against the card.  (a) ROOF_ARCH
# at full width on a 1x1 mesh through build_cell, (kind, B, S): int8
# serving weights and KernelPolicy("auto") for the serving cells, the
# train cell's own plain paths and fp32 moments; the decode step's cache
# is a prefill's of its 8 rows.  No card beats its peak: a share of the
# bound above ROOF_SHARE_MAX means the count is wrong.  (b) ROOF_DRY dry,
# at rank 0 and at the last rank
ROOF_ARCH = LM_ARCH
ROOF_CELLS = (("prefill", 1, 4096), ("decode", 8, 4096), ("train", 1, 2048))
ROOF_REPS = 5
ROOF_SHARE_MAX = 1.05
ROOF_DRY = ("qwen2-72b", "prefill_32k", "single_pod")
ROOF_PHASE_LIMIT_S = 60.0
# phase 28: the analysis package.  The engines' steps under their own
# host-sync guard: GUARD_STEPS warmed steps of phase 5's full-width
# system (fp32 and int8) at GUARD_SLOTS slots for each w of
# GUARD_WINDOWS, and GUARD_LM_STEPS warmed decode steps of LM_ARCH at
# full width in bf16 after one prefill group of GUARD_LM_PROMPTS
GUARD_SLOTS, GUARD_WINDOWS, GUARD_STEPS = 4, (1, 4), 3
GUARD_LM_STEPS = 8
GUARD_LM_PROMPTS = (100, 300, 200, 480)
GUARD_LM_BUCKETS = (512,)
GUARD_PHASE_LIMIT_S = 60.0
# what torch's sync debug mode says of a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"
# phase 17: TDS_CONFIG trained with CTC on 8 SyntheticASR utterances of
# phase 5's lexicon words (AdamW, no weight decay, as the reference's
# ASR training test), then 4 held-out utterances decoded
ASR_TRAIN_BATCH, ASR_HELD_OUT, ASR_TRAIN_STEPS = 8, 4, 20
ASR_TRAIN_LR = 1e-3
# card against CPU on the same fp32 weights and batch (TF32 off): the
# loss within rtol 1e-4 of the CPU's fp32 one.  Each gradient leaf's
# max|err| within 1e-4 of its max|g|, held against the CPU's fp64
# gradients: in a first chip run the CPU's own fp32 gradients were 2.0e-2
# from them at worst (median 3.3e-3; the losses bitwise equal), the
# card's 4.9e-6, so a card-vs-CPU fp32 limit would have to be loose
# enough to pass a wrong gradient
ASR_LOSS_RTOL, ASR_GRAD_RTOL = 1e-4, 1e-4
# phase 18: h2o-danube-1.8b at full width through the launcher, (B, S) =
# (2, 2048); its numerics at 2 of its 24 layers in fp32 at S = 256, the
# loss within rtol 1e-5 and each gradient leaf within 1e-4 of its max|g|
# (fp32 without TF32, summation order only, over 2 layers and a 32256-
# wide head); a resumed run's losses within LM_RESUME_ATOL of the
# uninterrupted run's (the same state and data: equal up to the card's
# non-deterministic gradient sums)
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TIMED_STEPS = 2, 2048, 3
LM_TRAIN_PARITY_LAYERS, LM_TRAIN_PARITY_SEQ = 2, 256
LM_LOSS_RTOL, LM_GRAD_RTOL = 1e-5, 1e-4
LM_RESUME_ATOL = 1e-3

# phases 19-21: the rest of the LM stack.  qwen2-vl-7b (M-RoPE, patch
# embeddings) and musicgen-medium (LayerNorm, GELU, frame embeddings) at
# full width in bf16, seeded random weights, embeddings from a seeded
# generator (the stub frontend's stand-in): 2 rows prefilled at lengths
# 1800 and 2048 in the 2048 bucket into a ring of 2064, then 16 decode
# steps fed each row's next embeddings, each step's logits against a
# prefill of the same prefix.  tests/test_models.py holds that gap to
# 2e-2 relative in bf16 at its tiny depth; the 4-layer cut is held to it
# in bf16 and to LM_LOGIT_RTOL in fp32.  At full depth random bf16
# weights amplify the roundings of the two paths past it, the plain
# path's as much as the kernel path's (on an H100: qwen2-vl-7b 2.43e-2
# kernel, 2.47e-2 plain; musicgen-medium 3.83e-2 and 3.69e-2; PERF.md
# §6), so there the kernel path's worst gap is held to EMB_DEPTH_RATIO
# times the plain path's own on the same model (tests/test_torch_lm.py's
# criterion for bf16 across depth).  The numerics at 4 layers also hold the two policies to each
# other; batch-given M-RoPE positions are one temporal index over a
# 32 x 32 h/w grid (S = 1024)
VLM_ARCH, AUDIO_ARCH = "qwen2-vl-7b", "musicgen-medium"
EMB_BUCKET, EMB_LENGTHS, EMB_RING, EMB_STEPS = 2048, (1800, 2048), 2064, 16
EMB_DECODE_RTOL = {torch.bfloat16: 2e-2, torch.float32: LM_LOGIT_RTOL[
    torch.float32]}
EMB_DEPTH_RATIO = 1.5
EMB_PARITY_LAYERS = 4
EMB_GRID = 32
# (norm kernel, its launches a forward, flash launches a prefill): 28
# layers of norm1 + norm2 plus the final norm; musicgen's 48 the same
EMB_LAUNCHES = {VLM_ARCH: ("rmsnorm", 57, 28),
                AUDIO_ARCH: ("layernorm", 97, 48)}
# phase 19, the kernels at these paths' shapes, (B, H, K, Sq, Skv, D,
# causal, window), (rows, D, misaligned), (rows, D): qwen2-vl's GQA 28/4
# with D = 128 and musicgen's MHA 24/24 with D = 64 at S = 512 and 2048
# (2 rows: the prefill's); LayerNorm in bf16 at D = 1536 (aligned from a
# decode row to 8192 rows; a misaligned row and D = 1540, no multiple of
# 8: the scalar kernel) and the TDS model's fp32 rows; rmsnorm at D = 3584
LM3_FLASH_CASES = [(b, h, kv, S, S, d, True, None)
                   for h, kv, d in ((28, 4, 128), (24, 24, 64))
                   for b, S in ((1, 512), (1, 2048), (2, 2048))]
LM3_LN_CASES = ([(rows, 1536, False) for rows in (1, 2, 512, 4096, 8192)]
                + [(16, 1536, True), (4096, 1536, True), (7, 1540, False)])
LM3_TDS_LN_CASES = [(rows, d) for d in (1200, 1520, 1840) for rows in (16, 64)]
LM3_RMS_CASES = [(rows, 3584) for rows in (1, 2, 512, 4096, 8192)]
LM3_FLASH_TIMED = [(b, h, kv, S, d, None)
                   for h, kv, d in ((28, 4, 128), (24, 24, 64))
                   for b, S in ((1, 512), (1, 2048), (2, 2048))]
LM3_RMS_TIMED = [(rows, 3584) for rows in (2, 4096)]
LM3_LN_TIMED = [(rows, 1536) for rows in (2, 4096)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_FP32) -> float:
    kind = {v: k for k, v in roofline.PEAK_FLOPS.items()}[peak]
    return roofline.bound_s({kind: flops}, nbytes) * 1e3


# ---------------------------------------------------------------------------
# shapes of one full-width step
# ---------------------------------------------------------------------------
def conv_shapes(cfg, b: int, w: int):
    """(name, k, stride, Cin, Cout, T_in, residual, fused) of every conv
    of one step at b slots and w windows (8 feature frames per window);
    `fused`: the LayerNorm after it runs in its launch (`tds_conv_ln`)."""
    out, t = [], 8 * w
    feat = cfg.stages[0].feat
    specs = tds.build_kernel_specs(cfg)
    for i, spec in enumerate(specs):
        if spec.kind == "conv":
            cin, cout = spec.n_in // spec.kernel, spec.n_out // feat
            res = spec.residual and spec.stride == 1 and cin == cout
            out.append((spec.name, spec.kernel, spec.stride, cin, cout, t, res,
                        specs[i + 1].kind == "layernorm"))
        t //= spec.stride
    return out


def ln_shapes(cfg, b: int, w: int):
    """(rows, D, addends) of every LayerNorm launched on its own in one
    step: the FC block's (with fc2's bias and the block's residual,
    `addends` True) and final_ln (none); the rest run in a conv."""
    out, t = [], 8 * w
    specs = tds.build_kernel_specs(cfg)
    for i, spec in enumerate(specs):
        t //= spec.stride
        if spec.kind == "layernorm" and specs[i - 1].kind != "conv":
            out.append((b * t, spec.n_out, specs[i - 1].kind == "fc"))
    return out


def fc_shapes(cfg, b: int, w: int):
    """(M, K, N) of every FC/head product of one step."""
    out, t = [], 8 * w
    for spec in tds.build_kernel_specs(cfg):
        t //= spec.stride
        if spec.kind in ("fc", "head"):
            out.append((b * t, spec.n_in, spec.n_out))
    return out


def int8_inputs(dev, gen, m, k, n):
    """(x, w) float and their int8 forms as the serving path makes them:
    xq, xs from `quantize_rows`, wq, ws from `prepare_int8_weights`."""
    x = torch.randn((m, k), generator=gen).to(dev)
    w = (torch.randn((k, n), generator=gen) / np.sqrt(k)).to(dev)
    xq, xs = ops.quantize_rows(x)
    wq, ws = ops.prepare_int8_weights(w)
    return x, w, xq, xs, wq, ws


def conv_inputs(dev, gen, b, k, stride, cin, cout, t, res):
    x = torch.randn((b, k - 1 + t, 80, cin), generator=gen).to(dev)
    wt = (torch.randn((k, cin, cout), generator=gen)
          / np.sqrt(k * cin)).to(dev)
    bias = (0.1 * torch.randn((cout,), generator=gen)).to(dev)
    r = (torch.randn((b, t // stride, 80, cout), generator=gen).to(dev)
         if res else None)
    return x, wt, bias, r


def ln_params(dev, gen, d):
    return ((1 + 0.1 * torch.randn((d,), generator=gen)).to(dev),
            (0.1 * torch.randn((d,), generator=gen)).to(dev))


def hu_inputs(dev, gen, b, n):
    h = torch.randint(0, 4096, (b, n), generator=gen, dtype=torch.int32)
    pb = 3 * torch.randn((b, n), generator=gen)
    pnb = 3 * torch.randn((b, n), generator=gen)
    dead = torch.rand((b, n), generator=gen) < 0.2
    pb = torch.where(dead, torch.full_like(pb, -1e30), pb)
    pnb = torch.where(dead, torch.full_like(pnb, -1e30), pnb)
    return h.to(dev), pb.to(dev), pnb.to(dev)


def power_rows(dev, gen, r):
    return (torch.randn((r, 257), generator=gen).square() * 10.0).to(dev)


def samples(dev, gen, shape):
    """Audio-like samples: noise at 0.3 under a slow sine (power in the
    low bands that pre-emphasis attenuates)."""
    t = torch.arange(shape[-1], dtype=torch.float32)
    return (0.3 * torch.randn(shape, generator=gen)
            + 0.5 * torch.sin(0.01 * t)).to(dev)


def library_mfcc(sig, cfg, t):
    """The rfft + matmul yardstick of the fused MFCC, never on the port's
    path: pre-emphasis, frames as an unfold view, torch.fft.rfft (cuFFT),
    |.|^2, then the mel and DCT matmuls."""
    x = torch.cat([sig[..., :1], sig[..., 1:] - cfg.preemphasis
                   * sig[..., :-1]], dim=-1)
    fr = x.unfold(-1, cfg.frame_len, cfg.frame_shift) * t.win
    p = torch.fft.rfft(fr, n=cfg.n_fft).abs().square()
    return torch.log(torch.clamp(p @ t.fb, min=1e-10)) @ t.dct


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------
def check_kernels(dev) -> dict:

    gen = torch.Generator().manual_seed(SEED)
    err = {}

    def close(name, got, want, label):
        d = (got - want).abs().max().item() if got.numel() else 0.0
        err[name] = max(err.get(name, 0.0), d)
        try:
            torch.testing.assert_close(got, want, **TOL[name])
        except AssertionError as e:
            fail(f"{name} {label}: kernel disagrees with its plain version: "
                 f"{e}")
        print(f"[kernels] {name:16s} {label:34s} max|err| {d:.3e} ok",
              flush=True)

    tables = features._tables(FEATURE_CONFIG, dev)
    for r in (8, 128):
        p = power_rows(dev, gen, r)
        close("logmel", klm.logmel(p, tables.fb, tables.dct),
              ref.logmel(p, tables.fb, tables.dct), f"power rows R={r}")
    # the fused MFCC on the sample blocks of a b=4, w=4 and a b=1, w=1
    # step (8 frames a window), and a 1-D signal of 23 frames
    for shape in ((4, 4, 1520), (1, 1, 1520), (4000,)):
        sig = samples(dev, gen, shape)
        close("logmel", klm.mfcc(sig, FEATURE_CONFIG, tables),
              ref.mfcc(sig, FEATURE_CONFIG, tables), f"MFCC {shape}")
    torch.cuda.synchronize()

    # every conv of a b=4, w=4 and a b=1, w=1 step; the fused ones in both
    # designs (split 0: a cluster per row; 1: a block of 512 per row)
    seen = set()
    for b, w in ((4, 4), (1, 1)):
        for (_, k, s, cin, cout, t, res, fused) in conv_shapes(TDS_CONFIG, b,
                                                               w):
            key = (b, k, s, cin, cout, t, res, fused)
            if key in seen:
                continue
            seen.add(key)
            x, wt, bias, r = conv_inputs(dev, gen, b, k, s, cin, cout, t, res)
            label = f"b={b} k={k} s={s} {cin}->{cout} T={t} res={int(res)}"
            if not fused:
                close("tds_conv", ktc.tds_conv(x, wt, bias, r, stride=s,
                                               relu=True),
                      ref.tds_conv_fused(x, wt, bias, stride=s, relu=True,
                                         res=r), label)
                continue
            sc, sh = ln_params(dev, gen, 80 * cout)
            want = ref.tds_conv_ln(x, wt, bias, sc, sh, stride=s, relu=True,
                                   res=r)
            for split in (0, 1):
                close("tds_conv", ktc.tds_conv_ln(x, wt, bias, sc, sh, r,
                                                  stride=s, relu=True,
                                                  split=split), want,
                      f"{label} +LN split={split}")
    torch.cuda.synchronize()

    for rows, d, addends in sorted(set(ln_shapes(TDS_CONFIG, 4, 4)
                                       + ln_shapes(TDS_CONFIG, 1, 1))):
        y = torch.randn((rows, d), generator=gen).to(dev)
        sc, sh = ln_params(dev, gen, d)
        ab = (0.1 * torch.randn((d,), generator=gen)).to(dev) \
            if addends else None
        r = torch.randn((rows, d), generator=gen).to(dev) if addends else None
        close("layernorm", kln.bias_residual_layernorm(y, sc, sh, add_bias=ab,
                                                       res=r),
              ref.bias_residual_layernorm(y, sc, sh, add_bias=ab, res=r),
              f"R={rows} D={d} bias+res={int(addends)}")
    torch.cuda.synchronize()

    for b, n in ((4, 8320), (4, 4224)):
        h, pb, pnb = hu_inputs(dev, gen, b, n)
        got = khu.hypothesis_unit(h, pb, pnb, k=128, beam=25.0)
        want = ref.hypothesis_unit(h, pb, pnb, k=128, beam=25.0)
        for key in ("idx", "valid"):
            if not torch.equal(got[key], want[key]):
                bad = (got[key] != want[key]).sum().item()
                fail(f"hypothesis_unit ({b},{n}): {key} differs in {bad} "
                     f"of {got[key].numel()} entries")
        for key in ("pb", "pnb"):
            close("hypothesis_unit", got[key], want[key],
                  f"({b},{n}) K=128 {key}")
    torch.cuda.synchronize()

    # the FC/head shapes of a b=4, w=4 and a b=1, w=1 step, and ragged
    # ones: the fused quantize + product (the main path's) and the
    # product of pre-quantized rows, both bitwise
    for m, k, n in sorted(set(fc_shapes(TDS_CONFIG, 4, 4)
                              + fc_shapes(TDS_CONFIG, 1, 1))) + [
            (5, 37, 29), (17, 4100, 3)]:
        x, _, xq, xs, wq, ws = int8_inputs(dev, gen, m, k, n)
        want = ref.int8_matmul(xq, wq, xs, ws)
        for label, got in (
                ("fused", kim.int8_matmul_fused(x, wq, ws)),
                ("pre-quantized", kim.int8_matmul(xq, wq, xs, ws))):
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                fail(f"int8_matmul {label} M={m} K={k} N={n}: {bad} of "
                     f"{got.numel()} entries differ from the plain version "
                     f"(must be bitwise)")
            close("int8_matmul", got, want,
                  f"M={m} K={k} N={n} {label} (bitwise)")
    torch.cuda.synchronize()

    # the sharded step's products (phase 22): each rank's pre-quantized
    # columns of the full rows' quantization against its K-contiguous
    # weight rows, K = 1200/1520/1840 over 2 and 4 ranks, whole and in the
    # overlap's two column chunks; bitwise
    for m, k, n in sorted(set(fc_shapes(TDS_CONFIG, 4, 4)
                              + fc_shapes(TDS_CONFIG, 1, 1))):
        _, _, xq, xs, wq, ws = int8_inputs(dev, gen, m, k, n)
        for model in (2, 4):
            kl = k // model
            xl = xq[:, kl:2 * kl].contiguous()     # rank 1's columns
            wl = wq[kl:2 * kl].t().contiguous().t()
            for lo, hi in [(0, n)] + ops.overlap_splits(n):
                got = kim.int8_matmul(xl, wl[:, lo:hi], xs, ws[lo:hi])
                want = ref.int8_matmul(xl, wl[:, lo:hi], xs, ws[lo:hi])
                if not torch.equal(got, want):
                    fail(f"int8_matmul shard M={m} K={kl} N={hi - lo}: "
                         f"{(got != want).sum().item()} entries differ from "
                         f"the plain version (must be bitwise)")
                close("int8_matmul", got, want,
                      f"M={m} K={kl} N={hi - lo} shard of {model} (bitwise)")
    torch.cuda.synchronize()
    return err


def check_hypothesis_rows(rows) -> float:
    """The hypothesis unit on captured decoder rows against its plain
    version: idx and valid exact, pb/pnb within TOL; max |err|."""
    err = 0.0
    for i, (h, pb, pnb, k, beam) in enumerate(rows):
        got = khu.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
        want = ref.hypothesis_unit(h, pb, pnb, k=k, beam=beam)
        for key in ("idx", "valid"):
            if not torch.equal(got[key], want[key]):
                bad = (got[key] != want[key]).sum().item()
                fail(f"hypothesis_unit on decoder rows (call {i}): {key} "
                     f"differs in {bad} of {got[key].numel()} entries")
        for key in ("pb", "pnb"):
            d = (got[key] - want[key]).abs().max().item()
            err = max(err, d)
            try:
                torch.testing.assert_close(got[key], want[key],
                                           **TOL["hypothesis_unit"])
            except AssertionError as e:
                fail(f"hypothesis_unit on decoder rows (call {i}) {key}: {e}")
    torch.cuda.synchronize()
    print(f"[kernels] hypothesis_unit  {len(rows)} captured decoder calls "
          f"{tuple(rows[0][0].shape)}: idx/valid exact, max|err| {err:.3e} ok",
          flush=True)
    return err


def row_census(rows) -> dict:
    """Live candidates L and distinct live hashes (heads) H per captured
    row: they size the kernel's grouping and selection."""
    ls, hs = [], []
    for h, pb, pnb, _, _ in rows:
        live = torch.logaddexp(pb, pnb) > ref.NEG_INF / 2
        for r in range(h.shape[0]):
            hl = h[r][live[r]]
            ls.append(int(hl.numel()))
            hs.append(int(torch.unique(hl).numel()))
    out = {"calls": len(rows), "rows": len(ls), "N": int(rows[0][0].shape[1]),
           "L": ls, "H": hs}
    print(f"[hypothesis rows] {len(rows)} calls x {rows[0][0].shape[0]} rows "
          f"of N={out['N']}: live L min/median/max {min(ls)}/"
          f"{int(np.median(ls))}/{max(ls)}, heads H {min(hs)}/"
          f"{int(np.median(hs))}/{max(hs)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3 / 4: serving through AsrEngine
# ---------------------------------------------------------------------------
def full_width_words(n_words=4096, fanout=32, vocab=9000):
    """4096 words of 2-6 tokens over tokens 1..8999, no trie node with
    more than 32 children (numpy, fixed seed)."""
    rng = np.random.default_rng(SEED)
    children = [dict()]
    words, seen = {}, set()
    while len(words) < n_words:
        node, toks = 0, []
        for _ in range(int(rng.integers(2, 7))):
            ch = children[node]
            t = (int(rng.integers(1, vocab)) if len(ch) < fanout
                 else int(rng.choice(list(ch))))
            if t not in ch:
                ch[t] = len(children)
                children.append({})
            toks.append(t)
            node = ch[t]
        if tuple(toks) not in seen:
            seen.add(tuple(toks))
            words[f"w{len(words)}"] = toks
    return words


def serve_pair(make_engine, utts, label, assert_equal, score_rtol=1e-4):
    """Serve `utts` with the kernel and the plain policy; compare."""
    res = {}
    for mode in ("kernel", "ref"):
        eng = make_engine(KernelPolicy(mode))
        t0 = time.perf_counter()
        res[mode] = eng.serve(utts)
        torch.cuda.synchronize()
        print(f"[{label}] policy={mode}: {len(utts)} utterances, "
              f"{eng.n_steps} steps, {time.perf_counter() - t0:.3f} s "
              f"(first use included)", flush=True)
    n_equal = 0
    for i, (a, b) in enumerate(zip(res["kernel"], res["ref"])):
        same = (np.array_equal(a["words"], b["words"])
                and np.array_equal(a["tokens"], b["tokens"]))
        n_equal += same
        if not np.isfinite(a["score"]):
            fail(f"{label} utt {i}: non-finite score {a['score']}")
        print(f"[{label}] utt {i}: words_equal={same} "
              f"score kernel={a['score']:.6f} ref={b['score']:.6f} "
              f"diff={a['score'] - b['score']:.3e} words={a['words'].tolist()}",
              flush=True)
        if assert_equal:
            if not same:
                fail(f"{label} utt {i}: transcripts differ: kernel "
                     f"{a['words'].tolist()}/{a['tokens'].tolist()} vs ref "
                     f"{b['words'].tolist()}/{b['tokens'].tolist()}")
            if not np.isclose(a["score"], b["score"], rtol=score_rtol,
                              atol=1e-4):
                fail(f"{label} utt {i}: scores {a['score']} vs {b['score']} "
                     f"(rtol {score_rtol})")
    return res, n_equal


def demo_phase(dev):
    system = asr_demo_system()
    utts = [SyntheticASR(system[1]).utterance(u)["audio"] for u in range(4)]
    for int8 in (False, True):
        for n_slots in (1, 4):
            serve_pair(lambda pol, n=n_slots, q=int8: asr_demo_engine(
                n, pol, device=dev, system=system, use_int8=q)[0], utts,
                f"demo {'int8' if int8 else 'fp32'} slots={n_slots}",
                assert_equal=True,
                score_rtol=INT8_SCORE_RTOL if int8 else 1e-4)


def shim_phase(dev) -> dict:
    """The deprecated ASRPU command API (configure -> DecodingStep per
    80 ms chunk -> best) on the int8 demo program, held against an
    `AsrEngine` serving the same program (one window per step, no tail
    flush, as the shim configures it).  Counts set to 0 just before the
    shim's decoding, read just after: every kernel must have launched."""
    tds_cfg, words, lex, lm, params, dec_cfg = asr_demo_system()
    dec_cfg = replace(dec_cfg, beam_threshold=25.0)
    audio = SyntheticASR(words).utterance(0)["audio"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        pu = ASRPU(device=dev)
    pu.configure_acoustic_scoring(tds_cfg, params, use_int8=True)
    pu.configure_hyp_expansion(lex, lm, dec_cfg)
    spp = pu.plan.samples_per_step
    ops.reset_launch_counts()
    for off in range(0, len(audio), spp):
        pu.decoding_step(audio[off:off + spp])
    got = pu.best(final=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"[shim] ASRPU int8: {pu._n_steps} DecodingSteps, launches "
          f"{counts}", flush=True)
    idle = [k for k in KERNELS if not counts[k]]
    if idle:
        fail(f"shim path launched no {idle}: {counts}")
    if counts["int8_matmul"] != 7 * pu._n_steps:
        fail(f"shim: {counts['int8_matmul']} int8_matmul launches for "
             f"{pu._n_steps} steps of 7 FC/head products")
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg, use_int8=True,
                      max_windows_per_step=1, flush_tail=False)
    want = AsrEngine(EngineConfig(prog, n_slots=1), params,
                     device=dev).serve([audio])[0]
    torch.cuda.synchronize()
    same = (np.array_equal(got["words"], want["words"])
            and np.array_equal(got["tokens"], want["tokens"])
            and pu._n_steps == want["steps"])
    print(f"[shim] words {got['words'].tolist()} score {got['score']:.6f}; "
          f"AsrEngine words {want['words'].tolist()} score "
          f"{want['score']:.6f}, steps {pu._n_steps} vs {want['steps']}",
          flush=True)
    if not same or not np.isclose(got["score"], want["score"], rtol=1e-4,
                                  atol=1e-4):
        fail(f"shim result {got} differs from AsrEngine's {want}")
    return counts


def full_width_system(dev):
    """The paper's TDS_CONFIG and default decoder with seeded random
    weights (placed on `dev` once, shared by every engine below)."""
    words = full_width_words(fanout=DECODER_CONFIG.max_children,
                             vocab=TDS_CONFIG.vocab_size)
    lex = lx.build_lexicon(words, max_children=DECODER_CONFIG.max_children)
    lm = lx.uniform_bigram(len(words))
    params = tds.init_tds(torch.Generator().manual_seed(SEED), TDS_CONFIG,
                          device=dev)
    return TDS_CONFIG, words, lex, lm, params, DECODER_CONFIG


def full_width_utterances(words, n=8):
    """`n` SyntheticASR utterances; within each group of four, two of 2
    words and two of 4, so that serving them over 4 slots gathers steps
    of 4, 2 and 1 slots (the long pair outlives the short pair)."""
    data = SyntheticASR(words)
    return [data.utterance(u, n_words=(2, 2, 4, 4)[u % 4])["audio"]
            for u in range(n)]


@contextlib.contextmanager
def plain_int8_products():
    """Run the int8 product's plain version (`quantize_rows`, then
    `ref.int8_matmul`) in place of its fused kernel (`ops` looks the
    wrapper up on its module at every call)."""
    kernel = kim.int8_matmul_fused
    kim.int8_matmul_fused = lambda x, wq, ws: ref.int8_matmul_prepared(
        x, wq, ws)
    try:
        yield
    finally:
        kim.int8_matmul_fused = kernel


@contextlib.contextmanager
def counting_quantizations():
    """Count the calls of the plain `quantize_rows` (`ops` and
    `ref.int8_matmul_prepared` look it up on `ref` at every call); yields
    a one-element list holding the count."""
    plain, count = ref.quantize_rows, [0]

    def counted(x):
        count[0] += 1
        return plain(x)
    ref.quantize_rows = counted
    try:
        yield count
    finally:
        ref.quantize_rows = plain


@contextlib.contextmanager
def counting_ffts():
    """Count the calls of torch.fft.rfft (the plain MFCC,
    `ref.power_spectrum`, looks it up on torch.fft at every call); yields
    a one-element list holding the count."""
    plain, count = torch.fft.rfft, [0]

    def counted(*args, **kwargs):
        count[0] += 1
        return plain(*args, **kwargs)
    torch.fft.rfft = counted
    try:
        yield count
    finally:
        torch.fft.rfft = plain


def capture_decoder_rows(dev, system, utts, advance=2):
    """The candidate rows the full-width fp32 engine feeds the hypothesis
    unit in one b=4, w=4 step, after `advance` committed steps (0: the
    utterances' first step): a hook around the kernel's wrapper (which `ops`
    looks up on its module at every call) keeps a copy of each call's
    inputs.  Returns [(hashes, pb, pnb, k, beam)] of the step's w calls."""
    eng = full_engine(dev, system, KernelPolicy("kernel"))
    for s in range(4):
        eng.feed_slot(s, utts[s])
    for _ in range(advance):
        eng._step_slots([0, 1, 2, 3], 4)
    rows, kernel = [], khu.hypothesis_unit

    def hook(h, pb, pnb, *, k, beam):
        rows.append((h.clone(), pb.clone(), pnb.clone(), k, beam))
        return kernel(h, pb, pnb, k=k, beam=beam)
    khu.hypothesis_unit = hook
    try:
        eng._step_slots([0, 1, 2, 3], 4, commit=False)
    finally:
        khu.hypothesis_unit = kernel
    torch.cuda.synchronize()
    if len(rows) != 4:
        fail(f"captured {len(rows)} hypothesis-unit calls in a w=4 step")
    return rows


class Before:
    """The parent checkout's `logmel` and `beam_prune` kernels (`--before
    DIR`), built from DIR's sources with the same nvcc flags and called
    through their C entry points as the parent's wrappers called them:
    the "before" of the timing, on the same card in the same run.  Never
    on the port's path."""

    def __init__(self, root: pathlib.Path):
        import ctypes
        csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
        out = OUT / "before"
        out.mkdir(parents=True, exist_ok=True)
        objs = []
        for name in ("logmel", "beam_prune"):
            obj = out / f"{name}.o"
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c",
                            str(csrc / f"{name}.cu"), "-o", str(obj)],
                           check=True, capture_output=True, timeout=600)
            objs.append(str(obj))
        so = out / "libbefore.so"
        subprocess.run([_build._nvcc(), "-shared", "-o", str(so), *objs],
                       check=True, capture_output=True, timeout=600)
        self.lib = ctypes.CDLL(str(so))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.lib.logmel_launch.argtypes = [P, P, P, P, I, I, I, I, P]
        self.lib.beam_prune_launch.argtypes = [P, P, P, I, I, F, P]
        print(f"[before] built {root}'s logmel and beam_prune", flush=True)

    def logmel(self, p, fb, dct):
        R, F = p.shape
        M, C = dct.shape
        out = torch.empty((R, C), dtype=torch.float32, device=p.device)
        err = self.lib.logmel_launch(p.data_ptr(), fb.data_ptr(),
                                     dct.data_ptr(), out.data_ptr(), R, F, M,
                                     C, _build.stream(p.device))
        if err:
            fail(f"the parent's logmel failed: cudaError {err}")
        return out

    def mfcc(self, sig, cfg, t):
        """The parent's MFCC: the plain front end, then its logmel."""
        power = ref.power_spectrum(sig, cfg, t.win)
        out = self.logmel(power.reshape(-1, power.shape[-1]), t.fb, t.dct)
        return out.reshape(power.shape[:-1] + (out.shape[-1],))

    def beam_prune(self, s, beam):
        n = s.shape[0]
        out = torch.empty_like(s)
        partial, n_partials = out, 1          # one block up to 65536
        if n > 1 << 16:                       # two launches above it
            partial, n_partials = torch.empty(
                (1024,), dtype=torch.float32, device=s.device), 1024
        err = self.lib.beam_prune_launch(
            s.data_ptr(), out.data_ptr(), partial.data_ptr(), n, n_partials,
            float(beam), _build.stream(s.device))
        if err:
            fail(f"the parent's beam_prune failed: cudaError {err}")
        return out


def full_engine(dev, system, policy, n_slots=4, use_int8=False):
    tds_cfg, _, lex, lm, params, dec_cfg = system
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg, use_int8=use_int8)
    return AsrEngine(EngineConfig(prog, n_slots=n_slots, kernels=policy),
                     params, device=dev)


def window_batch(eng, utts, b, w):
    """(b, w, need) samples: the first w windows of utterances 0..b-1."""
    need, spp = eng._need, eng._spp
    batch = np.zeros((b, w, need), np.float32)
    for j in range(b):
        for i in range(w):
            batch[j, i] = utts[j][i * spp:i * spp + need]
    return batch


def full_phase(dev, system, utts, use_int8=False):
    tag = "full int8" if use_int8 else "full fp32"
    eng = full_engine(dev, system, KernelPolicy("auto"), use_int8=use_int8)
    torch.cuda.synchronize()
    # ---- the main path: counts set to 0 just before, read just after --
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with counting_quantizations() as quantized, counting_ffts() as ffts:
        results = eng.serve(utts)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    quantizations, n_fft_calls = quantized[0], ffts[0]
    steps = list(eng.step_shapes)
    n_steps = len(steps)
    expect = {name: 0 for name in counts}       # the LM kernels: none
    expect.update({"logmel": n_steps, "tds_conv": 18 * n_steps,
                   "layernorm": 15 * n_steps,
                   "hypothesis_unit": sum(w for _, _, w in steps),
                   "int8_matmul": 29 * n_steps if use_int8 else 0})
    print(f"[{tag}] served {len(utts)} utterances over 4 slots in "
          f"{wall:.3f} s (first use included): {n_steps} steps, "
          f"(n_active, b, w) = {steps}", flush=True)
    print(f"[{tag}] launch counts {counts}, expected {expect}", flush=True)
    if counts != expect or not n_steps:
        fail(f"launch counts {counts} != expected {expect}")
    # the int8 products quantize their rows in their own launch: the
    # plain `quantize_rows` (~8 launches a call) ran no time
    # the MFCC runs in its one logmel launch: the plain front end's
    # torch.fft.rfft ran no time
    print(f"[{tag}] plain quantize_rows calls: {quantizations}; "
          f"torch.fft.rfft calls: {n_fft_calls}", flush=True)
    if n_fft_calls:
        fail(f"{tag}: torch.fft.rfft ran {n_fft_calls} times on the main "
             f"path (the MFCC must run in its fused launch)")
    if quantizations:
        fail(f"{tag}: {quantizations} plain quantize_rows calls on the "
             f"main path (each product must quantize its rows itself)")
    shapes = {(b, w) for _, b, w in steps}
    if not ({b for b, _ in shapes} >= {1, 2, 4}
            and {w for _, w in shapes} >= {1, 2, 4}):
        fail(f"gathered steps did not cover b and w in 1, 2, 4: {shapes}")
    for r in results:
        if not np.isfinite(r["score"]):
            fail(f"non-finite full-width score {r['score']}")
    # the same utterances again on the warm engine: in-process throughput,
    # which phase 16 sets beside the same work over the wire
    t0 = time.perf_counter()
    eng.serve(utts)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    audio_s = sum(len(u) for u in utts) / 16000.0
    print(f"[{tag}] warm engine.serve of the same {len(utts)} utterances: "
          f"{warm_s:.3f} s, {audio_s / warm_s:.3f}x realtime", flush=True)

    # ---- per-step log-probs: kernel path vs plain path, same batch ----
    lp_tol = (dict(rtol=0.0, atol=INT8_LOGP_ATOL) if use_int8
              else dict(rtol=1e-4, atol=1e-3))
    fp32_eng = full_engine(dev, system, KernelPolicy("kernel")) \
        if use_int8 else None
    lp_err = 0.0
    for b, w in ((4, 4), (1, 1), (2, 2)):
        batch = torch.from_numpy(window_batch(eng, utts, b, w)).to(dev)
        st = tds.init_batched_stream_state(system[0], b, dev)
        out = {}
        for mode in ("kernel", "ref"):
            lp, _ = eng.acoustic(batch, st, kernels=KernelPolicy(mode))
            out[mode] = lp
        torch.cuda.synchronize()
        if out["kernel"].shape != (b, w, system[0].vocab_size) or \
                not torch.isfinite(out["kernel"]).all():
            fail(f"log-probs at b={b} w={w}: shape "
                 f"{tuple(out['kernel'].shape)} or non-finite values")
        d = (out["kernel"] - out["ref"]).abs().max().item()
        lp_err = max(lp_err, d)
        print(f"[{tag}] log-probs b={b} w={w}: kernel vs plain max|err| "
              f"{d:.3e} ({lp_tol})", flush=True)
        if use_int8:
            with plain_int8_products():
                sub, _ = eng.acoustic(batch, st, kernels=KernelPolicy("kernel"))
            fp32, _ = fp32_eng.acoustic(batch, st,
                                        kernels=KernelPolicy("kernel"))
            torch.cuda.synchronize()
            if not torch.equal(sub, out["kernel"]):
                fail(f"{tag} b={b} w={w}: the kernel path's log-probs change "
                     f"when int8_matmul's plain version replaces the kernel")
            print(f"[{tag}] log-probs b={b} w={w}: kernel path with the "
                  f"plain int8_matmul bitwise equal; int8 vs fp32 program "
                  f"max|diff| {(out['kernel'] - fp32).abs().max().item():.3e}",
                  flush=True)
        try:
            torch.testing.assert_close(out["kernel"], out["ref"], **lp_tol)
        except AssertionError as e:
            fail(f"{tag} log-probs b={b} w={w}: {e}")

    # ---- the plain path on the same utterances, for the transcripts ---
    ref_eng = full_engine(dev, system, KernelPolicy("ref"), use_int8=use_int8)
    ref_results = ref_eng.serve(utts)
    torch.cuda.synchronize()
    n_eq = 0
    for i, (a, r) in enumerate(zip(results, ref_results)):
        same = (np.array_equal(a["words"], r["words"])
                and np.array_equal(a["tokens"], r["tokens"]))
        n_eq += same
        print(f"[{tag}] utt {i}: words_equal={same} best-score diff "
              f"{a['score'] - r['score']:.3e} (kernel {a['score']:.4f}, "
              f"ref {r['score']:.4f}), {len(a['words'])} words", flush=True)
    print(f"[{tag}] words equal for {n_eq}/{len(utts)} utterances",
          flush=True)
    if n_eq != len(utts):
        fail(f"{tag}: kernel and plain paths' words differ for "
             f"{len(utts) - n_eq} of {len(utts)} utterances")
    return counts, steps, lp_err, results, warm_s


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------
def host_ms(fn, n=30, warmup=3) -> float:
    """Median time of one call from its enqueue to the end of its work
    (CUDA events around each call; host launch overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def device_ms(fn, n=20, warmup=3, prep=None) -> float:
    """Median over n calls of the device time of one call, without the
    host's launch overhead.  Before each call a spin kernel
    (`torch.cuda._sleep`) holds the stream while the host enqueues the
    call between two CUDA events, so the device then runs the call's
    kernels back to back and the events bracket only them.  The spin is
    lengthened until it outlasts the enqueue (checked, not assumed); one
    call at a time, so a call of many kernels never fills the launch
    queue and blocks the host.  `prep`: work enqueued after the spin and
    before the first event (untimed), such as an L2 flush."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 4_000_000
    times = []
    while len(times) < n:
        s0, e0, s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(4))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0.record()
        torch.cuda._sleep(cycles)
        e0.record()
        if prep is not None:
            prep()
        s.record()
        fn()
        e.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if s0.elapsed_time(e0) > enqueue_ms:
            times.append(s.elapsed_time(e))
        elif cycles < 4_000_000_000:
            cycles *= 4
        else:
            fail(f"the spin kernel never outlasted the host's enqueue "
                 f"({enqueue_ms:.1f} ms)")
    return float(np.median(times))


def conv_library(x, wv, bias, r, s, sc, sh):
    """The cuDNN composite yardstick of one conv (+ LayerNorm) launch, never
    on the port's path: F.conv2d on x viewed as channels-last NCHW and the
    weight as (Cout, Cin, k, 1) (`wv`, made once), stride (s, 1), then
    ReLU, the residual and F.layer_norm over each (b, t) row."""
    y = torch.relu(F.conv2d(x.permute(0, 3, 1, 2), wv, bias,
                            stride=(s, 1))).permute(0, 2, 3, 1)
    if r is not None:
        y = y + r
    if sc is None:
        return y
    d = y.shape[2] * y.shape[3]
    return F.layer_norm(y.reshape(-1, d), (d,), sc, sh, 1e-5).reshape(y.shape)


def timing_phase(dev, b=4, w=4, only=KERNELS, hu_rows=(), hu_first=(),
                 before=None) -> dict:
    """Each kernel's launches in one full-width step at b slots, w
    windows (the kernels in `only`): summed medians of the kernel, the
    plain version and the library call or composite, and the bound.  The
    fused conv + LayerNorm is also timed in its block-per-row variant
    (`alt_ms`)."""

    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {}

    def add(name, launches, fk, fp, fl, nbytes, flops, label,
            peak=PEAK_FP32, context=None, alt=None, extra=None):
        """fk/fp/fl: one call of the kernel / plain version / library;
        `context`: another call timed for comparison only; `alt`: the
        kernel's other design; `extra`: {key: call} timed beside, summed
        into the row's `<key>_ms`."""
        kms, pms = device_ms(fk), device_ms(fp)
        lms = None if fl is None else device_ms(fl)
        cms = None if context is None else device_ms(context)
        ams = kms if alt is None else device_ms(alt)
        ems = {key: device_ms(f) for key, f in (extra or {}).items()}
        khost = host_ms(fk)
        bnd = bound_ms(nbytes, flops, peak)
        r = rows.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=None,
                                       bound_ms=0.0, bytes_s=0.0, ops_s=0.0,
                                       step_launches=0, host_ms=0.0,
                                       context_ms=None, alt_ms=0.0,
                                       shapes=[]))
        for key, ms in ems.items():
            r[f"{key}_ms"] = r.get(f"{key}_ms", 0.0) + launches * ms
        r["host_ms"] += launches * khost
        r["ms"] += launches * kms
        r["alt_ms"] += launches * ams
        r["plain_ms"] += launches * pms
        if lms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + launches * lms
        if cms is not None:
            r["context_ms"] = (r["context_ms"] or 0.0) + launches * cms
        r["bound_ms"] += launches * bnd
        r["bytes_s"] += launches * nbytes / PEAK_BYTES
        r["ops_s"] += launches * flops / peak
        r["step_launches"] += launches
        r["shapes"].append(dict(label=label, launches=launches, ms=kms,
                                alt_ms=ams, plain_ms=pms, library_ms=lms,
                                bound_ms=bnd, launch_inclusive_ms=khost,
                                **{f"{key}_ms": ms for key, ms in
                                   ems.items()}))
        print(f"[timing b={b} w={w}] {name:16s} {label:34s} x{launches:<2d} "
              f"device: kernel {kms * 1e3:9.2f} us  "
              + ("" if alt is None else f"block-per-row {ams * 1e3:.2f} us  ")
              + f"plain {pms * 1e3:9.2f} us  "
              f"library {'-' if lms is None else f'{lms * 1e3:.2f}'} us  "
              f"bound {bnd * 1e3:.3f} us | kernel call with launch "
              f"{khost * 1e3:.2f} us"
              + ("" if cms is None else f" | fp32 matmul {cms * 1e3:.2f} us")
              + "".join(f" | {key} {ms * 1e3:.2f} us"
                        for key, ms in ems.items()),
              flush=True)

    # logmel: the fused MFCC of one step's (b, w, 1520) samples, R =
    # b * w * 8 frames.  Plain: `ref.mfcc` (the torch front end, cuFFT,
    # `ref.logmel`); library: `library_mfcc`, the rfft + matmul pipeline.
    # Bytes: the samples, the tables the kernel reads (the window, the
    # twiddles, the band table, the packed band weights, not the dense
    # filterbank, and the DCT) and the output, once each.
    # Operations, per frame: pre-emphasis and window (3 a sample), the
    # radix-2 FFT's H/2 butterflies a stage (10 each), the split and power
    # of H + 1 bins (17 each), each mel sum over its band (2 a weight), the
    # log (1 a mel) and the DCT (2 M C).  Beside: the kernel on R power
    # rows alone (`power_rows_ms`) and, with --before, the parent's
    # pipeline (`before_ms`: the plain front end, then its logmel kernel).
    if "logmel" in only:
        cfg, t = FEATURE_CONFIG, features._tables(FEATURE_CONFIG, dev)
        sig = samples(dev, gen, (b, w, 1520))
        R, H, M, C = 8 * b * w, cfg.n_fft // 2, cfg.n_mels, cfg.n_mfcc
        band = int((t.bands[:, 1] - t.bands[:, 0]).sum().item())
        nbytes = 4 * (sig.numel() + R * C + sum(
            x.numel() for x in (t.win, t.band_weights, t.dct, t.twiddles,
                                t.bands)))
        flops = R * (3 * cfg.frame_len + 10 * (H // 2) * (H.bit_length() - 1)
                     + 17 * (H + 1) + 2 * band + M + 2 * M * C)
        lib_err = (library_mfcc(sig, cfg, t)
                   - ref.mfcc(sig, cfg, t)).abs().max().item()
        p = power_rows(dev, gen, R)
        extra = {"power_rows": lambda: klm.logmel(p, t.fb, t.dct)}
        if before is not None:
            extra["before"] = lambda: before.mfcc(sig, cfg, t)
        add("logmel", 1, lambda: klm.mfcc(sig, cfg, t),
            lambda: ref.mfcc(sig, cfg, t), lambda: library_mfcc(sig, cfg, t),
            nbytes, flops, f"MFCC ({b}, {w}, 1520), R={R} "
            f"(library |diff| {lib_err:.1e})", extra=extra)

    # tds_conv: the 18 convs of the step, 17 with their LayerNorm.  Bytes:
    # x, the weight, the bias, the residual, the LayerNorm's scale and
    # shift and the output, once each; operations: the conv's FMAs, the
    # epilogue, ~8 a value for the LayerNorm.  Library: the cuDNN composite.
    shapes = {}
    for (_, k, s, cin, cout, t, res, fused) in conv_shapes(TDS_CONFIG, b, w):
        key = (k, s, cin, cout, t, res, fused)
        shapes[key] = shapes.get(key, 0) + 1
    for (k, s, cin, cout, t, res, fused), n in shapes.items():
        if "tds_conv" not in only:
            break
        x, wt, bias, r = conv_inputs(dev, gen, b, k, s, cin, cout, t, res)
        sc, sh = ln_params(dev, gen, 80 * cout) if fused else (None, None)
        wv = wt.permute(2, 1, 0)[..., None].contiguous()
        outs = b * (t // s) * 80 * cout
        nbytes = 4 * (x.numel() + wt.numel() + cout
                      + outs * (2 if res else 1) + (2 * 80 * cout if fused
                                                    else 0))
        flops = (2 * outs * k * cin + outs * (3 if res else 2)
                 + (8 * outs if fused else 0))
        lib = (lambda x=x, wv=wv, bias=bias, r=r, s=s, sc=sc, sh=sh:
               conv_library(x, wv, bias, r, s, sc, sh))
        if fused:
            want = ref.tds_conv_ln(x, wt, bias, sc, sh, stride=s, relu=True,
                                   res=r)
            kern = (lambda x=x, wt=wt, bias=bias, r=r, s=s, sc=sc, sh=sh:
                    ktc.tds_conv_ln(x, wt, bias, sc, sh, r, stride=s,
                                    relu=True))
            alt = (lambda x=x, wt=wt, bias=bias, r=r, s=s, sc=sc, sh=sh:
                   ktc.tds_conv_ln(x, wt, bias, sc, sh, r, stride=s,
                                   relu=True, split=1))
            plain = (lambda x=x, wt=wt, bias=bias, r=r, s=s, sc=sc, sh=sh:
                     ref.tds_conv_ln(x, wt, bias, sc, sh, stride=s,
                                     relu=True, res=r))
        else:
            want = ref.tds_conv_fused(x, wt, bias, stride=s, relu=True, res=r)
            kern = (lambda x=x, wt=wt, bias=bias, r=r, s=s: ktc.tds_conv(
                x, wt, bias, r, stride=s, relu=True))
            alt = None
            plain = (lambda x=x, wt=wt, bias=bias, r=r, s=s:
                     ref.tds_conv_fused(x, wt, bias, stride=s, relu=True,
                                        res=r))
        try:                               # a yardstick only: no row value
            lib_err = (lib() - want).abs().max().item()
        except RuntimeError as e:
            print(f"[timing] the cuDNN composite refused k={k} s={s}: {e}",
                  flush=True)
            lib, lib_err = None, None
        label = f"k={k} s={s} {cin}->{cout} T={t}{' +LN' if fused else ''}"
        if lib_err is not None:
            label += f" (cuDNN |diff| {lib_err:.1e})"
        add("tds_conv", n, kern, plain, lib, nbytes, flops, label, alt=alt)

    # layernorm: the 15 LayerNorms launched on their own (14 with fc2's
    # bias and the block's residual, final_ln without).  Library: the
    # composite F.layer_norm((y + b) + res), F.layer_norm for final_ln.
    lns = {}
    for key in ln_shapes(TDS_CONFIG, b, w):
        lns[key] = lns.get(key, 0) + 1
    for (nr, d, addends), n in sorted(lns.items()):
        if "layernorm" not in only:
            break
        y = torch.randn((nr, d), generator=gen).to(dev)
        sc, sh = ln_params(dev, gen, d)
        ab = torch.randn((d,), generator=gen).to(dev) if addends else None
        r = torch.randn((nr, d), generator=gen).to(dev) if addends else None
        add("layernorm", n,
            lambda y=y, sc=sc, sh=sh, ab=ab, r=r: kln.bias_residual_layernorm(
                y, sc, sh, add_bias=ab, res=r),
            lambda y=y, sc=sc, sh=sh, ab=ab, r=r:
                ref.bias_residual_layernorm(y, sc, sh, add_bias=ab, res=r),
            (lambda y=y, sc=sc, sh=sh, ab=ab, r=r, d=d: F.layer_norm(
                (y + ab) + r, (d,), sc, sh, 1e-5)) if addends else
            (lambda y=y, sc=sc, sh=sh, d=d: F.layer_norm(y, (d,), sc, sh,
                                                         1e-5)),
            4 * (nr * d * (3 if addends else 2) + d * (3 if addends else 2)),
            8 * nr * d + (2 * nr * d if addends else 0),
            f"R={nr} D={d}{' +bias+res' if addends else ''}")
    # hypothesis unit: the w = 4 launches of a step on the rows the
    # full-width decoder fed it in its third step (captured), beside the
    # rows of its first step (`first_step_ms`, the step the profile below
    # breaks down) and synthetic (4, 8320) rows (`synthetic_ms`, one
    # launch)
    if "hypothesis_unit" in only:
        hb, hn, hk = 4, 8320, 128
        h, pb, pnb = hu_inputs(dev, gen, hb, hn)
        syn = {"synthetic": lambda: khu.hypothesis_unit(h, pb, pnb, k=hk,
                                                        beam=25.0)}
        for i, (ch, cpb, cpnb, ck, cbeam) in enumerate(hu_rows):
            nb_, nn_ = ch.shape
            extra = dict(syn) if i == 0 else {}
            fh, fpb, fpnb, fk, fbeam = hu_first[i]
            extra["first_step"] = (lambda a=(fh, fpb, fpnb), k=fk, be=fbeam:
                                   khu.hypothesis_unit(*a, k=k, beam=be))
            add("hypothesis_unit", 1,
                lambda a=(ch, cpb, cpnb), k=ck, be=cbeam:
                    khu.hypothesis_unit(*a, k=k, beam=be),
                lambda a=(ch, cpb, cpnb), k=ck, be=cbeam:
                    ref.hypothesis_unit(*a, k=k, beam=be),
                None, nb_ * nn_ * 12 + nb_ * ck * 13, 20 * nb_ * nn_,
                f"decoder rows, call {i} ({nb_}, {nn_}) K={ck}",
                extra=extra)

    # int8_matmul: the 29 FC/head products of an int8 step, fp32
    # activations in (the quantization counts as part of the product).
    # Library: `quantize_rows`, then torch._int_mm (cuBLASLt int8, which
    # wants M > 16: rows padded to 24) and the same rescale; context: the
    # fp32 product.  Beside: the product of pre-quantized rows and the
    # plain `quantize_rows` alone.
    fcs = {}
    for key in fc_shapes(TDS_CONFIG, b, w):
        fcs[key] = fcs.get(key, 0) + 1
    for (m, k, n), cnt in sorted(fcs.items()):
        if "int8_matmul" not in only:
            break
        xf, wf, xq, xs, wq, ws = int8_inputs(dev, gen, m, k, n)
        xpad = torch.zeros((max(m, 24), k), dtype=torch.float32, device=dev)
        xpad[:m] = xf

        def int_mm(xpad=xpad, wq=wq, ws=ws, m=m):
            q, sc = ops.quantize_rows(xpad)
            return torch._int_mm(q, wq)[:m].float() * sc[:m, None] \
                * ws[None, :]
        try:
            if not torch.equal(int_mm(), ref.int8_matmul(xq, wq, xs, ws)):
                fail(f"torch._int_mm disagrees with the plain version at "
                     f"M={m} K={k} N={n}")
        except RuntimeError as e:          # a yardstick only: no row value
            print(f"[timing] torch._int_mm refused M={m} K={k} N={n}: {e}",
                  flush=True)
            int_mm = None
        extra = {
            "prequantized": lambda xq=xq, wq=wq, xs=xs, ws=ws:
                kim.int8_matmul(xq, wq, xs, ws),
            "plain_quantize": lambda xf=xf: ops.quantize_rows(xf)}
        add("int8_matmul", cnt,
            lambda xf=xf, wq=wq, ws=ws: kim.int8_matmul_fused(xf, wq, ws),
            lambda xf=xf, wq=wq, ws=ws: ref.int8_matmul_prepared(xf, wq, ws),
            int_mm, 4 * m * k + k * n + 4 * (n + m * n), 2 * m * k * n,
            f"M={m} K={k} N={n}", peak=PEAK_INT8,
            context=lambda xf=xf, wf=wf: xf @ wf, extra=extra)
    return rows


def step_times(dev, system, utts) -> dict:
    """Wall time of one full-width decoding step per (b, w): batch
    assembly and upload, acoustic scoring and w expansions, ending in a
    synchronize (median of 5 after one warm-up step).  Keys: "<policy>
    b= w=" for the fp32 program, "int8 <policy> b= w=" for int8."""
    out = {}
    for int8 in (False, True):
        for mode in ("kernel", "ref"):
            eng = full_engine(dev, system, KernelPolicy(mode), use_int8=int8)
            for s in range(4):
                eng.feed_slot(s, utts[s])
            for b in (1, 2, 4):
                for w in (1, 2, 4):
                    slots = list(range(b))
                    ts = []
                    for i in range(6):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        eng._step_slots(slots, w, commit=False)
                        torch.cuda.synchronize()
                        if i:                  # the first call warms up
                            ts.append(time.perf_counter() - t0)
                    key = f"{'int8 ' if int8 else ''}{mode} b={b} w={w}"
                    out[key] = float(np.median(ts)) * 1e3
                    print(f"[step] {'int8' if int8 else 'fp32'} "
                          f"policy={mode} b={b} w={w}: {out[key]:.3f} ms "
                          f"median of 5", flush=True)
    return out


def profile_step(dev, system, utts, step_ms: float,
                 use_int8: bool = False) -> dict:
    """Device time by kernel over one b=4, w=4 kernel-path step of real
    decoding (the hypothesis unit sees the decoder's own candidates),
    and the device's idle share of the unprofiled step time."""
    tag = "int8" if use_int8 else "fp32"
    eng = full_engine(dev, system, KernelPolicy("kernel"), use_int8=use_int8)
    for s in range(4):
        eng.feed_slot(s, utts[s])
    eng._step_slots([0, 1, 2, 3], 4, commit=False)
    torch.cuda.synchronize()
    return device_breakdown(
        lambda: eng._step_slots([0, 1, 2, 3], 4, commit=False), tag,
        "b=4 w=4 kernel-path step", step_ms)


def device_breakdown(fn, tag: str, what: str, step_ms: float) -> dict:
    """Device time by kernel over one call of `fn` (warmed up by the
    caller) under the profiler, and the device's idle share of the
    unprofiled wall time `step_ms` of the same call."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, n, t) for k, (n, t) in by_name.items()),
                  key=lambda r: -r[2])
    busy = sum(t for _, _, t in rows)
    n_events = sum(n for _, n, _ in rows)
    if not n_events:
        print(f"[profile] {tag}: the profiler recorded no device events: "
              f"device busy time and idle share not measured", flush=True)
        return {"step_ms": step_ms, "device_busy_ms": None}
    print(f"[profile] {tag} {what}: {n_events} device "
          f"events, device busy {busy:.3f} ms of the unprofiled "
          f"{step_ms:.3f} ms step: idle share "
          f"{max(0.0, 1 - busy / step_ms):.3f}", flush=True)
    for key, cnt, ms in rows[:14]:
        print(f"[profile] {tag} {ms:8.3f} ms  x{cnt:<4d} {key[:100]}",
              flush=True)
    # host side: torch ops by self CPU time (profiled, so inflated; read
    # the shares, not the sums)
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda r: -r[2])
    for key, cnt, ms in host[:12]:
        print(f"[profile] {tag} host {ms:8.3f} ms self  x{cnt:<4d} "
              f"{key[:80]}", flush=True)
    return {"step_ms": step_ms, "device_busy_ms": busy,
            "device_events": n_events,
            "by_kernel": [list(r) for r in rows[:60]],
            "host_by_op": [list(r) for r in host[:40]]}


# ---------------------------------------------------------------------------
# LM phases: h2o-danube-1.8b at full width
# ---------------------------------------------------------------------------
def attn_inputs(dev, gen, b, h, kv, sq, skv, d, dtype):
    return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                 for shape in ((b, h, sq, d), (b, kv, skv, d),
                               (b, kv, skv, d)))


def check_lm_kernels(dev) -> dict:
    """flash_attention and rmsnorm vs their plain versions (LM_TOL) at
    the full-width shapes of the three LM paths, bf16 and fp32."""
    gen = torch.Generator().manual_seed(SEED + 2)
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for b, h, kv, sq, skv, d, causal, win in LM_FLASH_CASES:
            q, k, v = attn_inputs(dev, gen, b, h, kv, sq, skv, d, dtype)
            before = dict(kfa.launches_by_design)
            got = kfa.flash_attention(q, k, v, causal=causal, window=win)
            torch.cuda.synchronize()
            ran = [n for n in kfa.DESIGNS
                   if kfa.launches_by_design[n] != before[n]]
            # every width of the LM paths (80, 128) runs the TMA design in
            # bf16, and only it
            if ran != [kfa.design(d, dtype)] or (
                    dtype == torch.bfloat16 and ran != ["bf16 tma"]):
                fail(f"flash_attention {tag} D={d}: launched {ran}")
            want = ref.flash_attention(q, k, v, causal=causal, window=win)
            d_ = (got.float() - want.float()).abs().max().item()
            err["flash_attention"] = max(err.get("flash_attention", 0.0), d_)
            label = (f"{tag} B={b} H={h}/{kv} Sq={sq} Skv={skv} D={d} "
                     f"w={win} ({ran[0]})")
            try:
                torch.testing.assert_close(got, want, **LM_TOL[dtype])
            except AssertionError as e:
                fail(f"flash_attention {label}: kernel disagrees with its "
                     f"plain version: {e}")
            print(f"[lm kernels] flash_attention {label:44s} max|err| "
                  f"{d_:.3e} ok", flush=True)
            del q, k, v, got, want
        torch.cuda.empty_cache()
        for rows, d in LM_NORM_CASES:
            x = torch.randn((rows, d), generator=gen).to(dev, dtype)
            sc = (1 + 0.1 * torch.randn((d,), generator=gen)).to(dev)
            got = kln.rmsnorm(x, sc)
            torch.cuda.synchronize()
            want = ref.rmsnorm(x, sc)
            d_ = (got.float() - want.float()).abs().max().item()
            err["rmsnorm"] = max(err.get("rmsnorm", 0.0), d_)
            try:
                torch.testing.assert_close(got, want, **LM_TOL[dtype])
            except AssertionError as e:
                fail(f"rmsnorm {tag} R={rows} D={d}: kernel disagrees with "
                     f"its plain version: {e}")
            print(f"[lm kernels] rmsnorm {tag} R={rows} D={d}: max|err| "
                  f"{d_:.3e} ok", flush=True)
    return err


def lm_prompts(lengths, vocab: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lengths]


def lm_engine(dev, cfg, params, policy, buckets=LM_BUCKETS) -> LmEngine:
    program = LmProgram(cfg, cache_len=buckets[-1] + LM_MAX_NEW,
                        max_new=LM_MAX_NEW, prefill_buckets=buckets)
    return LmEngine(EngineConfig(program, n_slots=LM_SLOTS, kernels=policy),
                    params, device=dev)


def timed_engine(eng: LmEngine):
    """Record each prefill's (batch, bucket) and each decode step's wall
    time (ms, synchronized) on `eng`; returns the two lists."""
    prefills, steps = [], []
    prefill, decode = eng._prefill, eng.lm.decode_step

    def timed_prefill(tokens, lengths):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(tokens, lengths)
        torch.cuda.synchronize()
        prefills.append((tuple(tokens.shape),
                         (time.perf_counter() - t0) * 1e3))
        return out

    def timed_decode(params, cache, batch):
        # the engine decodes inside its host-sync guard: the timing's
        # synchronizes are explicit
        with guards.allow_transfers():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(params, cache, batch)
        with guards.allow_transfers():
            torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    eng._prefill = timed_prefill
    eng.lm.decode_step = timed_decode
    return prefills, steps


def lm_serve_phase(dev, cfg, params, prompt_lens=LM_PROMPTS,
                   buckets=LM_BUCKETS, tag="lm serve") -> dict:
    """A main LM path: bf16 full width through `LmEngine`."""
    eng = lm_engine(dev, cfg, params, KernelPolicy("auto"), buckets)
    prefills, steps = timed_engine(eng)
    eng.serve(lm_prompts((64,), cfg.vocab_size, seed=SEED + 9))   # warm-up
    prefills.clear()
    steps.clear()
    prompts = lm_prompts(prompt_lens, cfg.vocab_size)
    n0 = eng.n_steps
    torch.cuda.synchronize()
    # ---- the main path: counts set to 0 just before, read just after --
    ops.reset_launch_counts()
    designs0 = dict(kfa.launches_by_design)
    t0 = time.perf_counter()
    out = eng.serve(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # flash launches by the design of the kernel each ran (the C
    # library's record)
    by_design = {n: kfa.launches_by_design[n] - designs0[n]
                 for n in kfa.DESIGNS}
    n_pre, n_dec = len(prefills), eng.n_steps - n0
    norms, attn = LM_LAUNCHES[cfg.name]
    expect = {name: 0 for name in counts}
    expect["flash_attention"] = attn * n_pre
    expect["rmsnorm"] = norms * (n_pre + n_dec)
    print(f"[{tag}] {cfg.name} bf16, {LM_SLOTS} slots: {len(prompts)} "
          f"requests of {list(prompt_lens)} tokens, {n_pre} prefills "
          f"{[p[0] for p in prefills]}, {n_dec} decode steps in "
          f"{wall:.3f} s", flush=True)
    print(f"[{tag}] launch counts {counts}, expected {expect} ({norms} "
          f"rmsnorm launches a forward, {attn} flash launches a prefill); "
          f"flash launches by design {by_design}", flush=True)
    if counts != expect or not n_pre or not n_dec:
        fail(f"LM launch counts {counts} != expected {expect}")
    if sum(by_design.values()) != expect["flash_attention"]:
        fail(f"LM flash launches by design {by_design} do not sum to "
             f"{expect['flash_attention']}")
    for i, toks in enumerate(out):
        if len(toks) != LM_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in toks):
            fail(f"LM request {i}: {len(toks)} tokens, range "
                 f"[{min(toks)}, {max(toks)}] (vocab {cfg.vocab_size})")
    n_tok = sum(len(t) for t in out)
    by_bucket = {}
    for shape, ms in prefills:
        by_bucket.setdefault(f"B={shape[0]} S={shape[1]}", []).append(ms)
    for key, ts in sorted(by_bucket.items()):
        cap = ""
        if cfg.moe is not None:
            b, s_ = (int(v.split("=")[1]) for v in key.split())
            cap = (f" (MoE capacity C = {moe.capacity(b * s_, cfg.moe)} "
                   f"slots an expert for T = {b * s_} tokens)")
        print(f"[{tag}] prefill {key}: {', '.join(f'{t:.2f}' for t in ts)}"
              f" ms{cap}", flush=True)
    step_ms = float(np.median(steps))
    print(f"[{tag}] decode step at {LM_SLOTS} slots: median {step_ms:.3f}"
          f" ms (min {min(steps):.3f}, max {max(steps):.3f}) over {n_dec}; "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s "
          f"(prefills included)", flush=True)
    return {"engine": eng, "counts": counts, "flash_by_design": by_design,
            "prefills": prefills,
            "prefill_ms": {k: float(np.median(v))
                           for k, v in by_bucket.items()},
            "decode_step_ms": step_ms, "decode_steps": steps,
            "n_prefills": n_pre, "n_decode_steps": n_dec, "wall_s": wall,
            "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "launches_per_forward": {"rmsnorm": norms,
                                     "flash_attention_per_prefill": attn}}


def padded(prompt, bucket, dev):
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(prompt)] = prompt
    return (torch.from_numpy(toks).to(dev),
            torch.tensor([len(prompt)], dtype=torch.int32, device=dev))


def logit_gap(lm_k, lm_r, params, prompt, bucket, ring, vocab, dev) -> float:
    """max|kernel - plain| / max|plain| of one prompt's prefill logits."""
    toks, lens = padded(prompt, bucket, dev)

    def logits(lm):
        out, _ = lm.prefill(params, {"tokens": toks}, lengths=lens,
                            cache_len=ring)
        return out[:, :vocab].float()
    lk, lr = logits(lm_k), logits(lm_r)
    if not torch.isfinite(lk).all():
        fail(f"non-finite prefill logits at {len(prompt)} tokens")
    return ((lk - lr).abs().max() / lr.abs().max()).item()


def first_layers(cfg, params, n_layers: int):
    """`cfg` and `params` cut to their first `n_layers` layers (a whole
    number of periods), every width unchanged."""
    P = LM(cfg).P
    if n_layers % P:
        fail(f"{cfg.name}: {n_layers} layers is no multiple of the period {P}")
    cut = {k: v for k, v in params.items() if k != "layers"}
    cut["layers"] = tree_map(lambda a: a[:n_layers // P], params["layers"])
    return replace(cfg, n_layers=n_layers), cut


def lm_parity_phase(dev, cfg, params, prompt_lens=LM_PARITY_PROMPTS,
                    buckets=LM_BUCKETS, fp32_layers=None,
                    gated=(torch.float32, torch.bfloat16),
                    tag="lm parity") -> dict:
    """Kernel path vs plain path: fp32 tokens equal and prefill logits
    (at `fp32_layers` layers when given: the full depth in fp32 would not
    fit beside the bf16 weights); bf16 prefill logits at full depth.  The
    logit gaps of the dtypes in `gated` are held to LM_LOGIT_RTOL; the
    others are printed only (see LM_LOGIT_RTOL and `layer_parity`)."""
    cfg32, p32 = ((cfg, params) if fp32_layers is None
                  else first_layers(cfg, params, fp32_layers))
    cfg32 = replace(cfg32, dtype="float32")
    params32 = tree_map(lambda a: a.float(), p32)
    prompts = lm_prompts(prompt_lens, cfg.vocab_size, seed=SEED + 1)
    res, engines = {}, {}
    for mode in ("kernel", "ref"):
        eng = lm_engine(dev, cfg32, params32, KernelPolicy(mode), buckets)
        t0 = time.perf_counter()
        res[mode] = eng.serve(prompts)
        torch.cuda.synchronize()
        print(f"[{tag}] {cfg32.name} fp32 ({cfg32.n_layers} layers) "
              f"policy={mode}: {len(prompts)} requests of "
              f"{list(prompt_lens)} tokens, {eng.n_steps} decode "
              f"steps, {time.perf_counter() - t0:.3f} s", flush=True)
        engines[mode] = eng
    n_eq = sum(a == b for a, b in zip(res["kernel"], res["ref"]))
    print(f"[{tag}] fp32 tokens equal for {n_eq}/{len(prompts)} "
          f"requests", flush=True)
    if n_eq != len(prompts):
        fail(f"fp32 kernel and plain paths' tokens differ: "
             f"{res['kernel']} vs {res['ref']}")
    ring = engines["kernel"]._ring_len
    gaps = {}
    for dtype, lms, p in (
            (torch.float32, (engines["kernel"].lm, engines["ref"].lm),
             params32),
            (torch.bfloat16, (LM(cfg, KernelPolicy("kernel")),
                              LM(cfg, KernelPolicy("ref"))), params)):
        dt_tag = "fp32" if dtype == torch.float32 else "bf16"
        n_layers = cfg32.n_layers if dtype == torch.float32 else cfg.n_layers
        limit = LM_LOGIT_RTOL[dtype] if dtype in gated else None
        for prompt in (prompts[0], prompts[1]):
            bucket = engines["kernel"]._bucket(len(prompt))
            g = logit_gap(*lms, p, prompt, bucket, ring, cfg.vocab_size, dev)
            gaps[f"{dt_tag} {len(prompt)} tokens"] = {"gap": g,
                                                      "limit": limit}
            print(f"[{tag}] {dt_tag} prefill logits ({n_layers} layers), "
                  f"{len(prompt)} tokens in bucket {bucket}: max|kernel - "
                  f"plain| / max|plain| = {g:.3e}; "
                  + (f"limit {limit:.0e}" if limit is not None else
                     "not held to a limit (the layers are, `layer_parity`)"),
                  flush=True)
            if limit is not None and g > limit:
                fail(f"{cfg.name} {dt_tag} prefill logits: kernel vs plain "
                     f"relative gap {g} > {limit}")
    del engines, params32
    torch.cuda.empty_cache()
    return {"fp32_tokens_equal": n_eq, "fp32_layers": cfg32.n_layers,
            "logit_gaps": gaps}


@contextlib.contextmanager
def moe_bypassed(seen: list):
    """`moe.apply_moe` replaced by a block that records its input (norm2's
    output) in `seen` and adds nothing to the residual."""
    real = moe.apply_moe

    def bypass(p, h, *args, **kwargs):
        seen.append(h)
        return torch.zeros_like(h), None
    moe.apply_moe = bypass
    try:
        yield
    finally:
        moe.apply_moe = real


def layer_parity(dev, cfg, params, prompt, bucket, dtype, tag) -> dict:
    """Each layer of `cfg` fed the same hidden state on the kernel and the
    plain policy, at one served prefill (`prompt` right-padded to
    `bucket`, its length passed as in serving): every layer's output held
    to LM_TOL[dtype] norm-wise, max|kernel - plain| <= atol + rtol ·
    max|plain|, and the next layer fed the plain path's output, so no
    layer sees another's departure.  fp32 casts one layer at a time.  In
    bf16 one ulp of an MoE block's input can flip a top-k choice (a
    different expert, not a rounding), so there the block is bypassed
    (`moe_bypassed`) and its input, norm2's output, is held beside the
    layer's output without it; fp32 holds the whole MoE layer."""
    P = LM(cfg).P
    cfg1 = replace(cfg, n_layers=P)
    lms = {m: LM(cfg1, KernelPolicy(m)) for m in ("kernel", "ref")}
    toks, lens = padded(prompt, bucket, dev)
    x = params["embed"]["w"][toks.long()].to(dtype)
    positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None]
    lengths = lens.long()
    bypass = dtype == torch.bfloat16 and cfg.moe is not None
    gaps, worst = [], (-1.0, "")
    for r in range(cfg.n_layers // P):
        cut = {"layers": tree_map(lambda a: a[r:r + 1].to(
            dtype if a.dtype == torch.bfloat16 else a.dtype),
            params["layers"])}
        outs = {}
        for mode, lm in lms.items():
            seen = []
            with moe_bypassed(seen) if bypass else contextlib.nullcontext():
                y, _ = lm._layers(cut, x, positions, lengths=lengths)
            outs[mode] = [y] + seen
        for i, (k, p) in enumerate(zip(outs["kernel"], outs["ref"])):
            d = (k.float() - p.float()).abs().max().item()
            m = p.float().abs().max().item()
            what = "block input" if i else "output"
            tol = LM_TOL[dtype]
            gaps.append({"layers": f"{r * P}-{r * P + P - 1}", "what": what,
                         "max_abs_diff": d, "max_abs": m, "gap": d / m})
            if not (np.isfinite(d) and d <= tol["atol"] + tol["rtol"] * m):
                fail(f"{cfg.name} {tag} layers {r * P}-{r * P + P - 1} "
                     f"{what}: max|kernel - plain| {d} > {tol['atol']} + "
                     f"{tol['rtol']} * {m}")
            worst = max(worst, (d / m, gaps[-1]["layers"] + " " + what))
        if bypass:
            x, _ = lms["ref"]._layers(cut, x, positions, lengths=lengths)
        else:
            x = outs["ref"][0]
        del cut, outs
    rel = [g["gap"] for g in gaps]
    print(f"[{tag}] each of {cfg.name}'s {cfg.n_layers} layers on the same "
          f"input, {len(prompt)} tokens in bucket {bucket}"
          + (" (MoE blocks bypassed: outputs and block inputs)" if bypass
             else "")
          + f": max|kernel - plain| / max|plain| median {np.median(rel):.3e}"
          f", worst {worst[0]:.3e} ({worst[1]}); limit {LM_TOL[dtype]} "
          f"norm-wise; ok", flush=True)
    torch.cuda.empty_cache()
    return {"gaps": gaps, "worst": worst[0], "worst_at": worst[1],
            "median": float(np.median(rel)), "tol": LM_TOL[dtype],
            "moe_bypassed": bypass}


def flash_key(h, kv, S, d, b=1) -> str:
    return (f"{b}x" if b > 1 else "") + f"{h}/{kv}x{S}x{d}"


def lm_timing_phase(dev, flash_shapes=LM_FLASH_TIMED, rms_shapes=LM_NORM_TIMED,
                    ln_shapes=(), tag="lm timing") -> dict:
    """Per-launch device times of the LM kernels at full-width bf16
    shapes (by default the three LM paths' of phase 10; flash (B, H, K,
    S, D, window), the norms (rows, D)), their plain versions, the
    library calls (SDPA without TF32; F.rms_norm; F.layer_norm) and the
    bounds (each input byte read once and each output byte written once;
    4·D flops an unmasked (q, k) pair and head at the bf16 peak).

    SDPA is timed twice where a window is set: with the band as an
    explicit mask (`library_ms`, the only SDPA route once the window
    binds) and, where the window does not bind (S <= window), with
    `is_causal` and no mask (`library_causal_ms`), the same function on
    SDPA's flash backend.  `vs_library` is the kernel over the causal
    call where there is one, else over the masked call."""
    gen = torch.Generator().manual_seed(SEED + 3)
    out = {"flash_attention": {}, "rmsnorm": {}, "layernorm": {}}
    for B, H, K, S, D, win in flash_shapes:
        q, k, v = attn_inputs(dev, gen, B, H, K, S, S, D, torch.bfloat16)
        pos = torch.arange(S, device=dev)
        mask = None if win is None else (
            (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < win))
        want = ref.flash_attention(q, k, v, causal=True, window=win).float()

        def sdpa(q=q, k=k, v=v, mask=mask):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=H != K)

        def sdpa_causal(q=q, k=k, v=v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=H != K)

        def yardstick(fn, name):
            try:
                return fn, (fn().float() - want).abs().max().item()
            except (RuntimeError, TypeError) as e:    # a yardstick only
                print(f"[{tag}] scaled_dot_product_attention ({name}) "
                      f"refused {flash_key(H, K, S, D, B)}: {e}", flush=True)
                return None, None
        sdpa, lib_err = yardstick(sdpa, "band mask" if win else "is_causal")
        sdpa_causal, causal_err = (
            yardstick(sdpa_causal, "is_causal")
            if win is not None and S <= win else (None, None))
        del want
        pairs = attn_pairs(S, S, win)
        flops = flash_flops(q, k, True, win)
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        r = {"ms": device_ms(lambda q=q, k=k, v=v: kfa.flash_attention(
                 q, k, v, causal=True, window=win), n=10),
             "plain_ms": device_ms(lambda q=q, k=k, v=v: ref.flash_attention(
                 q, k, v, causal=True, window=win), n=5),
             "library_ms": None if sdpa is None else device_ms(sdpa, n=10),
             "library_causal_ms": (None if sdpa_causal is None
                                   else device_ms(sdpa_causal, n=10)),
             "bound_ms": bound_ms(nbytes, flops, PEAK_BF16),
             "bound_by": "bytes" if nbytes / PEAK_BYTES > flops / PEAK_BF16
             else "operations",
             "pairs": pairs, "flops": flops, "bytes": nbytes,
             "library_max_abs_err": lib_err,
             "library_causal_max_abs_err": causal_err}
        r["peak_share"] = flops / (r["ms"] * 1e-3) / PEAK_BF16
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["design"] = kfa.design(D, torch.bfloat16)
        yard = r["library_causal_ms"] or r["library_ms"]
        r["vs_library"] = None if yard is None else r["ms"] / yard
        out["flash_attention"][flash_key(H, K, S, D, B)] = r
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us ("
               + ("band mask, " if win else "") + f"max|diff| {lib_err})")
        if r["library_causal_ms"] is not None:
            lib += (f", is_causal {r['library_causal_ms'] * 1e3:.1f} us "
                    f"(max|diff| {causal_err})")
        if yard is not None:
            lib += f", kernel/sdpa {r['vs_library']:.3f}"
        print(f"[{tag}] flash_attention bf16 ({B}, {H}/{K}, {S}, {D}) "
              f"w={win}, design {r['design']}: kernel "
              f"{r['ms'] * 1e3:.1f} us ({100 * r['bound_share']:.1f}% of "
              f"its bound), plain "
              f"{r['plain_ms'] * 1e3:.1f} us, sdpa {lib}, "
              f"bound {r['bound_ms'] * 1e3:.1f} us "
              f"({r['bound_by']}; {pairs} pairs/head); "
              f"{flops / r['ms'] / 1e9:.1f} TFLOP/s = "
              f"{100 * r['peak_share']:.1f}% of the bf16 peak", flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()
    for rows, D in rms_shapes:
        x = torch.randn((rows, D), generator=gen).to(dev, torch.bfloat16)
        sc = torch.ones((D,), device=dev)
        sc16 = sc.to(torch.bfloat16)
        nbytes = 2 * 2 * rows * D + 4 * D
        flops = 4 * rows * D
        r = {"ms": device_ms(lambda x=x, sc=sc: kln.rmsnorm(x, sc)),
             "plain_ms": device_ms(lambda x=x, sc=sc: ref.rmsnorm(x, sc)),
             "library_ms": device_ms(lambda x=x, sc16=sc16, D=D: F.rms_norm(
                 x, (D,), weight=sc16, eps=1e-6)),
             "bound_ms": bound_ms(nbytes, flops, PEAK_BF16),
             "bound_by": "bytes", "bytes": nbytes}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["vs_library"] = r["ms"] / r["library_ms"]
        out["rmsnorm"][f"{rows}x{D}"] = r
        print(f"[{tag}] rmsnorm bf16 ({rows}, {D}): kernel "
              f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
              f"F.rms_norm {r['library_ms'] * 1e3:.2f} us (kernel/library "
              f"{r['vs_library']:.3f}), bound {r['bound_ms'] * 1e3:.3f} us "
              f"(bytes; {100 * r['bound_share']:.1f}% of it); "
              f"{nbytes / r['ms'] / 1e6:.1f} GB/s", flush=True)
    for rows, D in ln_shapes:
        x = torch.randn((rows, D), generator=gen).to(dev, torch.bfloat16)
        sc = 1 + 0.1 * torch.randn((D,), generator=gen).to(dev)
        bi = 0.1 * torch.randn((D,), generator=gen).to(dev)
        sc16, bi16 = sc.to(torch.bfloat16), bi.to(torch.bfloat16)
        nbytes = 2 * 2 * rows * D + 2 * 4 * D
        flops = 7 * rows * D
        r = {"ms": device_ms(lambda x=x, sc=sc, bi=bi: kln.layernorm(
                 x, sc, bi, eps=1e-6)),
             "plain_ms": device_ms(lambda x=x, sc=sc, bi=bi: ref.layernorm(
                 x, sc, bi, eps=1e-6)),
             "library_ms": device_ms(
                 lambda x=x, sc16=sc16, bi16=bi16, D=D: F.layer_norm(
                     x, (D,), weight=sc16, bias=bi16, eps=1e-6)),
             "bound_ms": bound_ms(nbytes, flops, PEAK_BF16),
             "bound_by": "bytes", "bytes": nbytes}
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["vs_library"] = r["ms"] / r["library_ms"]
        out["layernorm"][f"{rows}x{D}"] = r
        print(f"[{tag}] layernorm bf16 ({rows}, {D}): kernel "
              f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
              f"F.layer_norm {r['library_ms'] * 1e3:.2f} us (kernel/library "
              f"{r['vs_library']:.3f}), bound {r['bound_ms'] * 1e3:.3f} us "
              f"(bytes; {100 * r['bound_share']:.1f}% of it); "
              f"{nbytes / r['ms'] / 1e6:.1f} GB/s", flush=True)
    return out


def total(table, parts, work) -> dict:
    """The kernels JSON numbers of the work of several launches: each
    time of `table` (a timing phase's rows) summed over `parts`, (count,
    shape key) pairs, and the first part's `bound_by`."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    out = {k: (None if any(table[s][k] is None for _, s in parts)
               else sum(n * table[s][k] for n, s in parts)) for k in keys}
    return dict(out, bound_by=table[parts[0][1]]["bound_by"],
                work=work + " (device time)")


def lm_kernel_rows(timing) -> dict:
    """The kernels JSON numbers of the LM kernels, from this run's times:
    the sum over the launches of one h2o-danube-1.8b 6144-token prefill
    (24 flash launches at S = 6144; 48 rmsnorm launches over (6144, 2560),
    the final one over one row), and under each other model's name the
    same for its work: mamba2-1.3b's rmsnorm launches of one 6144-token
    prefill (48 over (6144, 2048), 48 gated over (6144, 4096), the final
    one over one row) and of one decode step at LM_SLOTS slots;
    qwen2-moe-a2.7b's of one 2048-token prefill (48 over (2048, 2048),
    1 over one row) and its 24 flash launches at S = 2048."""
    fa, rn = timing["flash_attention"], timing["rmsnorm"]
    S, Sm = LM_BUCKETS[-1], MOE_BUCKETS[-1]
    h2o_fa, moe_fa = flash_key(32, 8, S, 80), flash_key(16, 16, Sm, 128)
    return {
        "rmsnorm": dict(
            total(rn, [(48, f"{S}x2560"), (1, "1x2560")],
                  f"{LM_ARCH}: the 49 launches of one {S}-token prefill: 48 "
                  f"over {S} rows, 1 over the last row"),
            **{MAMBA_ARCH: dict(
                total(rn, [(48, f"{S}x2048"), (48, f"{S}x4096"),
                           (1, "1x2048")],
                      f"the 97 launches of one {S}-token prefill: 48 over "
                      f"({S}, 2048), 48 gated over ({S}, 4096), 1 over one "
                      f"row"),
                decode_step=total(
                    rn, [(49, f"{LM_SLOTS}x2048"), (48, f"{LM_SLOTS}x4096")],
                    f"the 97 launches of one decode step at "
                             f"{LM_SLOTS} slots")),
               MOE_ARCH: total(rn, [(48, f"{Sm}x2048"), (1, "1x2048")],
                               f"the 49 launches of one {Sm}-token prefill: "
                               f"48 over ({Sm}, 2048), 1 over one row")}),
        "flash_attention": dict(
            total(fa, [(24, h2o_fa)],
                  f"{LM_ARCH}: the 24 launches of one {S}-token prefill"),
            **{MOE_ARCH: total(fa, [(24, moe_fa)],
                               f"the 24 launches of one {Sm}-token prefill, "
                               f"(1, 16, {Sm}, 128) causal")})}


def lm_profile(eng, dev, vocab, prefill_ms, step_ms, tag="lm bf16") -> dict:
    """Profiler breakdowns of one 2048-token prefill (1 row) and one
    decode step at LM_SLOTS slots on the bf16 kernel path."""
    toks, lens = padded(lm_prompts((2048,), vocab, seed=SEED + 4)[0], 2048,
                        dev)
    eng._prefill(toks, lens)
    pre = device_breakdown(lambda: eng._prefill(toks, lens), tag,
                           "1-row 2048-token prefill", prefill_ms)
    batch = {"tokens": eng._tokens}
    eng.lm.decode_step(eng.params, eng.cache, batch)
    dec = device_breakdown(
        lambda: eng.lm.decode_step(eng.params, eng.cache, batch), tag,
        f"decode step at {LM_SLOTS} slots", step_ms)
    return {"prefill_2048": pre, "decode_step": dec}


# ---------------------------------------------------------------------------
# prune phases: beam_prune
# ---------------------------------------------------------------------------
def prune_scores(dev, n, seed, case="random", beam=BP_BEAM):
    """(n,) f32 scores, scale 10, for one `case`: "random", "nan" (one
    NaN), "neg_inf" (all -inf), "pos_inf" (two +inf entries) or "tie" (a
    score exactly on fp32(max - fp32(beam)), kept, and one an ulp below
    it, masked); with the indices and values the tie must give."""
    s = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 10
    want = {}
    if case == "nan":
        s[n // 3] = np.nan
    elif case == "neg_inf":
        s[:] = -np.inf
    elif case == "pos_inf":
        s[[1, n - 2]] = np.inf
    elif case == "tie":
        i = (int(s.argmax()) + 1) % (n - 1)
        thr = np.float32(s.max()) - np.float32(beam)
        s[i], s[i + 1] = thr, np.nextafter(thr, np.float32(-np.inf))
        want = {i: float(thr), i + 1: float(np.float32(ref.MASK))}
    return torch.from_numpy(s).to(dev), want


def check_beam_prune(dev) -> float:
    """beam_prune vs its plain version, bitwise (compared as int32 bit
    patterns), one launch a call.  Returns the max |kernel - plain| over
    the entries finite in both, measured over every case (any bit that
    differs fails the run)."""
    cap = kbp.capacity(dev)
    cases = [(n, "random", b) for n in (1, 100, 1000, 1025, 8320, BP_N)
             for b in (1.0, 5.0, 25.0)]
    cases += [(n, "random", BP_BEAM) for n in (kbp.SMALL, kbp.SMALL + 1,
                                               BP_BIG, cap - 1, cap + 1)]
    cases += [(n, c, b) for n in (BP_N, BP_BIG)
              for c, b in (("nan", 5.0), ("neg_inf", 5.0),
                           ("pos_inf", BP_BEAM), ("tie", 0.1))]
    err = 0.0
    for i, (n, case, beam) in enumerate(cases):
        s, tie = prune_scores(dev, n, SEED + 10 + i, case, beam)
        ops.reset_launch_counts()
        got = kbp.beam_prune(s, beam)
        torch.cuda.synchronize()
        if ops.launch_counts()["beam_prune"] != 1:
            fail(f"beam_prune N={n}: {ops.launch_counts()['beam_prune']} "
                 f"launches for one call (must be one at every N)")
        want = ref.beam_prune(s, beam)
        label = f"N={n} {case} beam={beam}"
        both = torch.isfinite(got) & torch.isfinite(want)
        if both.any():
            err = max(err, (got[both] - want[both]).abs().max().item())
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            bad = (got.view(torch.int32) != want.view(torch.int32)).sum()
            fail(f"beam_prune {label}: {bad.item()} of {n} entries differ "
                 f"from the plain version (must be bitwise)")
        for j, v in tie.items():
            if got[j].item() != v:
                fail(f"beam_prune {label}: entry {j} is {got[j].item()}, "
                     f"the threshold semantics give {v}")
        kept = int((got != ref.MASK).sum().item())
        print(f"[prune check] {label:34s} bitwise equal ok, one launch "
              f"({kept} of {n} kept)", flush=True)
    return err


def beam_prune_phase(dev) -> dict:
    """The prune path: `ops.beam_prune` as the reference benchmark calls
    it (N = 8448, beam 25), BP_CALLS calls on seeded scores; counts set
    to 0 just before, read just after; each output checked bitwise
    against the plain version and for its threshold semantics."""
    scores = [prune_scores(dev, BP_N, SEED + 100 + i)[0]
              for i in range(BP_CALLS)]
    torch.cuda.synchronize()
    # ---- the main path: counts set to 0 just before, read just after --
    ops.reset_launch_counts()
    outs = [ops.beam_prune(s, BP_BEAM) for s in scores]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect = {name: 0 for name in counts}
    expect["beam_prune"] = BP_CALLS
    print(f"[prune path] {BP_CALLS} calls of ops.beam_prune at N={BP_N} "
          f"beam={BP_BEAM}: launch counts {counts}", flush=True)
    if counts != expect:
        fail(f"beam_prune launch counts {counts} != expected {expect}")
    for s, out in zip(scores, outs):
        keep = s >= s.max() - BP_BEAM
        if out.shape != s.shape or not torch.equal(out[keep], s[keep]) \
                or not (out[~keep] == ref.MASK).all():
            fail("beam_prune output breaks the threshold semantics")
        if not torch.equal(out.view(torch.int32),
                           ref.beam_prune(s, BP_BEAM).view(torch.int32)):
            fail("beam_prune on the prune path differs from its plain "
                 "version")
        print(f"[prune path] kept {int(keep.sum().item())} of {BP_N}, "
              f"max {s.max().item():.4f}", flush=True)
    return counts


def beam_prune_timing(dev, before=None) -> dict:
    """Device time of one call of the kernel and of its plain version at
    N = 8448 and N = BP_BIG, the kernel with its launch, and the bound:
    8 N bytes (each score read once, each output written once) at the
    HBM rate.  No single PyTorch call computes this function.  Repeated
    calls find the scores in the 50 MB L2; `cold_ms` flushes it first
    (a read of 256 MB, untimed), the case the HBM bound describes.
    Beside, the same 8 N bytes as torch's copy of the scores (`copy_ms`,
    `copy_cold_ms`): what one launch that moves them takes here.  With
    `before`: the parent's kernel on the same scores (`before_ms`,
    `before_cold_ms`)."""
    flush = torch.empty((64 << 20,), dtype=torch.float32, device=dev)
    flush.fill_(0.0)
    out = {}
    for n in (BP_N, BP_BIG):
        s, _ = prune_scores(dev, n, SEED + 200)
        nbytes, flops = 8 * n, 2 * n
        r = {"ms": device_ms(lambda s=s: kbp.beam_prune(s, BP_BEAM)),
             "plain_ms": device_ms(lambda s=s: ref.beam_prune(s, BP_BEAM)),
             "launch_inclusive_ms": host_ms(
                 lambda s=s: kbp.beam_prune(s, BP_BEAM)),
             "library_ms": None,
             "bound_ms": bound_ms(nbytes, flops),
             "bound_by": "bytes", "bytes": nbytes}
        r["cold_ms"] = device_ms(lambda s=s: kbp.beam_prune(s, BP_BEAM),
                                 prep=flush.amax)
        r["copy_ms"] = device_ms(s.clone)
        r["copy_cold_ms"] = device_ms(s.clone, prep=flush.amax)
        if before is not None:
            r["before_ms"] = device_ms(
                lambda s=s: before.beam_prune(s, BP_BEAM))
            r["before_cold_ms"] = device_ms(
                lambda s=s: before.beam_prune(s, BP_BEAM), prep=flush.amax)
        out[n] = r
        print(f"[prune timing] beam_prune N={n}: kernel {r['ms'] * 1e3:.2f} "
              f"us, plain {r['plain_ms'] * 1e3:.2f} us, kernel call with "
              f"launch {r['launch_inclusive_ms'] * 1e3:.2f} us, library -, "
              f"bound {r['bound_ms'] * 1e3:.3f} us (bytes, 8N); "
              f"{nbytes / r['ms'] / 1e6:.1f} GB/s; L2 flushed first: kernel "
              f"{r['cold_ms'] * 1e3:.2f} us; a copy of the scores "
              f"{r['copy_ms'] * 1e3:.2f} us, L2 flushed "
              f"{r['copy_cold_ms'] * 1e3:.2f} us"
              + ("" if before is None else
                 f"; parent's kernel {r['before_ms'] * 1e3:.2f} us, L2 "
                 f"flushed {r['before_cold_ms'] * 1e3:.2f} us"),
              flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the network front-end
# ---------------------------------------------------------------------------
async def on_server(server, fn):
    """Run `fn(server)` against a started server, then close it."""
    await server.start()
    try:
        return await fn(server)
    finally:
        await server.aclose()


async def wait_for(pred, what: str):
    """Await `pred()` (a coroutine function) until it returns something
    true; raise after NET_WAIT_S seconds (an exception, not `fail`'s
    SystemExit, so the caller's server still closes)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + NET_WAIT_S
    while loop.time() < deadline:
        res = await pred()
        if res:
            return res
        await asyncio.sleep(0.02)
    raise TimeoutError(f"network: {what} not reached within {NET_WAIT_S} s")


async def net_stream(host, port, audio, chunk, stagger_s=0.0, retries=0,
                     seed=0, opened=None, hold=None):
    """One client as benchmarks/load.py's `_run_stream` measures it: open
    after `stagger_s` (retrying 503s `retries` times), then
    `drive_stream`.  `opened` (an asyncio.Event) is set once the session
    is open; `hold` (an awaitable) is awaited before the finish."""
    await asyncio.sleep(stagger_s)
    t0 = time.perf_counter()
    client = await AsrClient.open(host, port, retries=retries, backoff=0.02,
                                  backoff_cap=0.5, seed=seed)
    if opened is not None:
        opened.set()
    return await drive_stream(client, audio, chunk, t0, hold)


async def drive_stream(client, audio, chunk, t0, hold=None):
    """Push `chunk` samples at a time with a poll after each, then finish.
    first_result_s runs from `t0` to the first poll whose hypothesis
    covers a decoded step, finalize_s is the finish round trip.  An
    in-stream error ends the stream and is returned as its final."""
    first = None
    for off in range(0, len(audio), chunk):
        for op in (lambda: client.push(audio[off:off + chunk]), client.poll):
            res = await op()
            if res.get("error"):
                await client.aclose()
                return {"final": res, "audio_s": len(audio) / 16000.0}
        if first is None and res["steps"] > 0:
            first = time.perf_counter() - t0
    if hold is not None:
        await hold
    t_fin = time.perf_counter()
    final = await client.finish()
    t_end = time.perf_counter()
    return {"final": final, "audio_s": len(audio) / 16000.0,
            "first_result_s": t_end - t0 if first is None else first,
            "finalize_s": t_end - t_fin}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def as_wire(result: dict) -> dict:
    """An in-process result as its wire payload (lists, numbers)."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in result.items()}


def check_wire(tag, got, want):
    """A stream's final payload against an in-process result: words,
    tokens and steps equal, scores within NET_RTOL."""
    g, w = got["final"], as_wire(want)
    if g.get("error"):
        fail(f"{tag}: the stream ended in an error: {g}")
    same = all(g[k] == w[k] for k in ("words", "tokens", "steps"))
    if not same or not np.isclose(g["score"], w["score"], rtol=NET_RTOL,
                                  atol=0.0):
        fail(f"{tag}: over the wire {g}, in process {w}")


def pct_ms(vals, q) -> float:
    return float(np.percentile(np.asarray(vals, float), q)) * 1e3


def net_serving(dev, system, utts, want, policy) -> dict:
    """Phase 5's system served over the wire by an EngineServer of
    NET_SLOTS slots and a queue of NET_MAX_QUEUE: a warm-up wave of
    NET_SLOTS streams (excluded), the measured wave of the utterances from
    staggered clients (launch counts set to 0 just before it and read just
    after), and a burst.  For the burst the utterances' streams again hold
    every slot and the whole queue (each holds its finish) while NET_BURST
    clients open with retries; the holders let go only once /metrics
    counts a 503 for each of them, so every burst client meets the full
    queue and must ride it out.  Every stream's words, tokens and steps
    must equal `want` (the in-process results), scores within NET_RTOL."""
    tds_cfg, _, lex, lm, params, dec_cfg = system
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg)
    eng = AsrEngine(EngineConfig(prog, n_slots=NET_SLOTS, kernels=policy,
                                 max_queue=NET_MAX_QUEUE), params, device=dev)
    chunk = eng.plan.samples_per_step
    out = {}

    async def go(server):
        h, p = server.host, server.port
        await asyncio.gather(*[net_stream(h, p, utts[i], chunk,
                                          NET_STAGGER_S * i)
                               for i in range(NET_SLOTS)])   # warm-up
        n0 = len(eng.step_shapes)
        sync(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        wave = await asyncio.gather(*[
            net_stream(h, p, u, chunk, NET_STAGGER_S * i)
            for i, u in enumerate(utts)])
        out["wall_s"] = time.perf_counter() - t0
        sync(dev)
        out["counts"] = ops.launch_counts()
        out["steps"] = list(eng.step_shapes)[n0:]
        out["wave"] = wave

        # the burst: the holders fill the slots and the queue, the burst
        # opens with retries, the holders finish once it has met 503s
        opened = [asyncio.Event() for _ in utts]
        release = asyncio.get_running_loop().create_future()
        holders = [asyncio.create_task(net_stream(
            h, p, u, chunk, NET_STAGGER_S * i, opened=opened[i],
            hold=release)) for i, u in enumerate(utts)]
        for ev in opened:
            await ev.wait()
        before = (await fetch_metrics(h, p))["asr"]["sessions"]["rejected"]
        burst = [asyncio.create_task(net_stream(
            h, p, utts[i], chunk, retries=NET_RETRIES, seed=i))
            for i in range(NET_BURST)]

        async def burst_rejected():
            m = await fetch_metrics(h, p)
            n = m["asr"]["sessions"]["rejected"] - before
            return n if n >= NET_BURST else 0
        try:
            out["burst_503"] = await wait_for(
                burst_rejected, f"a 503 for each of the burst's {NET_BURST} "
                f"clients")
        finally:
            release.set_result(None)
        out["held"] = await asyncio.gather(*holders)
        out["burst"] = await asyncio.gather(*burst)
        out["metrics"] = await fetch_metrics(h, p)
        return out

    asyncio.run(on_server(EngineServer(asr_engine=eng), go))
    for i, (r, w) in enumerate(zip(out["wave"], want)):
        check_wire(f"network wave utt {i}", r, w)
    for i, (r, w) in enumerate(zip(out["held"], want)):
        check_wire(f"network burst-wave utt {i}", r, w)
    for i, r in enumerate(out["burst"]):
        check_wire(f"network burst stream {i}", r, want[i])
    m = out["metrics"]["asr"]
    # `Engine.open` samples the depth after appending and before admitting:
    # an open that finds the queue full and a slot just released reads
    # max_queue + 1 and is admitted in the same call (as in the reference;
    # tests/test_torch_engine.py pins it).  More than that is a fault.
    if m["queue"]["max_depth"] > NET_MAX_QUEUE + 1:
        fail(f"network: queue depth {m['queue']['max_depth']} above "
             f"max_queue + 1 = {NET_MAX_QUEUE + 1}")
    wave = out["wave"]
    audio_s = sum(len(u) for u in utts) / 16000.0
    return {
        "utterances": len(utts), "audio_s": audio_s,
        "wire_wall_s": out["wall_s"],
        "wire_x_realtime": audio_s / out["wall_s"],
        "first_result_ms": {f"p{q}": pct_ms(
            [r["first_result_s"] for r in wave], q) for q in (50, 99)},
        "finalize_ms": {f"p{q}": pct_ms(
            [r["finalize_s"] for r in wave], q) for q in (50, 99)},
        "counts": out["counts"], "steps": out["steps"],
        "burst_503": out["burst_503"],
        "metrics": {"queue_max_depth": m["queue"]["max_depth"],
                    "rejected": m["sessions"]["rejected"],
                    "restarts": m["workers"]["restarts"],
                    "sessions": m["sessions"]},
    }


def demo_results(dev, system, utts, policy) -> list:
    """The demo system's fault-free in-process results at 4 slots."""
    eng, _ = asr_demo_engine(4, policy, device=dev, system=system)
    res = eng.serve(utts)
    sync(dev)
    return res


def net_faults(dev, system, utts, clean, policy) -> dict:
    """The fault-tolerance paths on the demo system at 4 slots, each
    held against `clean` (fault-free in-process results).

      * an ``asr_step`` raise matched on session NET_POISON_SID: that
        stream ends with {"error": ..., "faulted": true}, the other three
        streams' results equal the clean run's;
      * a ``pump`` stall with worker_watchdog NET_WATCHDOG_S armed after a
        warm stream: /healthz answers 503 while the supervisor is held,
        then 200 with restarts >= 1 after the restart, and a fresh stream
        equals the clean run;
      * aclose(drain=True) with 4 streams mid-flight returns every result.
    """
    out = {}

    # -- a poisoned session is quarantined, the others are untouched --
    poison = FaultPolicy([FaultSpec(
        "asr_step", count=None, message="poisoned session",
        match=lambda ctx: NET_POISON_SID in ctx.get("sids", ()))])
    eng, _ = asr_demo_engine(4, policy, device=dev, system=system,
                             faults=poison)
    chunk = eng.plan.samples_per_step

    async def poisoned(server):
        h, p = server.host, server.port
        t0 = time.perf_counter()
        clients = [await AsrClient.open(h, p) for _ in utts]   # sids 0..3
        finals = await asyncio.gather(*[drive_stream(c, a, chunk, t0)
                                        for c, a in zip(clients, utts)])
        status, _ = await fetch_healthz(h, p)
        return finals, status, await fetch_metrics(h, p)
    finals, status, m = asyncio.run(on_server(EngineServer(asr_engine=eng),
                                              poisoned))
    bad = finals[NET_POISON_SID]["final"]
    if not (bad.get("faulted") and "poisoned session" in bad.get("error",
                                                                  "")):
        fail(f"network faults: the poisoned stream ended with {bad}")
    for i, (r, w) in enumerate(zip(finals, clean)):
        if i != NET_POISON_SID:
            check_wire(f"network faults: co-batched utt {i}", r, w)
    if status != 200 or m["asr"]["sessions"]["faulted"] != 1:
        fail(f"network faults: /healthz {status}, metrics {m['asr']}")
    out["poison"] = {"log": len(poison.log), "healthz": status}

    # -- a wedged worker is restarted by the heartbeat watchdog --
    arm = {"on": False}
    stall = FaultPolicy([FaultSpec("pump", action="stall", count=1,
                                   match=lambda ctx: arm["on"])],
                        stall_timeout=60.0)
    eng, _ = asr_demo_engine(4, policy, device=dev, system=system,
                             faults=stall, worker_watchdog=NET_WATCHDOG_S)

    async def wedged(server):
        h, p = server.host, server.port
        old = server._asr_worker
        warm = await net_stream(h, p, utts[0], chunk)
        check_wire("network watchdog: warm stream", warm, clean[0])
        server._supervisor.cancel()          # hold the supervisor
        try:
            await server._supervisor
        except asyncio.CancelledError:
            pass
        t0 = time.perf_counter()
        arm["on"] = True                     # the next pump stalls

        async def aged():
            return old.heartbeat_age() > NET_WATCHDOG_S
        await wait_for(aged, "the stalled worker's heartbeat age")
        arm["on"] = False
        wedged_status, wedged_payload = await fetch_healthz(h, p)
        server._supervisor = asyncio.get_running_loop().create_task(
            server._supervise())

        async def healthy():
            st, pl = await fetch_healthz(h, p)
            return (st, pl) if st == 200 else None
        status, payload = await wait_for(healthy, "/healthz 200 again")
        recovered_s = time.perf_counter() - t0
        stall.release()                      # the zombie meets the fence
        fresh = await net_stream(h, p, utts[1], chunk)
        return (wedged_status, wedged_payload, status, payload, fresh,
                recovered_s)
    (wst, wpl, st, pl, fresh, rec_s) = asyncio.run(on_server(
        EngineServer(asr_engine=eng, watch_interval=0.05), wedged))
    eh = wpl["engines"]["asr"]
    if wst != 503 or not eh["alive"] or eh["healthy"]:
        fail(f"network watchdog: a wedged worker gave /healthz {wst} {wpl}")
    if st != 200 or pl["engines"]["asr"]["restarts"] < 1:
        fail(f"network watchdog: after the restart /healthz {st} {pl}")
    check_wire("network watchdog: fresh stream after the restart", fresh,
               clean[1])
    out["watchdog"] = {"wedged_healthz": wst, "healthz": st,
                       "restarts": pl["engines"]["asr"]["restarts"],
                       "stall_to_healthy_s": rec_s}

    # -- graceful drain under load returns every result --
    eng, _ = asr_demo_engine(4, policy, device=dev, system=system)

    async def drained(server):
        h, p = server.host, server.port
        opened = [asyncio.Event() for _ in utts]
        tasks = [asyncio.create_task(net_stream(h, p, a, chunk,
                                                opened=opened[i]))
                 for i, a in enumerate(utts)]
        for ev in opened:
            await ev.wait()
        await server.aclose(drain=True, timeout=60.0)
        return await asyncio.gather(*tasks)
    finals = asyncio.run(on_server(EngineServer(asr_engine=eng), drained))
    for i, (r, w) in enumerate(zip(finals, clean)):
        check_wire(f"network drain: utt {i}", r, w)
    out["drain"] = {"results": len(finals),
                    "finalized": eng.metrics.finalized}
    return out


def net_launcher() -> dict:
    """`python -m repro_torch.launch.serve --serve --port 0` as a
    subprocess on the card: one /asr stream, one LM generation and
    /metrics through its printed address, then SIGTERM, which must drain
    it ("drained; server stopped") with exit code 0."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--serve",
           "--port", "0", "--streams", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving ASR"):
                break
        if not lines or not lines[-1].startswith("serving ASR"):
            fail(f"the --serve launcher printed no address: {''.join(lines)}")
        up_s = time.perf_counter() - t0
        addr = lines[-1].split("http://")[1].split()[0]
        host, port = addr.rsplit(":", 1)
        system = asr_demo_system()
        audio = SyntheticASR(system[1]).utterance(0)["audio"]

        async def go():
            r = await net_stream(host, int(port), audio, 1280)
            gen = await lm_generate(host, int(port), [1, 2, 3, 4])
            return r, gen, await fetch_metrics(host, int(port))
        r, gen, metrics = asyncio.run(go())
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=NET_LAUNCHER_WAIT_S)
    except BaseException:
        if proc.poll() is None:
            proc.kill()
        rest, _ = proc.communicate()
        print(f"[network launcher] its output:\n{''.join(lines)}{rest}",
              file=sys.stderr, flush=True)
        raise
    text = "".join(lines) + rest
    final = r["final"]
    if final.get("error") or not np.isfinite(final["score"]) or \
            final["steps"] < 1:
        fail(f"the --serve launcher's ASR stream gave {final}")
    if not gen.get("done") or not gen.get("tokens"):
        fail(f"the --serve launcher's LM request gave {gen}")
    if set(metrics) != {"asr", "lm"}:
        fail(f"the --serve launcher's /metrics gave {metrics}")
    if "drained; server stopped" not in text or proc.returncode != 0:
        fail(f"the --serve launcher did not drain cleanly (rc "
             f"{proc.returncode}):\n{text}")
    return {"up_s": up_s, "wall_s": time.perf_counter() - t0,
            "asr_steps": final["steps"], "lm_tokens": len(gen["tokens"]),
            "rc": proc.returncode}


def network_phase(dev, smi, full_results, inproc_s) -> dict:
    """Phase 16: the network front-end on the card (see the module
    docstring).  `inproc_s` is phase 5's warm in-process `engine.serve`
    of the same utterances."""
    t_phase = time.perf_counter()
    system = full_width_system(dev)
    utts = full_width_utterances(system[1])
    serving = net_serving(dev, system, utts, full_results,
                          KernelPolicy("kernel"))
    serving.update(inprocess_wall_s=inproc_s,
                   inprocess_x_realtime=serving["audio_s"] / inproc_s)
    counts, steps = serving["counts"], serving["steps"]
    n = len(steps)
    expect = {name: 0 for name in counts}
    expect.update({"logmel": n, "tds_conv": 18 * n, "layernorm": 15 * n,
                   "hypothesis_unit": sum(w for _, _, w in steps)})
    print(f"[network] {len(utts)} full-width streams over the wire: the "
          f"worker took {n} steps, (n_active, b, w) = {steps}", flush=True)
    print(f"[network] launch counts {counts}, expected {expect}", flush=True)
    if counts != expect or not n:
        fail(f"network: launch counts {counts} != expected {expect}")
    print(f"[network] {smi}: first-result latency p50 "
          f"{serving['first_result_ms']['p50']:.3f} ms, p99 "
          f"{serving['first_result_ms']['p99']:.3f} ms; finalize latency "
          f"p50 {serving['finalize_ms']['p50']:.3f} ms, p99 "
          f"{serving['finalize_ms']['p99']:.3f} ms", flush=True)
    print(f"[network] {smi}: throughput over the wire "
          f"{serving['wire_x_realtime']:.3f}x realtime "
          f"({serving['audio_s']:.2f} s of audio in "
          f"{serving['wire_wall_s']:.3f} s); phase 5's warm in-process "
          f"engine.serve "
          f"{serving['inprocess_x_realtime']:.3f}x realtime "
          f"({serving['inprocess_wall_s']:.3f} s)", flush=True)
    print(f"[network] burst of {NET_BURST} with retries: "
          f"{serving['burst_503']} 503s before the holders let go, every "
          f"burst stream rode them out; /metrics: queue high-water "
          f"{serving['metrics']['queue_max_depth']}, rejections "
          f"{serving['metrics']['rejected']}, restarts "
          f"{serving['metrics']['restarts']}; every stream equals phase 5's "
          f"in-process result", flush=True)
    del system
    torch.cuda.empty_cache()

    demo = asr_demo_system()
    demo_utts = [SyntheticASR(demo[1]).utterance(u)["audio"]
                 for u in range(4)]
    clean = demo_results(dev, demo, demo_utts, KernelPolicy("kernel"))
    faults = net_faults(dev, demo, demo_utts, clean, KernelPolicy("kernel"))
    print(f"[network faults] asr_step raise on sid {NET_POISON_SID}: that "
          f"stream faulted, the other 3 equal the clean run; pump stall: "
          f"/healthz {faults['watchdog']['wedged_healthz']} while wedged, "
          f"{faults['watchdog']['healthz']} after "
          f"{faults['watchdog']['restarts']} restart(s), "
          f"{faults['watchdog']['stall_to_healthy_s']:.3f} s from the stall; "
          f"drain under load returned {faults['drain']['results']} results",
          flush=True)
    launcher = net_launcher()
    print(f"[network launcher] --serve --port 0 up in {launcher['up_s']:.2f} "
          f"s; /asr {launcher['asr_steps']} steps, /lm "
          f"{launcher['lm_tokens']} tokens; SIGTERM drained it, rc "
          f"{launcher['rc']} ({launcher['wall_s']:.2f} s)", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[network] phase 16 took {phase_s:.2f} s (limit "
          f"{NET_PHASE_LIMIT_S:.0f} s)", flush=True)
    if phase_s > NET_PHASE_LIMIT_S:
        fail(f"network phase took {phase_s:.1f} s, more than "
             f"{NET_PHASE_LIMIT_S} s")
    serving.update(faults=faults, launcher=launcher, phase_s=phase_s,
                   card=smi)
    return serving


# ---------------------------------------------------------------------------
# phase 17: ASR training (CTC) at full width
# ---------------------------------------------------------------------------
def tree_to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree)


def grad_gaps(got, want) -> dict:
    """{leaf path: max |got - want| / max |want|} of two gradient trees
    (got on the card, want on the CPU)."""
    w = dict(leaves_with_paths(want))
    return {"/".join(map(str, path)): float(
        (g.cpu().float() - w[path].float()).abs().max()
        / max(float(w[path].abs().max()), 1e-30))
        for path, g in leaves_with_paths(got)}


def check_grads(tag, loss_dev, loss_cpu, g_dev, g_cpu, loss_rtol,
                grad_rtol, g_ref=None) -> dict:
    """The card's fp32 loss against the CPU's within `loss_rtol`, and each
    gradient leaf's max|err| / max|g| within `grad_rtol`: against the
    CPU's fp32 gradients `g_cpu`, or, where given, against the CPU's fp64
    ones `g_ref` (the CPU fp32's own distance from them is printed)."""
    gaps = grad_gaps(g_dev, g_cpu)
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(float(loss_dev) - float(loss_cpu)) / abs(float(loss_cpu))
    print(f"[{tag}] card vs CPU fp32: loss {float(loss_dev):.6f} vs "
          f"{float(loss_cpu):.6f} (relative {loss_gap:.3e}, limit "
          f"{loss_rtol}); gradients over {len(gaps)} leaves: worst max|err| "
          f"/ max|g| {gaps[worst]:.3e} at {worst}, median "
          f"{float(np.median(list(gaps.values()))):.3e}", flush=True)
    out = {"loss_card": float(loss_dev), "loss_cpu": float(loss_cpu),
           "loss_rel_err": loss_gap, "grad_rel_err_worst": gaps[worst],
           "grad_rel_err_worst_leaf": worst,
           "grad_rel_err_median": float(np.median(list(gaps.values())))}
    held = gaps
    if g_ref is not None:
        held, e_cpu = grad_gaps(g_dev, g_ref), grad_gaps(g_cpu, g_ref)
        w = max(held, key=held.get)
        print(f"[{tag}] against the CPU's fp64 gradients: card fp32 worst "
              f"{held[w]:.3e} at {w}, median "
              f"{float(np.median(list(held.values()))):.3e}; CPU fp32 worst "
              f"{max(e_cpu.values()):.3e}, median "
              f"{float(np.median(list(e_cpu.values()))):.3e}", flush=True)
        out.update(card_vs_fp64_worst=held[w], card_vs_fp64_worst_leaf=w,
                   card_vs_fp64_median=float(np.median(list(held.values()))),
                   cpu_vs_fp64_worst=max(e_cpu.values()),
                   cpu_vs_fp64_median=float(np.median(list(e_cpu.values()))))
    if loss_gap > loss_rtol or max(held.values()) > grad_rtol:
        fail(f"{tag}: the card's loss or gradients are off (limits: loss "
             f"rtol {loss_rtol}, gradients {grad_rtol}): {out}")
    if not all(torch.isfinite(g).all() for _, g in leaves_with_paths(g_dev)):
        fail(f"{tag}: non-finite gradients on the card")
    return out


def asr_train_batch(words, dev, first: int, n: int):
    """`n` SyntheticASR utterances (2 words each) from index `first`: the
    audio padded to the longest (silence -> blanks, no transcript cut),
    its MFCC on the card (plain path, frames trimmed to a multiple of the
    model's subsampling) and the -1-padded token labels.  Fails where a
    transcript cannot align to the frames (CTC would give ~1e30)."""
    data = SyntheticASR(words)
    utts = [data.utterance(first + i, n_words=2) for i in range(n)]
    n_samp = max(len(u["audio"]) for u in utts)
    audio = np.zeros((n, n_samp), np.float32)
    n_lab = max(len(u["tokens"]) for u in utts)
    labels = np.full((n, n_lab), -1, np.int64)
    for i, u in enumerate(utts):
        audio[i, :len(u["audio"])] = u["audio"]
        labels[i, :len(u["tokens"])] = u["tokens"]
    feats = features.mfcc(torch.from_numpy(audio).to(dev), FEATURE_CONFIG,
                          kernels=PLAIN)
    sub = TDS_CONFIG.total_subsample
    feats = feats[:, :(feats.shape[1] // sub) * sub].contiguous()
    frames = feats.shape[1] // sub
    for u in utts:
        t = u["tokens"]
        need = len(t) + int((t[1:] == t[:-1]).sum())
        if need > frames:
            fail(f"asr train: {len(t)} tokens need {need} of {frames} frames")
    return utts, audio, feats, torch.from_numpy(labels).to(dev)


def asr_loss(params, feats, labels):
    st = tds.init_batched_stream_state(TDS_CONFIG, feats.shape[0],
                                       feats.device)
    lps, _ = tds.forward_batched(params, TDS_CONFIG, feats, st,
                                 kernels=PLAIN)
    return ctc.ctc_loss_batch(lps, labels)


def trained_decode(dev, system, params, utts, use_int8) -> dict:
    """The held-out utterances through `AsrEngine` (4 slots) with the
    trained weights, kernel policy (counts set to 0 just before, read
    just after, held against the steps) then plain policy: words equal,
    scores close."""
    tds_cfg, words, lex, lm, _, dec_cfg = system
    tag = f"asr train decode {'int8' if use_int8 else 'fp32'}"
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg, use_int8=use_int8)
    res, counts, steps = {}, None, None
    for mode in ("kernel", "ref"):
        eng = AsrEngine(EngineConfig(prog, n_slots=4,
                                     kernels=KernelPolicy(mode)), params,
                        device=dev)
        ops.reset_launch_counts()
        res[mode] = eng.serve(utts)
        torch.cuda.synchronize()
        if mode == "kernel":
            counts, steps = ops.launch_counts(), list(eng.step_shapes)
    n = len(steps)
    expect = {name: 0 for name in counts}
    expect.update({"logmel": n, "tds_conv": 18 * n, "layernorm": 15 * n,
                   "hypothesis_unit": sum(w for _, _, w in steps),
                   "int8_matmul": 29 * n if use_int8 else 0})
    print(f"[{tag}] {len(utts)} held-out utterances, {n} steps; launch "
          f"counts {counts}, expected {expect}", flush=True)
    if counts != expect or not n:
        fail(f"{tag}: launch counts {counts} != expected {expect}")
    rtol = INT8_SCORE_RTOL if use_int8 else 1e-4
    for i, (a, b) in enumerate(zip(res["kernel"], res["ref"])):
        same = (np.array_equal(a["words"], b["words"])
                and np.array_equal(a["tokens"], b["tokens"]))
        print(f"[{tag}] utt {i}: words {a['words'].tolist()} (ref "
              f"{b['words'].tolist()}) score kernel {a['score']:.6f} ref "
              f"{b['score']:.6f}", flush=True)
        if not same or not np.isfinite(a["score"]) or not np.isclose(
                a["score"], b["score"], rtol=rtol, atol=1e-4):
            fail(f"{tag} utt {i}: kernel {a['words'].tolist()} "
                 f"{a['score']} vs plain {b['words'].tolist()} {b['score']}"
                 f" (rtol {rtol})")
    return {"counts": counts, "steps": steps,
            "words": [r["words"].tolist() for r in res["kernel"]]}


def guard_phase(dev) -> list:
    """Every CUDA wrapper, given a weight that requires grad with grad
    mode on, raises (pointing at KernelPolicy('ref')) and launches
    nothing."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)
    tables = features._tables(FEATURE_CONFIG, dev)
    x4, w3, b3 = r(2, 6, 80, 3), r(3, 3, 4), r(4)
    ln, y = r(320), r(4, 320)
    wq = torch.randint(-127, 128, (320, 64), dtype=torch.int8, device=dev)
    xq = torch.randint(-127, 128, (4, 320), dtype=torch.int8, device=dev)
    hashes = torch.randint(0, 2 ** 31 - 1, (2, 256), dtype=torch.int32,
                           device=dev)
    q = r(1, 4, 64, 64)
    cases = {
        "tds_conv": lambda w: ktc.tds_conv(x4, w(w3), b3),
        "tds_conv_ln": lambda w: ktc.tds_conv_ln(x4, w3, b3, w(ln), ln),
        "layernorm": lambda w: kln.layernorm(y, w(ln), ln),
        "bias_residual_layernorm": lambda w: kln.bias_residual_layernorm(
            y, ln, ln, add_bias=w(ln), res=y),
        "rmsnorm": lambda w: kln.rmsnorm(y, w(ln)),
        "logmel": lambda w: klm.logmel(r(8, 257).abs(), w(tables.fb),
                                       tables.dct),
        "mfcc": lambda w: klm.mfcc(w(r(2, 1520)), FEATURE_CONFIG, tables),
        "int8_matmul": lambda w: kim.int8_matmul(xq, wq, r(4).abs(),
                                                 w(r(64).abs())),
        "int8_matmul_fused": lambda w: kim.int8_matmul_fused(
            r(4, 320), wq, w(r(64).abs())),
        "hypothesis_unit": lambda w: khu.hypothesis_unit(
            hashes, w(r(2, 256)), r(2, 256), k=8, beam=10.0),
        "flash_attention": lambda w: kfa.flash_attention(q, w(q), q),
        "beam_prune": lambda w: kbp.beam_prune(w(r(1000)), 5.0),
    }
    refused = []
    for name, call in cases.items():
        before = ops.launch_counts()
        try:
            call(lambda t: t.clone().requires_grad_())
        except RuntimeError as e:
            if "KernelPolicy('ref') to train" not in str(e):
                fail(f"guard: {name} raised an unexpected error: {e}")
            refused.append(name)
        else:
            fail(f"guard: {name} launched on a weight that requires grad")
        if ops.launch_counts() != before:
            fail(f"guard: {name} launched before refusing")
        with torch.no_grad():                  # the same call, grad mode off
            call(lambda t: t.clone().requires_grad_())
    torch.cuda.synchronize()
    print(f"[guard] {len(refused)} CUDA wrappers refused a weight that "
          f"requires grad and launched nothing: {refused}; each launched "
          f"with grad mode off", flush=True)
    return refused


def asr_train_phase(dev) -> dict:
    t_phase = time.perf_counter()
    fp32_numerics()
    system = full_width_system(dev)
    words = system[1]
    utts, audio, feats, labels = asr_train_batch(words, dev, 0,
                                                 ASR_TRAIN_BATCH)
    held = [SyntheticASR(words).utterance(ASR_TRAIN_BATCH + i, n_words=2)
            for i in range(ASR_HELD_OUT)]
    params_cpu = tds.init_tds(torch.Generator().manual_seed(SEED),
                              TDS_CONFIG)
    params = tree_to(params_cpu, dev)
    n_params = sum(t.numel() for _, t in leaves_with_paths(params))
    audio_s = audio.size / FEATURE_CONFIG.sample_rate
    print(f"[asr train] TDS_CONFIG, {n_params} parameters (fp32, TF32 off); "
          f"a batch of {len(utts)} utterances, {audio_s:.2f} s of audio "
          f"(padded), feats {tuple(feats.shape)}, labels "
          f"{tuple(labels.shape)}", flush=True)

    # (a) the same weights and batch: card against CPU
    t0 = time.perf_counter()
    loss_d, g_d = value_and_grad(lambda p: asr_loss(p, feats, labels), params)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_c, g_c = value_and_grad(
        lambda p: asr_loss(p, feats.cpu(), labels.cpu()), params_cpu)
    t_cpu = time.perf_counter() - t0
    _, g_64 = value_and_grad(
        lambda p: asr_loss(p, feats.cpu().double(), labels.cpu()),
        tree_map(torch.Tensor.double, params_cpu))
    print(f"[asr train] loss and gradients: card {t_card * 1e3:.1f} ms "
          f"(first use), CPU {t_cpu * 1e3:.1f} ms", flush=True)
    parity = check_grads("asr train", loss_d, loss_c, g_d, g_c,
                         ASR_LOSS_RTOL, ASR_GRAD_RTOL, g_ref=g_64)
    del g_c, g_64, params_cpu

    # (b) AdamW steps on the card
    ocfg = adamw.AdamWConfig(lr=ASR_TRAIN_LR, weight_decay=0.0)
    opt = adamw.init(params, ocfg)

    def step(p, o):
        loss, g = value_and_grad(lambda q: asr_loss(q, feats, labels), p)
        p, o = adamw.update(g, o, p, ocfg)
        return p, o, loss

    losses, times = [], []
    for _ in range(ASR_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    step_ms = float(np.median(times[1:])) * 1e3
    print(f"[asr train] {ASR_TRAIN_STEPS} AdamW steps (lr {ASR_TRAIN_LR}): "
          f"ctc loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{step_ms:.3f} ms a step (median of {len(times) - 1}, "
          f"synchronized), {audio_s / step_ms * 1e3:.2f} s of audio a "
          f"second", flush=True)
    print(f"[asr train] losses {[round(v, 4) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"asr train: losses {losses} not finite or not falling")
    prof = device_breakdown(lambda: step(params, opt), "asr train",
                            "one training step (forward, CTC, backward, "
                            "AdamW)", step_ms)

    # (c) decode held-out utterances with the trained weights
    audio_held = [u["audio"] for u in held]
    fp32 = trained_decode(dev, system, params, audio_held, use_int8=False)
    int8 = trained_decode(dev, system, params, audio_held, use_int8=True)
    refs = [u["words"].tolist() for u in held]
    wer_fp32 = ctc.wer(refs, fp32["words"])
    print(f"[asr train] held-out WER after {ASR_TRAIN_STEPS} steps: fp32 "
          f"{wer_fp32:.3f}, int8 {ctc.wer(refs, int8['words']):.3f}",
          flush=True)

    # (d) the gradient guard
    refused = guard_phase(dev)
    phase_s = time.perf_counter() - t_phase
    print(f"[asr train] phase 17 took {phase_s:.2f} s", flush=True)
    return {"parameters": n_params, "batch": len(utts), "audio_s": audio_s,
            "parity": parity, "losses": losses, "step_ms": step_ms,
            "step_ms_all": [t * 1e3 for t in times],
            "audio_s_per_s": audio_s / step_ms * 1e3, "profile": prof,
            "decode_fp32": fp32, "decode_int8": int8, "wer_fp32": wer_fp32,
            "guard_refused": refused, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 18: LM training at full width
# ---------------------------------------------------------------------------
def lm_train_parity(dev) -> dict:
    """LM_ARCH cut to its first LM_TRAIN_PARITY_LAYERS layers (every width
    kept) in fp32: `loss_fn` and its gradients on the card against the
    CPU, on the same seeded weights and one SyntheticLM batch."""
    cfg = replace(get_config(LM_ARCH), n_layers=LM_TRAIN_PARITY_LAYERS,
                  dtype="float32")
    lm = LM(cfg, PLAIN)
    p_cpu = lm.init(torch.Generator().manual_seed(SEED))
    b = SyntheticLM(DataConfig(cfg.vocab_size, LM_TRAIN_PARITY_SEQ,
                               LM_TRAIN_BATCH)).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    t0 = time.perf_counter()
    (loss_c, _), g_c = value_and_grad(lambda p: lm.loss_fn(p, batch), p_cpu,
                                      has_aux=True)
    t_cpu = time.perf_counter() - t0
    p_dev = tree_to(p_cpu, dev)
    del p_cpu
    (loss_d, _), g_d = value_and_grad(
        lambda p: lm.loss_fn(p, tree_to(batch, dev)), p_dev, has_aux=True)
    torch.cuda.synchronize()
    print(f"[lm train] parity: {cfg.name} at {cfg.n_layers} of "
          f"{get_config(LM_ARCH).n_layers} layers, "
          f"fp32, (B, S) = ({LM_TRAIN_BATCH}, {LM_TRAIN_PARITY_SEQ}); CPU "
          f"{t_cpu:.2f} s", flush=True)
    return check_grads("lm train", loss_d, loss_c, g_d, g_c, LM_LOSS_RTOL,
                       LM_GRAD_RTOL)


def lm_train_timing(dev, cfg) -> dict:
    """Synchronized step times of `make_train_step` at (LM_TRAIN_BATCH,
    LM_TRAIN_SEQ) on the full-width model, tokens/s, the model FLOPs'
    share of the bf16 dense peak, and a profiler breakdown of one step."""
    lm = LM(cfg, PLAIN)
    ocfg = adamw.AdamWConfig()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED))
    state = {"params": params, "opt": adamw.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    del params
    step = make_train_step(lm, ocfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH)).batch(
        0).items()}
    times = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(LM_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = float(np.median(times[1:])) * 1e3
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    shapes = lm.param_shapes()
    n = sum(t.numel() for _, t in leaves_with_paths(shapes))
    n_matmul = n - shapes["embed"]["w"].numel()   # lookups do no product
    # model FLOPs of a step: 6 per matmul parameter and token (forward and
    # backward), plus causal attention's two products (2 * S^2 / 2 * Dh
    # FLOPs a head and row forward, 3x with the backward); the remat
    # recompute and the plain attention's masked half are not counted
    s_eff = min(LM_TRAIN_SEQ, cfg.attn_window or LM_TRAIN_SEQ)
    attn = (6 * cfg.n_layers * LM_TRAIN_BATCH * cfg.n_heads * cfg.head_dim
            * LM_TRAIN_SEQ * s_eff)
    flops = 6 * n_matmul * tokens + attn
    share = flops / (step_ms / 1e3) / PEAK_BF16
    print(f"[lm train] {cfg.name} full width ({n} parameters, bf16, fp32 "
          f"AdamW moments): {step_ms:.2f} ms a step (median of "
          f"{LM_TIMED_STEPS}, synchronized; first {times[0] * 1e3:.1f} ms), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s; model FLOPs {flops:.4e} a "
          f"step (6·N·tokens {6 * n_matmul * tokens:.4e} + attention "
          f"{attn:.4e}) = {share * 100:.2f}% of the bf16 dense peak "
          f"({PEAK_BF16 / 1e12:.0f} TFLOP/s); peak memory {peak_gb:.2f} GB",
          flush=True)
    prof = device_breakdown(lambda: step(state, batch), "lm train",
                            "one training step (remat forward, backward, "
                            "AdamW)", step_ms)
    del state
    return {"step_ms": step_ms, "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tokens / step_ms * 1e3, "model_flops": flops,
            "attention_flops": attn, "matmul_parameters": n_matmul,
            "bf16_peak_share": share, "peak_memory_gb": peak_gb,
            "profile": prof}


def lm_train_phase(dev) -> dict:
    """`python -m repro_torch.launch.train --arch LM_ARCH` at full width
    through its `main(argv)`: 4 steps; 2 steps with a checkpoint at step
    2; a 2-step `--resume` from it, whose losses must equal the 4-step
    run's last two (it starts from step 2's state: parameters, moments,
    count).  Then the step timing and the numerics at 2 layers."""
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    ckpt = OUT / "lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    common = ["--arch", LM_ARCH, "--batch", str(LM_TRAIN_BATCH), "--seq",
              str(LM_TRAIN_SEQ), "--log-every", "1", "--device", str(dev)]
    runs = {}
    for name, args in (
            ("4 steps", ["--steps", "4"]),
            ("2 steps, checkpoint at 2", ["--steps", "2", "--ckpt",
                                          str(ckpt), "--ckpt-every", "2"]),
            ("2-step resume", ["--steps", "2", "--ckpt", str(ckpt),
                               "--resume"])):
        t0 = time.perf_counter()
        runs[name] = train.main(common + args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"[lm train] launcher, {name}: losses {runs[name]} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    full, first, resumed = runs.values()
    if not all(np.isfinite(v).all() for v in runs.values()):
        fail(f"lm train: non-finite losses {runs}")
    gaps = (max(abs(a - b) for a, b in zip(first, full[:2])),
            max(abs(a - b) for a, b in zip(resumed, full[2:])))
    print(f"[lm train] the checkpointing run against the 4-step run's first "
          f"two losses: max|diff| {gaps[0]:.3e}; the resumed run against its "
          f"last two: {gaps[1]:.3e} (limit {LM_RESUME_ATOL})", flush=True)
    if max(gaps) > LM_RESUME_ATOL:
        fail(f"lm train: the resumed run does not continue from step 2: "
             f"{runs}")
    shutil.rmtree(ckpt, ignore_errors=True)
    timing = lm_train_timing(dev, cfg)
    torch.cuda.empty_cache()
    parity = lm_train_parity(dev)
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[lm train] phase 18 took {phase_s:.2f} s", flush=True)
    return {"arch": LM_ARCH, "runs": runs, "resume_gaps": gaps,
            **timing, "parity": parity, "phase_s": phase_s}



# ---------------------------------------------------------------------------
# phases 19-21: M-RoPE, frontend embeddings, bf16 LayerNorm, int8 weights
# ---------------------------------------------------------------------------
def check_lm3_kernels(dev) -> dict:
    """Phase 19: flash_attention at qwen2-vl-7b's and musicgen-medium's
    prefill shapes and rmsnorm at D = 3584, bf16 and fp32 (LM_TOL);
    LayerNorm on bf16 rows at D = 1536, aligned and not (LM_TOL), and on
    the TDS model's fp32 rows with its bias + residual prologue
    (TOL["layernorm"], as phase 2); each against its plain version."""
    gen = torch.Generator().manual_seed(SEED + 12)
    err = {}

    def hold(name, label, got, want, tol):
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs().max().item()
        err[name] = max(err.get(name, 0.0), d)
        try:
            torch.testing.assert_close(got, want, **tol)
        except AssertionError as e:
            fail(f"{name} {label}: kernel disagrees with its plain "
                 f"version: {e}")
        print(f"[lm3 kernels] {name} {label}: max|err| {d:.3e} ok",
              flush=True)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "fp32"
        for b, h, kv, sq, skv, d, causal, win in LM3_FLASH_CASES:
            q, k, v = attn_inputs(dev, gen, b, h, kv, sq, skv, d, dtype)
            before = dict(kfa.launches_by_design)
            got = kfa.flash_attention(q, k, v, causal=causal, window=win)
            ran = [n for n in kfa.DESIGNS
                   if kfa.launches_by_design[n] != before[n]]
            # D = 64 and 128 in bf16 run the TMA design (as D = 80 in
            # phase 7), and only it
            if ran != [kfa.design(d, dtype)] or (
                    dtype == torch.bfloat16 and ran != ["bf16 tma"]):
                fail(f"flash_attention {tag} D={d}: launched {ran}")
            hold("flash_attention", f"{tag} B={b} H={h}/{kv} S={sq} D={d} "
                 f"({ran[0]})", got,
                 ref.flash_attention(q, k, v, causal=causal, window=win),
                 LM_TOL[dtype])
            del q, k, v
            torch.cuda.empty_cache()
        for rows, d in LM3_RMS_CASES:
            x, sc = rand(rows, d).to(dtype), 1 + rand(d, scale=0.1)
            hold("rmsnorm", f"{tag} R={rows} D={d}", kln.rmsnorm(x, sc),
                 ref.rmsnorm(x, sc), LM_TOL[dtype])
    for rows, d, misaligned in LM3_LN_CASES:
        x = rand(rows, d, scale=3.0).to(torch.bfloat16)
        if misaligned:             # row 0 2 bytes past a 16-byte boundary
            buf = torch.empty(rows * d + 1, dtype=torch.bfloat16, device=dev)
            buf[1:].view(rows, d).copy_(x)
            x = buf[1:].view(rows, d)
        sc, bi = 1 + rand(d, scale=0.1), rand(d, scale=0.1)
        hold("layernorm bf16", f"R={rows} D={d}"
             + (" misaligned" if misaligned else "")
             + (" (scalar kernel)" if misaligned or d % 8 else ""),
             kln.layernorm(x, sc, bi, eps=1e-6),
             ref.layernorm(x, sc, bi, eps=1e-6), LM_TOL[torch.bfloat16])
    for rows, d in LM3_TDS_LN_CASES:
        y, res, ab = rand(rows, d), rand(rows, d), rand(d)
        sc, bi = 1 + rand(d, scale=0.2), rand(d)
        hold("layernorm", f"fp32 R={rows} D={d} (TDS: + bias + residual)",
             kln.bias_residual_layernorm(y, sc, bi, add_bias=ab, res=res),
             ref.bias_residual_layernorm(y, sc, bi, add_bias=ab, res=res),
             TOL["layernorm"])
    return err


def lm3_kernel_rows(timing) -> dict:
    """The kernels JSON numbers of phases 20-21's work, from phase 19's
    times: qwen2-vl-7b's flash (28 launches at (2, 28/4, 2048, 128)) and
    rmsnorm (56 over (4096, 3584) and 1 over 2 rows a prefill, 57 over 2
    rows a decode step); musicgen-medium's flash (48 at (2, 24/24, 2048,
    64)) and LayerNorm (96 over (4096, 1536) and 1 over 2 rows, 97 over 2
    rows a decode step)."""
    fa, rn, ln = (timing[k] for k in ("flash_attention", "rmsnorm",
                                      "layernorm"))
    S = EMB_BUCKET
    return {
        "flash_attention": {
            VLM_ARCH: total(fa, [(28, flash_key(28, 4, S, 128, 2))],
                            f"the 28 launches of one 2-row {S}-token prefill"),
            AUDIO_ARCH: total(fa, [(48, flash_key(24, 24, S, 64, 2))],
                              f"the 48 launches of one 2-row {S}-token "
                              f"prefill")},
        "rmsnorm": {VLM_ARCH: dict(
            total(rn, [(56, f"{2 * S}x3584"), (1, "2x3584")],
                  f"the 57 launches of one 2-row {S}-token prefill"),
            decode_step=total(rn, [(57, "2x3584")],
                              "the 57 launches of one 2-row decode step"))},
        "layernorm": {AUDIO_ARCH: dict(
            total(ln, [(96, f"{2 * S}x1536"), (1, "2x1536")],
                  f"the 97 launches of one 2-row {S}-token prefill, bf16"),
            decode_step=total(ln, [(97, "2x1536")],
                              "the 97 launches of one 2-row decode step, "
                              "bf16"))}}


def stub_embeddings(dev, cfg, rows, S, dtype, seed=SEED + 13):
    """The stub frontend's stand-in: standard normal (rows, S, d_model)
    embeddings drawn on the card from a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, S, cfg.d_model), generator=gen,
                       device=dev).to(dtype)


def embed_decode(lm, params, emb, dev):
    """Prefill emb's rows at EMB_LENGTHS in the EMB_BUCKET bucket into a
    ring of EMB_RING, then EMB_STEPS decode steps fed each row's next
    embeddings (teacher forcing).  Returns the prefill's logits (B, V)
    f32, each step's, and the synchronized wall times (ms)."""
    V = lm.cfg.vocab_size
    lens = torch.tensor(EMB_LENGTHS, device=dev)
    rows = torch.arange(len(EMB_LENGTHS), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, {"embeds": emb[:, :EMB_BUCKET]},
                               lengths=lens, cache_len=EMB_RING)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    steps, ms = [], []
    for t in range(EMB_STEPS):
        nxt = emb[rows, lens + t][:, None]
        t0 = time.perf_counter()
        lg, _, cache = lm.decode_step(params, cache, {"embeds": nxt})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(lg[:, :V].float())
    return logits[:, :V].float(), steps, pre_ms, ms


def rel_gap(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def decode_vs_prefill(lm, params, emb, steps, dev) -> list:
    """max|decode - prefill| / max|prefill| of each decode step's logits
    (`embed_decode`'s) against a prefill of the same prefix: the bucketed
    path at lengths EMB_LENGTHS + t + 1."""
    lens = torch.tensor(EMB_LENGTHS, device=dev)
    gaps = []
    for t, lg in enumerate(steps, 1):
        want, _ = lm.prefill(params, {"embeds": emb}, lengths=lens + t)
        want = want[:, :lm.cfg.vocab_size].float()
        if not (torch.isfinite(lg).all() and torch.isfinite(want).all()):
            fail(f"{lm.cfg.name}: non-finite logits at decode step {t}")
        gaps.append(rel_gap(lg, want))
    return gaps


def embed_serve(dev, cfg, params, tag) -> dict:
    """Phase 20(a) / 21(a), a main LM path: bf16 full width, 2 rows of
    embeddings prefilled and decoded (`embed_decode`); launch counts;
    each decode step's logits against a prefill of the same prefix, the
    kernel path's worst gap within EMB_DEPTH_RATIO times the plain
    path's own; prefill and decode times, profiler breakdowns."""
    lm = LM(cfg, KernelPolicy("auto"))
    emb = stub_embeddings(dev, cfg, 2, EMB_BUCKET + EMB_STEPS, lm.dtype)
    embed_decode(lm, params, emb, dev)                        # warm-up
    # ---- the main path: counts set to 0 just before, read just after --
    ops.reset_launch_counts()
    pre, steps, pre_ms, step_ms = embed_decode(lm, params, emb, dev)
    counts = ops.launch_counts()
    norm, per_fwd, attn = EMB_LAUNCHES[cfg.name]
    expect = {name: 0 for name in counts}
    expect["flash_attention"] = attn
    expect[norm] = per_fwd * (1 + EMB_STEPS)
    med = float(np.median(step_ms))
    print(f"[{tag}] {cfg.name} bf16: prefill of 2 rows at lengths "
          f"{list(EMB_LENGTHS)} in the {EMB_BUCKET} bucket (ring "
          f"{EMB_RING}) {pre_ms:.2f} ms; {EMB_STEPS} decode steps, median "
          f"{med:.3f} ms (min {min(step_ms):.3f}, max {max(step_ms):.3f})",
          flush=True)
    print(f"[{tag}] launch counts {counts}, expected {expect} ({per_fwd} "
          f"{norm} launches a forward, {attn} flash launches a prefill)",
          flush=True)
    if counts != expect:
        fail(f"{cfg.name} launch counts {counts} != expected {expect}")
    if not torch.isfinite(pre).all():
        fail(f"{cfg.name}: non-finite prefill logits")
    gaps = decode_vs_prefill(lm, params, emb, steps, dev)
    plain = LM(cfg, KernelPolicy("ref"))
    plain_gaps = decode_vs_prefill(plain, params, emb,
                                   embed_decode(plain, params, emb, dev)[1],
                                   dev)
    limit = EMB_DEPTH_RATIO * max(plain_gaps)
    met = max(gaps) <= EMB_DECODE_RTOL[torch.bfloat16]
    print(f"[{tag}] decode step logits against a prefill of the same "
          f"prefix, bf16, {cfg.n_layers} layers: max|diff| / max|prefill| "
          f"over the {EMB_STEPS} steps, kernel path median "
          f"{np.median(gaps):.3e}, worst {max(gaps):.3e}; plain path median "
          f"{np.median(plain_gaps):.3e}, worst {max(plain_gaps):.3e}; limit "
          f"{EMB_DEPTH_RATIO} x the plain path's worst = {limit:.3e} "
          f"(tests/test_models.py's {EMB_DECODE_RTOL[torch.bfloat16]} "
          f"{'met' if met else 'not met'} at this depth; held at "
          f"{EMB_PARITY_LAYERS} layers)", flush=True)
    if max(gaps) > limit:
        fail(f"{cfg.name}: the kernel path's decode logits {max(gaps)} "
             f"from its prefill's, more than {EMB_DEPTH_RATIO} x the plain "
             f"path's {max(plain_gaps)}")
    lens = torch.tensor(EMB_LENGTHS, device=dev)
    fn_pre = (lambda: lm.prefill(params, {"embeds": emb[:, :EMB_BUCKET]},
                                 lengths=lens, cache_len=EMB_RING))
    _, cache = fn_pre()
    step = {"embeds": emb[:, EMB_BUCKET - 1:EMB_BUCKET]}
    lm.decode_step(params, cache, step)
    prof = {"prefill": device_breakdown(fn_pre, tag, "2-row prefill",
                                        pre_ms),
            "decode_step": device_breakdown(
                lambda: lm.decode_step(params, cache, step), tag,
                "2-row decode step", med)}
    return {"counts": counts, "prefill_ms": pre_ms, "decode_step_ms": med,
            "decode_steps_ms": step_ms, "decode_vs_prefill": gaps,
            "plain_decode_vs_prefill": plain_gaps, "profile": prof}


def embed_parity(dev, cfg, params, tag):
    """Phase 20(b) / 21(a): the model cut to EMB_PARITY_LAYERS layers, in
    bf16 and fp32.  Each decode step against a prefill of the same
    prefix on the kernel path (EMB_DECODE_RTOL); the kernel against the
    plain policy on the same embeddings: prefill logits within
    LM_LOGIT_RTOL, and in fp32 the greedy token of the prefill and of
    every decode step equal.  Returns (results, the fp32 cut's config
    and parameters)."""
    cut_cfg, cut = first_layers(cfg, params, EMB_PARITY_LAYERS)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        c = replace(cut_cfg, dtype="bfloat16" if dt == "bf16" else "float32")
        p = tree_map(lambda a: a.to(dtype) if a.dtype == torch.bfloat16
                     else a, cut)
        emb = stub_embeddings(dev, cfg, 2, EMB_BUCKET + EMB_STEPS, dtype)
        lms = {mode: LM(c, KernelPolicy(mode)) for mode in ("kernel", "ref")}
        res = {mode: embed_decode(lm, p, emb, dev) for mode, lm in lms.items()}
        (kp, ks, _, _), (rp, rs, _, _) = res["kernel"], res["ref"]
        dvp = decode_vs_prefill(lms["kernel"], p, emb, ks, dev)
        gap = rel_gap(kp, rp)
        toks = {m: [lg.argmax(-1).tolist() for lg in [r[0]] + r[1]]
                for m, r in res.items()}
        n_eq = sum(a == b for a, b in zip(toks["kernel"], toks["ref"]))
        print(f"[{tag}] {cfg.name} at {EMB_PARITY_LAYERS} layers, {dt}: "
              f"kernel path decode vs prefill worst {max(dvp):.3e} (limit "
              f"{EMB_DECODE_RTOL[dtype]:.0e}); kernel vs plain policy "
              f"prefill logits {gap:.3e} (limit {LM_LOGIT_RTOL[dtype]:.0e}), "
              f"greedy tokens equal at {n_eq}/{len(toks['ref'])} of the "
              f"prefill and {EMB_STEPS} decode steps"
              + ("" if dt == "fp32" else " (not held in bf16)"), flush=True)
        if max(dvp) > EMB_DECODE_RTOL[dtype] or gap > LM_LOGIT_RTOL[dtype] \
                or (dt == "fp32" and n_eq != len(toks["ref"])):
            fail(f"{cfg.name} {dt} at {EMB_PARITY_LAYERS} layers: decode vs "
                 f"prefill {max(dvp)}, kernel vs plain logits {gap}, tokens "
                 f"{toks}")
        out[dt] = {"decode_vs_prefill": dvp, "prefill_gap": gap,
                   "tokens_equal": n_eq}
        del lms, res
    out["layers"] = EMB_PARITY_LAYERS
    return out, c, p


def given_positions(dev, cfg32, p32, tag) -> dict:
    """Phase 20(c): batch-given (1, S, 3) M-RoPE positions shaped like an
    image, one temporal index over an EMB_GRID x EMB_GRID grid of h/w
    indices, on the fp32 cut: the card's prefill logits (the plain
    position-masked attention, no flash launch) against the CPU's."""
    S = EMB_GRID * EMB_GRID
    i = torch.arange(S, dtype=torch.int32)
    pos = torch.stack([torch.zeros_like(i), i // EMB_GRID, i % EMB_GRID],
                      dim=-1)[None]
    emb = stub_embeddings(dev, cfg32, 1, S, torch.float32, seed=SEED + 14)
    lm = LM(cfg32, KernelPolicy("kernel"))
    ops.reset_launch_counts()
    got, _ = lm.prefill(p32, {"embeds": emb, "positions": pos.to(dev)})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    text, _ = lm.prefill(p32, {"embeds": emb})
    t0 = time.perf_counter()
    want, _ = LM(cfg32).prefill(tree_map(lambda a: a.cpu(), p32),
                                {"embeds": emb.cpu(), "positions": pos})
    cpu_s = time.perf_counter() - t0
    V = cfg32.vocab_size
    got, want, text = (a[:, :V].float().cpu() for a in (got, want, text))
    gap = rel_gap(got, want)
    n_norm = 2 * cfg32.n_layers + 1
    print(f"[{tag}] batch-given positions, (1, {S}, 3): temporal 0 over a "
          f"{EMB_GRID} x {EMB_GRID} h/w grid, {cfg32.n_layers} layers fp32: "
          f"prefill attention ran the plain position-masked attention "
          f"(flash launches {counts['flash_attention']}, rmsnorm "
          f"{counts['rmsnorm']}); card vs CPU logits max|diff| / max|CPU| "
          f"{gap:.3e} (limit {LM_LOGIT_RTOL[torch.float32]:.0e}; CPU "
          f"{cpu_s:.2f} s); against the text positions' logits "
          f"{rel_gap(text, want):.3e}", flush=True)
    if counts["flash_attention"] or counts["rmsnorm"] != n_norm:
        fail(f"batch-given positions: launch counts {counts}")
    if not torch.isfinite(got).all() or gap > LM_LOGIT_RTOL[torch.float32]:
        fail(f"batch-given positions: card vs CPU logits gap {gap}")
    return {"S": S, "card_vs_cpu_gap": gap, "counts": counts,
            "cpu_s": cpu_s}


def embed_model_phase(dev, arch, tag) -> dict:
    """Phase 20 (qwen2-vl-7b) or 21(a) (musicgen-medium) at full width:
    seeded bf16 weights drawn on the card, `embed_serve`, `embed_parity`
    and, for M-RoPE, `given_positions`; the model is freed at the end."""
    t_phase = time.perf_counter()
    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, rope "
          f"{cfg.rope}, norm {cfg.norm}, act {cfg.act}, QKV bias "
          f"{cfg.qkv_bias}, embed_inputs {cfg.embed_inputs}; {n} parameters "
          f"({cfg.dtype}, {n * 2 / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = embed_serve(dev, cfg, params, tag)
    out["parameters"] = n
    out["parity"], cfg32, p32 = embed_parity(dev, cfg, params,
                                             f"{tag} parity")
    del params
    torch.cuda.empty_cache()
    if cfg.rope == "mrope":
        out["given_positions"] = given_positions(dev, cfg32, p32,
                                                 f"{tag} positions")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase took {out['phase_s']:.2f} s", flush=True)
    return out


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def int8_vlm(dev, bf16_ms) -> dict:
    """Phase 21(b), qwen2-vl-7b on int8 weights: the bf16 tree quantized
    on the card, three leaves' `wq`/`wscale` bitwise against the CPU's
    quantization of the same leaves, both trees' resident bytes, then
    `embed_decode` on the int8 tree (launches counted) and its logits'
    gap to the bf16 weights' (printed, not held: random deep weights
    amplify it)."""
    cfg = get_config(VLM_ARCH)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    lm = LM(cfg, KernelPolicy("auto"))
    emb = stub_embeddings(dev, cfg, 2, EMB_BUCKET + EMB_STEPS, lm.dtype)
    bf_pre, bf_steps, _, _ = embed_decode(lm, params, emb, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = layers.quantize_params_for_serving(params)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    lay = params["layers"]["p0"]
    for what, leaf, got in (
            ("layer 0's wqkv", {"w": lay["mixer"]["wqkv"]["w"][:1]},
             {k: v[:1] for k, v in pq["layers"]["p0"]["mixer"]["wqkv"].items()
              if k != "b"}),
            ("the last 2 layers' stacked w_down",
             {"w": lay["mlp"]["w_down"]["w"][-2:]},
             {k: v[-2:] for k, v in
              pq["layers"]["p0"]["mlp"]["w_down"].items()}),
            ("lm_head", params["lm_head"], pq["lm_head"])):
        cpu = layers.quantize_params_for_serving(
            {"x": {"w": leaf["w"].cpu()}})["x"]
        same = all(torch.equal(got[k].cpu(), cpu[k]) for k in ("wq",
                                                               "wscale"))
        print(f"[int8] {what}: wq {tuple(got['wq'].shape)} "
              f"{got['wq'].dtype}, wscale {tuple(got['wscale'].shape)}: "
              f"card {'bitwise equal to' if same else 'DIFFERS from'} the "
              f"CPU's quantization", flush=True)
        if not same:
            fail(f"int8: {what} quantized on the card differs from the CPU")
    nb, nq = tree_bytes(params), tree_bytes(pq)
    print(f"[int8] {cfg.name}: bf16 tree {nb / 1e9:.3f} GB, int8 tree "
          f"{nq / 1e9:.3f} GB resident ({nq / nb:.3f}); quantized on the "
          f"card in {q_s:.2f} s", flush=True)
    del params, lay
    torch.cuda.empty_cache()
    embed_decode(lm, pq, emb, dev)                           # warm-up
    ops.reset_launch_counts()
    pre, steps, pre_ms, step_ms = embed_decode(lm, pq, emb, dev)
    counts = ops.launch_counts()
    norm, per_fwd, attn = EMB_LAUNCHES[cfg.name]
    if (counts[norm] != per_fwd * (1 + EMB_STEPS)
            or counts["flash_attention"] != attn):
        fail(f"int8 {cfg.name}: launch counts {counts}")
    gaps = [rel_gap(a, b) for a, b in zip([pre] + steps, [bf_pre] + bf_steps)]
    med = float(np.median(step_ms))
    print(f"[int8] {cfg.name} on int8 weights: prefill {pre_ms:.2f} ms "
          f"(bf16 weights {bf16_ms[0]:.2f}), decode step median {med:.3f} "
          f"ms (bf16 {bf16_ms[1]:.3f}); launches {counts}; logits against "
          f"the bf16 weights' max|diff| / max|bf16|: prefill {gaps[0]:.3e}, "
          f"decode steps median {np.median(gaps[1:]):.3e}, worst "
          f"{max(gaps[1:]):.3e} (printed, not held: {cfg.n_layers} random "
          f"layers amplify it)", flush=True)
    if not all(torch.isfinite(lg).all() for lg in [pre] + steps):
        fail(f"int8 {cfg.name}: non-finite logits")
    del pq
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16_bytes": nb, "int8_bytes": nq, "quantize_s": q_s,
            "counts": counts, "prefill_ms": pre_ms, "decode_step_ms": med,
            "logit_gaps": gaps}


def int8_engine(dev, serve) -> dict:
    """Phase 21(b), h2o-danube-1.8b on int8 weights through `LmEngine`:
    phase 8's weights quantized, phase 8's 8 prompts at 4 slots
    (`lm_serve_phase`, launches checked), beside phase 8's numbers; then
    in fp32 the kernel and the plain policy serve LM_PARITY_PROMPTS on
    the same int8 weights: equal tokens."""
    cfg = get_config(LM_ARCH)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    pq = layers.quantize_params_for_serving(params)
    del params
    sv = lm_serve_phase(dev, cfg, pq, tag="int8 serve")
    sv.pop("engine")
    print(f"[int8 serve] {cfg.name} on int8 weights: {sv['tokens_per_s']:.1f}"
          f" tokens/s, decode step median {sv['decode_step_ms']:.3f} ms; "
          f"bf16 weights (phase 8): {serve['tokens_per_s']:.1f} tokens/s, "
          f"{serve['decode_step_ms']:.3f} ms", flush=True)
    cfg32 = replace(cfg, dtype="float32")
    pq32 = tree_map(lambda a: a.float() if a.dtype == torch.bfloat16 else a,
                    pq)
    del pq
    prompts = lm_prompts(LM_PARITY_PROMPTS[:4], cfg.vocab_size, seed=SEED + 1)
    toks = {}
    for mode in ("kernel", "ref"):
        eng = lm_engine(dev, cfg32, pq32, KernelPolicy(mode))
        toks[mode] = eng.serve(prompts)
        del eng
        torch.cuda.empty_cache()
    n_eq = sum(a == b for a, b in zip(toks["kernel"], toks["ref"]))
    print(f"[int8 serve] {cfg.name} fp32 on int8 weights, {len(prompts)} "
          f"prompts of {list(LM_PARITY_PROMPTS[:4])} tokens: kernel and plain "
          f"policy tokens equal for {n_eq}/{len(prompts)}", flush=True)
    if n_eq != len(prompts):
        fail(f"int8 fp32: kernel and plain tokens differ: {toks}")
    del pq32
    gc.collect()
    torch.cuda.empty_cache()
    return {k: v for k, v in sv.items() if k != "decode_steps"} | {
        "fp32_tokens_equal": n_eq}


# ---------------------------------------------------------------------------
# phase 22: the sharded ASR serving step, rank groups on the one card
# ---------------------------------------------------------------------------
def mesh_of(spec: str, world: int):
    """`--mesh`-style spec -> (mesh over the world's first ranks, or None
    on the others; its rank count).  Every rank of the world calls it."""
    if "x" in spec:
        shape, names = tuple(int(v) for v in spec.split("x")), ("data",
                                                                "model")
    else:
        shape, names = (int(spec),), ("model",)
    n = int(np.prod(shape))
    if n > world:
        fail(f"mesh {spec} needs {n} of the phase's {world} ranks")
    return meshlib.make_mesh(shape, names, ranks=range(n)), n


def shared_card_label(n: int, smi: str) -> str:
    name, limit = (s.strip() for s in smi.split(",", 1))
    return (f"{n} ranks sharing one {name} ({limit}), gloo host-staged "
            f"collectives: not a multi-card figure")


@contextlib.contextmanager
def counting_collectives():
    """Count the collectives of the mesh's axes that move data (axes of
    more than one rank): all-reduces, their bytes, object broadcasts."""
    stats = {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0}
    ar, bc = meshlib.MeshAxis.all_reduce, meshlib.MeshAxis.broadcast_object

    def all_reduce(self, t, async_op=False):
        if self.size > 1:
            stats["all_reduce"] += 1
            stats["all_reduce_bytes"] += t.numel() * t.element_size()
        return ar(self, t, async_op)

    def broadcast_object(self, obj, src_index):
        stats["broadcast"] += self.size > 1
        return bc(self, obj, src_index)
    meshlib.MeshAxis.all_reduce = all_reduce
    meshlib.MeshAxis.broadcast_object = broadcast_object
    try:
        yield stats
    finally:
        meshlib.MeshAxis.all_reduce = ar
        meshlib.MeshAxis.broadcast_object = bc


@contextlib.contextmanager
def plain_sharded_int8_products():
    """The sharded int8 product's plain version (`ref.int8_matmul` on the
    full rows' local columns) in place of the pre-quantized kernel, which
    `ops.int8_matmul_prepared(axis=)` looks up on its module at every
    call."""
    kernel = kim.int8_matmul
    kim.int8_matmul = lambda xq, wq, xs, ws: ref.int8_matmul(xq, wq, xs, ws)
    try:
        yield
    finally:
        kim.int8_matmul = kernel


def mesh_step_ms(eng, slots, w) -> float:
    """Median wall time of 5 uncommitted steps (after one warm-up) over
    `slots` at `w` windows, ending in a synchronize; every rank of the
    mesh runs it in lockstep."""
    ts = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._step_slots(slots, w, commit=False)
        torch.cuda.synchronize()
        if i:
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def mesh_engine(dev, system, mesh, overlap, use_int8):
    tds_cfg, _, lex, lm, params, dec_cfg = system
    prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg, use_int8=use_int8)
    return AsrEngine(EngineConfig(prog, n_slots=4, mesh=mesh,
                                  overlap_psum=overlap), params, device=dev)


def mesh_case(dev, system, utts, mesh, overlap, want, say) -> dict:
    """One mesh of phase 22 on this rank (every rank of the mesh runs it
    alike): the fp32 and the int8 engine serve phase 5's utterances with
    the counts set to 0 just before and read just after; the first
    step's log-probs against the unsharded forward; the int8 kernel path
    against its plain products, bitwise; step times."""
    out = {}
    model = mesh.shape["model"]
    chunks = 2 if overlap and model > 1 else 1
    n_fc = tds.kernel_census(system[0])["fc"]        # 29 FC/head products
    batch = torch.from_numpy(window_batch(mesh_engine(
        dev, system, None, False, False), utts, 4, 4)).to(dev)
    st = tds.init_batched_stream_state(system[0], 4, dev)
    for int8 in (False, True):
        tag = "int8" if int8 else "fp32"
        eng = mesh_engine(dev, system, mesh, overlap, int8)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with counting_collectives() as coll:
            t0 = time.perf_counter()
            results = eng.serve(utts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        steps = list(eng.step_shapes)
        n = len(steps)
        expect = {name: 0 for name in counts}
        expect.update({"logmel": n, "tds_conv": 18 * n, "layernorm": 15 * n,
                       "hypothesis_unit": sum(w for _, _, w in steps),
                       "int8_matmul": n_fc * chunks * n if int8 else 0})
        if counts != expect or not n:
            fail(f"mesh {dict(mesh.shape)} {tag} rank {mesh.rank}: launch "
                 f"counts {counts} != expected {expect}")
        expect_ar = n_fc * chunks * n if model > 1 else 0
        if coll["all_reduce"] != expect_ar:
            fail(f"mesh {dict(mesh.shape)} {tag}: {coll['all_reduce']} "
                 f"all-reduces over {n} steps, expected {expect_ar}")
        t0 = time.perf_counter()
        eng.serve(utts)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        for i, r in enumerate(results):
            if not np.isfinite(r["score"]):
                fail(f"mesh {dict(mesh.shape)} {tag} utt {i}: non-finite "
                     f"score {r['score']}")
        # the first step's log-probs against the unsharded forward
        lp, _ = eng.acoustic(batch, st)
        lp0, _ = mesh_engine(dev, system, None, False, int8).acoustic(batch,
                                                                      st)
        torch.cuda.synchronize()
        if lp.shape != lp0.shape or not torch.isfinite(lp).all():
            fail(f"mesh {dict(mesh.shape)} {tag}: log-probs "
                 f"{tuple(lp.shape)} or non-finite")
        lp_err = (lp - lp0).abs().max().item()
        tol = INT8_LOGP_ATOL if int8 else MESH_LOGP_ATOL
        if lp_err > tol:
            fail(f"mesh {dict(mesh.shape)} {tag}: first step's log-probs "
                 f"{lp_err:.3e} from the unsharded forward's (limit {tol})")
        case = {"results": results, "counts": counts, "steps": steps,
                "serve_s": wall, "warm_serve_s": warm,
                "all_reduce_per_step": coll["all_reduce"] / n,
                "all_reduce_bytes_per_step": coll["all_reduce_bytes"] / n,
                "broadcasts": coll["broadcast"], "logp_err": lp_err}
        if int8:
            # the plain products on the same mesh: the same bits
            with plain_sharded_int8_products():
                sub, _ = eng.acoustic(batch, st)
                plain = mesh_engine(dev, system, mesh, overlap, True).serve(
                    utts)
            torch.cuda.synchronize()
            if not torch.equal(sub, lp):
                fail(f"mesh {dict(mesh.shape)} int8: the first step's "
                     f"log-probs change with the plain sharded products")
            for i, (a, b) in enumerate(zip(results, plain)):
                if not (np.array_equal(a["words"], b["words"])
                        and np.array_equal(a["tokens"], b["tokens"])
                        and a["score"] == b["score"]):
                    fail(f"mesh {dict(mesh.shape)} int8 utt {i}: kernel "
                         f"path {a} vs plain products {b}")
        else:
            diffs = []
            for i, (a, b) in enumerate(zip(results, want)):
                if not (np.array_equal(a["words"], b["words"])
                        and np.array_equal(a["tokens"], b["tokens"])):
                    fail(f"mesh {dict(mesh.shape)} fp32 utt {i}: words "
                         f"{a['words'].tolist()} vs phase 5's "
                         f"{b['words'].tolist()}")
                diffs.append(abs(a["score"] - b["score"]))
            if max(diffs) >= MESH_SCORE_ATOL:
                fail(f"mesh {dict(mesh.shape)} fp32: scores {max(diffs):.3e}"
                     f" from phase 5's (limit {MESH_SCORE_ATOL})")
            case["score_diff"] = max(diffs)
        for s in range(4):
            eng.feed_slot(s, utts[s])
        case["step_ms"], case["step_all_reduce_bytes"] = {}, {}
        for key, slots, w in (("b=4 w=4", [0, 1, 2, 3], 4),
                              ("b=1 w=1", [0], 1)):
            with counting_collectives() as coll:
                case["step_ms"][key] = mesh_step_ms(eng, slots, w)
            case["step_all_reduce_bytes"][key] = \
                coll["all_reduce_bytes"] / 6       # mesh_step_ms's calls
        say(f"[mesh {dict(mesh.shape)}{' overlap' if overlap else ''}] "
            f"{tag}: {n} steps, rank {mesh.rank}'s launches {counts}; "
            f"{case['all_reduce_per_step']:.0f} all-reduces "
            f"({case['all_reduce_bytes_per_step'] / 1e6:.3f} MB) a step "
            f"over the serve, "
            f"{case['broadcasts']} readout broadcasts; first step's "
            f"log-probs {lp_err:.3e} from the unsharded forward; "
            + (f"scores {case['score_diff']:.3e} from phase 5's, words "
               f"equal 8/8" if not int8 else
               "kernel path bitwise equal to the plain products'")
            + f"; step b=4 w=4 {case['step_ms']['b=4 w=4']:.3f} ms, b=1 "
            f"w=1 {case['step_ms']['b=1 w=1']:.3f} ms, serve {wall:.3f} s "
            f"(warm {warm:.3f} s)")
        out[tag] = case
        del eng
        torch.cuda.empty_cache()
    return out


def mesh_rank(rank, world, init, want, out_dir, smi):
    """One rank of phase 22 (a spawned process): joins the world on the
    card (gloo: the ranks share it), builds phase 5's system, then runs
    each case of MESH_CASES that covers it, the others waiting at a
    barrier.  Writes (ok, results or traceback) to out_dir."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)     # 4 ranks on the host's cores: no spinning
    res = None
    try:
        dev = meshlib.init_ranks(None, init_method=init, rank=rank,
                                 world_size=world, timeout_s=MESH_TIMEOUT_S)
        fp32_numerics()
        _build.lib()
        say = print if rank == 0 else (lambda *a, **k: None)

        def say_flush(msg):
            say(msg, flush=True)
        system = full_width_system(dev)
        utts = full_width_utterances(system[1])
        out = {"device": str(dev),
               "backend": torch.distributed.get_backend()}
        if rank == 0:           # the unsharded step on the same card
            eng = mesh_engine(dev, system, None, False, False)
            for s in range(4):
                eng.feed_slot(s, utts[s])
            out["unsharded_step_ms"] = {
                "b=4 w=4": mesh_step_ms(eng, [0, 1, 2, 3], 4),
                "b=1 w=1": mesh_step_ms(eng, [0], 1)}
            del eng
        torch.distributed.barrier()
        for spec, overlap in MESH_CASES:
            mesh, n = mesh_of(spec, world)
            if mesh is not None:
                t0 = time.perf_counter()
                out[f"{spec}{' overlap' if overlap else ''}"] = dict(
                    mesh_case(dev, system, utts, mesh, overlap, want,
                              say_flush),
                    ranks=n, label=shared_card_label(n, smi),
                    case_s=time.perf_counter() - t0)
            torch.cuda.synchronize()
            torch.distributed.barrier()
        res = (True, out)
    except BaseException:          # reported to the parent, which fails
        import traceback
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def mesh_phase(smi, full_results) -> dict:
    """Phase 22: MESH_WORLD ranks spawned on the one card (gloo over
    CUDA tensors, a file:// rendezvous under build/chip_smoke/, every
    collective bounded by MESH_TIMEOUT_S), the kernel library built
    before they start.  Each mesh's fp32 transcripts equal phase 5's;
    the rest as `mesh_case` says; every rank's results equal rank 0's;
    the phase within MESH_PHASE_LIMIT_S."""
    import multiprocessing as mp
    t_phase = time.perf_counter()
    work = OUT / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    init = f"file://{work / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank,
                         args=(r, MESH_WORLD, init, full_results, str(work),
                               smi)) for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    deadline = t_phase + MESH_PHASE_LIMIT_S
    while any(p.is_alive() for p in procs) and time.perf_counter() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    time.sleep(1.0)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    outs = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.pkl"
        if not path.exists():
            fail(f"mesh phase: rank {r} wrote no result (exit code "
                 f"{p.exitcode}; killed at the phase's limit of "
                 f"{MESH_PHASE_LIMIT_S} s if still running)")
        ok, val = pickle.loads(path.read_bytes())
        if not ok:
            fail(f"mesh phase: rank {r} failed:\n{val}")
        outs.append(val)
    phase_s = time.perf_counter() - t_phase
    r0 = outs[0]
    print(f"[mesh] {MESH_WORLD} ranks on {sorted({o['device'] for o in outs})}"
          f", backend {r0['backend']}; unsharded step on the same card: "
          f"b=4 w=4 {r0['unsharded_step_ms']['b=4 w=4']:.3f} ms, b=1 w=1 "
          f"{r0['unsharded_step_ms']['b=1 w=1']:.3f} ms", flush=True)
    cases = {}
    for spec, overlap in MESH_CASES:
        key = f"{spec}{' overlap' if overlap else ''}"
        mine = [o[key] for o in outs if key in o]
        for o in mine[1:]:
            for tag in ("fp32", "int8"):
                for a, b in zip(o[tag]["results"], mine[0][tag]["results"]):
                    if not (np.array_equal(a["words"], b["words"])
                            and a["score"] == b["score"]):
                        fail(f"mesh {key} {tag}: ranks disagree: {a} vs {b}")
        c = mine[0]
        cases[key] = {
            "ranks": c["ranks"], "label": c["label"], "case_s": c["case_s"],
            **{tag: {k: v for k, v in c[tag].items() if k != "results"}
               for tag in ("fp32", "int8")},
            "counts_by_rank": [{tag: o[tag]["counts"]
                                for tag in ("fp32", "int8")} for o in mine]}
        for tag in ("fp32", "int8"):
            s = c[tag]
            print(f"[mesh {key}] {tag}: step b=4 w=4 "
                  f"{s['step_ms']['b=4 w=4']:.3f} ms "
                  f"({s['step_all_reduce_bytes']['b=4 w=4']:.0f} bytes "
                  f"all-reduced), b=1 w=1 {s['step_ms']['b=1 w=1']:.3f} ms "
                  f"({s['step_all_reduce_bytes']['b=1 w=1']:.0f} bytes), "
                  f"warm serve of 8 utterances {s['warm_serve_s']:.3f} s; "
                  f"{s['all_reduce_per_step']:.0f} all-reduces and "
                  f"{s['all_reduce_bytes_per_step']:.0f} bytes a step over "
                  f"the serve ({c['label']})", flush=True)
    counts = {name: sum(cs[tag][name] for case in cases.values()
                        for cs in case["counts_by_rank"]
                        for tag in ("fp32", "int8"))
              for name in outs[0][next(iter(cases))]["fp32"]["counts"]}
    print(f"[mesh] phase 22 took {phase_s:.2f} s (limit "
          f"{MESH_PHASE_LIMIT_S:.0f} s); launches over every rank and mesh "
          f"{counts}", flush=True)
    if phase_s > MESH_PHASE_LIMIT_S:
        fail(f"mesh phase took {phase_s:.1f} s, more than "
             f"{MESH_PHASE_LIMIT_S} s")
    return {"cases": cases, "counts": counts, "phase_s": phase_s,
            "unsharded_step_ms": r0["unsharded_step_ms"],
            "backend": r0["backend"]}


# ---------------------------------------------------------------------------
# 23. the sharded LM serving cells: build_cell prefill and decode on a
# ('data', 'model') mesh of ranks sharing the card
# ---------------------------------------------------------------------------
class CoordMesh:
    """What the spec rules and `sharding.local_block` read of a mesh, as
    the rank at `rank` of an "RxC" ('data', 'model') mesh sees it: the
    parent's view of each rank's blocks (no process group)."""

    def __init__(self, spec: str, rank: int):
        r, c = (int(v) for v in spec.split("x"))
        self.axis_names = ("data", "model")
        self.shape = {"data": r, "model": c}
        self.coords = {"data": rank // c, "model": rank % c}

    def axis(self, entry):
        names = entry if isinstance(entry, tuple) else (entry,)
        size, index = 1, 0
        for n in names:
            size, index = size * self.shape[n], (index * self.shape[n]
                                                 + self.coords[n])
        return types.SimpleNamespace(size=size, index=index)


def fingerprint(t: torch.Tensor) -> tuple:
    """The bits of `t` as two 64-bit sums of its bytes read as int32
    words (plain, and each word times an odd function of its position;
    both exact, wrapping mod 2**64), with its shape and dtype.  Equal
    tensors give equal fingerprints; unequal ones agreeing by chance is
    vanishingly unlikely.  On the card: a rank compares its blocks with
    the parent's blocks of the unsharded tree without either process
    holding the other's."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    if b.numel() % 4:
        b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
    w = b.view(torch.int32)
    s1 = s2 = 0
    step = 1 << 26
    for i in range(0, w.numel(), step):
        c = w[i:i + step].long()
        pos = torch.arange(i, i + c.numel(), device=c.device,
                           dtype=torch.int64)
        s1 += int(c.sum())
        s2 += int((c * (pos * 2654435761 + 97531)).sum())
    return (s1 % 2 ** 64, s2 % 2 ** 64, tuple(t.shape), str(t.dtype))


def lm_mesh_archs() -> dict:
    """{arch: (global batch, [mesh specs])} of LM_MESH_CASES."""
    out = {}
    for arch, spec, batch in LM_MESH_CASES:
        out.setdefault(arch, (batch, []))[1].append(spec)
    return out


def top2(logits: torch.Tensor, vocab: int):
    """(argmax, top-two margin) of each row over the real vocabulary."""
    v = logits[:, :vocab].float()
    t = torch.topk(v, 2, dim=-1).values
    return v.argmax(-1), t[:, 0] - t[:, 1]


def lm_mesh_configs(cfg):
    """Phase 23's three depths of a model: (tag, config): the bf16 model
    at LM_MESH_DEEP layers (every width), LM_MESH_LAYERS layers in fp32
    (the same draws), and LM_MESH_LAYERS layers in bf16 (where each
    path's roundings are also measured against an fp32 evaluation of the
    same weights)."""
    short = replace(cfg, n_layers=LM_MESH_LAYERS)
    return (("bf16", replace(cfg, n_layers=min(cfg.n_layers, LM_MESH_DEEP))),
            ("fp32", replace(short, dtype="float32")), ("bf16 L4", short))


@contextlib.contextmanager
def moe_routes(log: list, replay: bool):
    """Record every MoE router call's expert choices into `log`, in call
    order, or with `replay` give each call the next recorded choices
    (with its own router probabilities at those experts, renormalised).
    The kernel path records and its plain path replays, so both route
    and drop alike and their gap is the kernels' and the roundings',
    not that of a token that one path sends elsewhere: bf16 roundings
    flip a few top-k choices, and at the expert-parallel local capacity
    a flip moves which later tokens are dropped.  Models without MoE
    make no router call."""
    orig = moe.route
    it = iter(log)

    def recorded(logits, k):
        probs, top_p, top_e = orig(logits, k)
        log.append(top_e)
        return probs, top_p, top_e

    def replayed(logits, k):
        probs = torch.softmax(logits.float(), dim=-1)
        top_e = next(it)
        top_p = probs.gather(-1, top_e)
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        return probs, top_p, top_e
    moe.route = replayed if replay else recorded
    try:
        yield
    finally:
        moe.route = orig
    if replay and next(it, None) is not None:
        fail("moe routes: a replay made fewer router calls than recorded")


def upcast(tree):
    """A serving tree's floating leaves in fp32, its int8 weights kept:
    the same weights, for an fp32 evaluation of a bf16 model."""
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


def skip_first_projection(params):
    """`params` with the first layer's mixer output projection (wo, or
    Mamba's out_proj) zeroed: the control bug that the fp32 limits must
    see (its gap is held to at least LM_MESH_CONTROL times the limit)."""
    p0 = params["layers"]["p0"]
    mix = p0["mixer"]
    name = "wo" if "wo" in mix else "out_proj"
    lin = {k: v.clone() for k, v in mix[name].items()}
    for v in lin.values():
        v[0].zero_()
    return dict(params, layers=dict(params["layers"], p0=dict(
        p0, mixer=dict(mix, **{name: lin}))))


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at |x| (8 significant bits): the least nonzero gap
    two bf16 logits of that size can show.  A bf16 limit below it would
    ask the largest logits to agree bitwise, so the gap it scales is
    floored there (mamba2-1.3b at 4 layers: its unsharded kernel-vs-plain
    gap 1.5625e-2 is one ulp of a logit in [2, 4); on the mesh one flip
    at a logit in [4, 8) reads 3.125e-2)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7)


def max_gap(a, b) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


def cache_gap(got, want) -> float:
    """The largest |difference| over two caches' layer leaves (trees or
    lists of leaves in tree order)."""
    def flat(t):
        return list(_leaves(t)) if isinstance(t, dict) else t
    return max(max_gap(g, w) for g, w in zip(flat(got), flat(want)))


def lm_mesh_reference(dev, arch: str, batch: int, specs) -> dict:
    """The unsharded outputs phase 23's ranks are held to, computed in
    the parent before they start and written to LM_MESH_DIR, for each
    depth of `lm_mesh_configs` on the int8 serving tree (seed SEED):
    the kernel path's prefill logits and the plain path's (replaying
    the kernel path's MoE routes; their gap is the bf16 limits' scale),
    LM_MESH_STEPS greedy decode steps of the kernel path (the tokens
    fed, each step's argmax and top-two margin); in fp32 also both
    paths' caches and the control (`skip_first_projection`) readings;
    at LM_MESH_LAYERS layers in bf16 also the fp32 evaluation of the
    same weights (`upcast`, plain, routes replayed) and each path's gap
    from it.  Returns the fingerprints of every rank's parameter blocks
    per mesh (the tree is freed before the ranks start)."""
    cfg = get_config(arch)
    S = LM_MESH_SEQ
    rng = np.random.RandomState(SEED + 23)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (batch, S))
                              .astype(np.int32)).to(dev)
    tb = {"tokens": tokens}
    out = {"tokens": tokens.cpu()}
    prints = {}
    for tag, c in lm_mesh_configs(cfg):
        lm_k = LM(c, KernelPolicy("auto"))
        params = layers.quantize_params_for_serving(
            lm_k.init(torch.Generator(device=dev).manual_seed(SEED)))
        if tag == "bf16":
            for spec in specs:
                rules = shlib.param_shardings(c, params, CoordMesh(spec, 0))
                r, m = (int(v) for v in spec.split("x"))
                for rank in range(r * m):
                    cm = CoordMesh(spec, rank)
                    prints[(spec, rank)] = tree_map(
                        lambda t, sp, cm=cm: fingerprint(
                            shlib.local_block(t, sp, cm)), params, rules)
        routes = []
        with moe_routes(routes, replay=False):
            logits, cache = lm_k.prefill(params, tb)
        with moe_routes(routes, replay=True):
            plain, plain_cache = LM(c, PLAIN).prefill(params, tb)
        res = {"logits": logits.float().cpu(), "plain": plain.float().cpu(),
               "gap": max_gap(logits, plain)}
        if tag == "fp32":
            res["cache"] = tree_map(lambda t: t.cpu().clone(), cache)
            res["plain cache"] = tree_map(lambda t: t.cpu().clone(),
                                          plain_cache)
            mut, mut_cache = lm_k.prefill(skip_first_projection(params), tb)
            res["control"] = max_gap(mut, logits)
            res["control cache"] = cache_gap(mut_cache["layers"],
                                             cache["layers"])
            del mut, mut_cache
        if tag == "bf16 L4":
            with moe_routes(routes, replay=True):
                truth, _ = LM(replace(c, dtype="float32"), PLAIN).prefill(
                    upcast(params), tb)
            res.update(truth=truth.cpu(), err=max_gap(logits, truth),
                       plain_err=max_gap(plain, truth))
            del truth
        del plain, plain_cache, routes
        fed, argmax, margin = [], [], []
        tok, _ = top2(logits, cfg.vocab_size)
        for _ in range(LM_MESH_STEPS):
            fed.append(tok.cpu())
            lg, _, cache = lm_k.decode_step(params, cache,
                                            {"tokens": tok[:, None]})
            tok, mg = top2(lg, cfg.vocab_size)
            argmax.append(tok.cpu())
            margin.append(mg.cpu())
        res.update(fed=torch.stack(fed), argmax=torch.stack(argmax),
                   margin=torch.stack(margin))
        out[tag] = res
        del params, cache, logits, lm_k
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(out, LM_MESH_DIR / f"{arch}.pt")
    print(f"[lm mesh] {arch}: unsharded references at B={batch} S={S}: "
          f"kernel-vs-plain prefill gaps bf16 {out['bf16']['gap']:.4e}, "
          f"{LM_MESH_LAYERS} layers bf16 {out['bf16 L4']['gap']:.4e}, fp32 "
          f"{out['fp32']['gap']:.3e}; {LM_MESH_LAYERS} layers bf16 from "
          f"the fp32 evaluation: kernel {out['bf16 L4']['err']:.4e}, plain "
          f"{out['bf16 L4']['plain_err']:.4e}; fp32 control (first "
          f"projection skipped): logits {out['fp32']['control']:.4e}, cache "
          f"{out['fp32']['control cache']:.4e}; bf16 decode margins min "
          f"{out['bf16']['margin'].min().item():.4f}", flush=True)
    return prints


@contextlib.contextmanager
def counting_lm_collectives():
    """Count the collectives of mesh axes of more than one rank, by kind,
    with the bytes each rank puts in."""
    stats = {}
    ax = meshlib.MeshAxis
    orig = {name: getattr(ax, name) for name in (
        "all_reduce", "all_reduce_max", "all_gather", "all_to_all")}

    def wrap(name):
        def counted(self, t, *args, **kwargs):
            if self.size > 1:
                n, b = stats.get(name, (0, 0))
                stats[name] = (n + 1, b + t.numel() * t.element_size())
            return orig[name](self, t, *args, **kwargs)
        return counted
    for name in orig:
        setattr(ax, name, wrap(name))
    try:
        yield stats
    finally:
        for name, fn in orig.items():
            setattr(ax, name, fn)


def lm_mesh_run(dev, fn, args, norms, attn):
    """One main-path call of a cell: launch counts set to 0 just before
    and read just after (every wrapper of the path must have launched
    as expected), collectives counted, wall time to a synchronize."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with counting_lm_collectives() as coll:
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    expect = {name: 0 for name in counts}
    expect["rmsnorm"], expect["flash_attention"] = norms, attn
    if counts != expect:
        fail(f"lm mesh: launch counts {counts} != expected {expect}")
    return res, ms, counts, dict(coll)


def lm_mesh_case(dev, arch, spec, batch, mesh, prints, rank) -> dict:
    """One (arch, mesh) case on this rank; fails on any check.  At each
    depth the kernel path (counted) and the mesh's plain path (replaying
    its MoE routes) run prefill and LM_MESH_STEPS decode steps fed the
    unsharded run's tokens, and are held:
      * kernels isolated from the shards: the kernel path's prefill
        logits within `limit` of the mesh's plain path's (bf16:
        EMB_DEPTH_RATIO x the unsharded kernel-vs-plain gap, that gap
        floored at one bf16 ulp of max |logit| (`bf16_ulp`); fp32:
        LM_LOGIT_RTOL), its decode tokens equal the plain path's where
        the plain top-two margin is above LM_MESH_SURE x `limit`;
      * the shards: in fp32 both paths' logits within LM_LOGIT_RTOL of
        max |logit| of the unsharded paths', their caches' blocks within
        LM_MESH_CACHE_RTOL of the cache's max |value| (the control bug
        at least LM_MESH_CONTROL times each limit), decode tokens equal
        the unsharded argmax where sure; in bf16 at LM_MESH_LAYERS
        layers each path's gap from the fp32 evaluation of the same
        weights on the mesh within EMB_DEPTH_RATIO x the unsharded
        path's.  Where the expert-parallel prefill dropped tokens (a
        local capacity) the shards are held to the mesh's plain path
        only: the unsharded function drops others."""
    cfg = get_config(arch)
    ref = torch.load(LM_MESH_DIR / f"{arch}.pt")
    S = LM_MESH_SEQ
    attn = LM_LAUNCHES[arch][1]
    kern = KernelPolicy("auto")
    torch.cuda.reset_peak_memory_stats(dev)
    res = {"counts": {}, "collectives": {}, "ms": {}}
    toks = ref["tokens"].to(dev)
    bspec = shlib.batch_shardings({"t": toks}, mesh)["t"]

    def local(t):
        return shlib.local_block(t.to(dev), bspec, mesh).contiguous()

    def held(what, got, limit):
        # every prefill check of a depth is made and printed before any
        # failure ends the case
        if not got <= limit:
            problems.append(f"{what} {got:.4e} (limit {limit:.4e})")
    pre = ShapeSpec("prefill", S, batch, "prefill")
    dec = ShapeSpec("decode", S, batch, "decode")
    for tag, c in lm_mesh_configs(cfg):
        rb = ref[tag]
        # two norms a layer and the final one; a flash launch a layer
        n_norm = 2 * c.n_layers + 1
        n_attn = c.n_layers if attn else 0
        fn_p, (p_loc, b_loc) = steps.build_cell(c, pre, mesh, policy=kern)
        fn_d, (_, c_loc, d_loc) = steps.build_cell(c, dec, mesh, policy=kern)
        fn_pp, _ = steps.build_cell(c, pre, mesh, policy=PLAIN)
        lm_pd = steps.build_lm(c, mesh, PLAIN)
        lay_pd = lm_pd.layout(dec, int8=True)
        t0 = time.perf_counter()
        params = steps.build_lm(c, mesh, kern).init_local(
            torch.Generator(device=dev).manual_seed(SEED), int8=True)
        torch.cuda.synchronize()
        res[f"{tag} init_s"] = time.perf_counter() - t0
        got = [tuple(t.shape) for t in _leaves(params)]
        if got != [tuple(t.shape) for t in _leaves(p_loc)]:
            fail(f"lm mesh {arch} {spec}: rank {rank}'s blocks are not "
                 f"build_cell's local shapes")
        if tag == "bf16":
            mine = tree_map(fingerprint, params)
            bad = [path for (path, a), (_, b) in zip(
                _dict_paths(mine), _dict_paths(prints)) if a != b]
            n_leaves = len(list(_dict_paths(mine)))
            if bad or n_leaves != len(list(_dict_paths(prints))):
                fail(f"lm mesh {arch} {spec}: rank {rank}'s blocks differ "
                     f"from the unsharded serving tree's at {bad[:4]}")
            res["bitwise_leaves"] = n_leaves
        batch_l = {"tokens": local(toks)}
        routes = []
        moe.drops.clear()
        with moe_routes(routes, replay=False):
            (logits, cache), ms, cnt, coll = lm_mesh_run(
                dev, fn_p, (params, batch_l), n_norm, n_attn)
        drops = [int(d) for d in moe.drops]
        moe.drops.clear()
        with moe_routes(routes, replay=True):
            plain, plain_cache = fn_pp(params, batch_l)
        if [int(d) for d in moe.drops] != drops:
            fail(f"lm mesh {arch} {spec}: {tag} plain path replaying the "
                 f"kernel path's routes dropped {list(moe.drops)}, not "
                 f"{drops}")
        res["ms"][f"{tag} prefill"] = ms
        res["counts"][f"{tag} prefill"] = cnt
        res["collectives"][f"{tag} prefill"] = coll
        res[f"{tag} drops"] = drops
        if [tuple(t.shape) for t in _leaves(cache)] != [
                tuple(t.shape) for t in _leaves(c_loc)]:
            fail(f"lm mesh {arch} {spec}: the prefill cache's blocks are "
                 f"not build_cell's local cache shapes")
        if not (torch.isfinite(logits.float()).all()
                and torch.isfinite(plain.float()).all()):
            fail(f"lm mesh {arch} {spec}: non-finite {tag} logits")
        # the kernels, isolated from the shards' roundings
        problems = []
        limit = (LM_LOGIT_RTOL[torch.float32] if tag == "fp32"
                 else EMB_DEPTH_RATIO * max(rb["gap"], bf16_ulp(
                     rb["logits"].abs().max().item())))
        res[f"{tag} kernel gap"] = max_gap(logits, plain)
        res[f"{tag} limit"] = limit
        held(f"{tag} prefill logits, kernel path vs the mesh's plain path",
             res[f"{tag} kernel gap"], limit)
        # the shards: sharded vs unsharded, each path
        res[f"{tag} gap"] = max_gap(logits, rb["logits"])
        res[f"{tag} plain gap"] = max_gap(plain, rb["plain"])
        whole = not any(drops)
        cross = LM_LOGIT_RTOL[torch.float32] * rb["logits"].abs().max().item()
        if tag == "fp32":
            specs = lm_pd.cache_specs(batch, S)

            def blocks(tree):
                return [shlib.local_block(t.to(dev), sp, mesh)
                        for t, sp in zip(_leaves(tree["layers"]),
                                         _leaves(specs["layers"]))]
            scale = max(t.abs().max().item()
                        for t in _leaves(rb["cache"]["layers"]))
            climit = LM_MESH_CACHE_RTOL * scale
            res["fp32 cache max"] = scale
            for what, got, lim in (("logits", rb["control"], cross),
                                   ("cache", rb["control cache"], climit)):
                if got < LM_MESH_CONTROL * lim:
                    fail(f"lm mesh {arch}: the control bug (first "
                         f"projection skipped) moves the fp32 {what} by "
                         f"{got:.3e}, under {LM_MESH_CONTROL} x its limit "
                         f"{lim:.3e}: the check would not see it")
            if whole:
                held("fp32 prefill logits from the unsharded kernel path's",
                     res["fp32 gap"], cross)
                held("fp32 plain prefill logits from the unsharded plain "
                     "path's", res["fp32 plain gap"], cross)
                res["fp32 cache err"] = cache_gap(cache["layers"],
                                                  blocks(rb["cache"]))
                res["fp32 plain cache err"] = cache_gap(
                    plain_cache["layers"], blocks(rb["plain cache"]))
                held("fp32 plain cache blocks from the unsharded plain "
                     "path's", res["fp32 plain cache err"], climit)
            else:
                res["fp32 cache err"] = cache_gap(cache["layers"],
                                                  plain_cache["layers"])
            held("fp32 cache blocks from the unsharded (or, where tokens "
                 "were dropped, the mesh's plain) path's",
                 res["fp32 cache err"], climit)
            kp = shlib.local_block(rb["cache"]["kpos"].to(dev),
                                   specs["kpos"], mesh)
            if not torch.equal(kp, cache["kpos"]):
                fail(f"lm mesh {arch} {spec}: the cache's kpos block")
        if tag == "bf16 L4":
            # each path against the fp32 evaluation of the same weights
            # on the same mesh (routes replayed), as the unsharded paths
            fn_t, _ = steps.build_cell(replace(c, dtype="float32"), pre,
                                       mesh, policy=PLAIN)
            with moe_routes(routes, replay=True):
                truth, _ = fn_t(upcast(params), batch_l)
            res["L4 err"] = max_gap(logits, truth)
            res["L4 plain err"] = max_gap(plain, truth)
            res["L4 truth gap"] = max_gap(truth, rb["truth"])
            res["L4 err un"], res["L4 plain err un"] = (rb["err"],
                                                        rb["plain_err"])
            held("bf16 L4 kernel path's logits from the mesh's fp32 "
                 "evaluation", res["L4 err"], EMB_DEPTH_RATIO * rb["err"])
            held("bf16 L4 plain path's logits from the mesh's fp32 "
                 "evaluation", res["L4 plain err"],
                 EMB_DEPTH_RATIO * rb["plain_err"])
            del truth
        if rank == 0:
            kg, g, pg = (res[f"{tag} {k}"] for k in (
                "kernel gap", "gap", "plain gap"))
            print(f"[lm mesh {arch} {spec}] {tag}: prefill {ms:.1f} ms; "
                  f"kernel vs the mesh's plain path {kg:.4e} (limit "
                  f"{limit:.4e}); from the unsharded run: kernel path "
                  f"{g:.4e}, plain path {pg:.4e} (max |logit| "
                  f"{rb['logits'].abs().max().item():.3f})"
                  + (f"; drops per layer {drops}" if drops else ""),
                  flush=True)
        if problems:
            fail(f"lm mesh {arch} {spec}: " + "; ".join(problems))
        del plain
        # decode: the unsharded run's tokens fed to both paths
        step_ms, n_held, n_held_un = [], 0, 0
        for i in range(LM_MESH_STEPS):
            feed = {"tokens": local(rb["fed"][i][:, None])}
            r_i = []
            with moe_routes(r_i, replay=False):
                (tok, cache), ms, cnt, coll = lm_mesh_run(
                    dev, fn_d, (params, cache, feed), n_norm, 0)
            with moe_routes(r_i, replay=True):
                plg, ptok, plain_cache = lm_pd.decode_step(
                    params, plain_cache, feed, layout=lay_pd)
            step_ms.append(ms)
            # a token is only as sure as the logits: held where the
            # plain path's top-two margin is above LM_MESH_SURE x limit
            sure = (top2(plg, cfg.vocab_size)[1] > LM_MESH_SURE * limit).cpu()
            n_held += int(sure.sum())
            if not torch.equal(tok.cpu()[sure], ptok.cpu()[sure]):
                fail(f"lm mesh {arch} {spec}: {tag} decode step {i} tokens "
                     f"{tok.tolist()} != the mesh's plain path's "
                     f"{ptok.tolist()} where sure ({sure.tolist()})")
            if tag == "fp32" and whole:
                sure = rb["margin"][i] > LM_MESH_SURE * cross
                n_held_un += int(sure.sum())
                if not torch.equal(tok.cpu()[sure], rb["argmax"][i][sure]):
                    fail(f"lm mesh {arch} {spec}: fp32 decode step {i} "
                         f"tokens {tok.tolist()} != the unsharded run's "
                         f"{rb['argmax'][i].tolist()} where sure")
        res["ms"][f"{tag} decode step"] = float(np.median(step_ms))
        res["counts"][f"{tag} decode step"] = cnt
        res["collectives"][f"{tag} decode step"] = coll
        res[f"{tag} decode tokens held"] = n_held
        if tag == "fp32":
            res["fp32 decode tokens held (unsharded)"] = n_held_un
        del params, cache, plain_cache, logits
        gc.collect()
        torch.cuda.empty_cache()
    res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def _dict_paths(tree, path=()):
    """(path, leaf) pairs of a dict tree; tuples are leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _dict_paths(v, path + (k,))
    else:
        yield path, tree


def lm_mesh_rank(rank, world, init, out_dir, prints):
    """One rank of phase 23 (a spawned process): joins the world on the
    card, then runs each case of LM_MESH_CASES whose mesh covers it, the
    others waiting at a barrier.  Writes (ok, results or traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    res = None
    try:
        dev = meshlib.init_ranks(None, init_method=init, rank=rank,
                                 world_size=world,
                                 timeout_s=LM_MESH_TIMEOUT_S)
        fp32_numerics()
        _build.lib()
        out = {"device": str(dev)}
        for arch, spec, batch in LM_MESH_CASES:
            mesh, n = mesh_of(spec, world)
            if mesh is not None:
                t0 = time.perf_counter()
                out[f"{arch} {spec}"] = dict(
                    lm_mesh_case(dev, arch, spec, batch, mesh,
                                 prints[(arch, spec, rank)], rank),
                    ranks=n, case_s=time.perf_counter() - t0)
            torch.cuda.synchronize()
            torch.distributed.barrier()
        res = (True, out)
    except BaseException:          # reported to the parent, which fails
        import traceback
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def lm_mesh_phase(dev, smi) -> dict:
    """Phase 23: the unsharded references in this process (then freed),
    then MESH_WORLD ranks spawned on the card run every case (see
    `lm_mesh_case`); every rank's logits and tokens checked on the rank,
    launches per rank and per cell checked and printed with the
    collectives, times and peak memory; within LM_MESH_PHASE_LIMIT_S."""
    import multiprocessing as mp
    t_phase = time.perf_counter()
    shutil.rmtree(LM_MESH_DIR, ignore_errors=True)
    LM_MESH_DIR.mkdir(parents=True)
    prints = {}
    for arch, (batch, specs) in lm_mesh_archs().items():
        for (spec, rank), fp in lm_mesh_reference(dev, arch, batch,
                                                  specs).items():
            prints[(arch, spec, rank)] = fp
    gc.collect()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    init = f"file://{LM_MESH_DIR / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=lm_mesh_rank,
                         args=(r, MESH_WORLD, init, str(LM_MESH_DIR),
                               prints)) for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    deadline = t_phase + LM_MESH_PHASE_LIMIT_S
    while any(p.is_alive() for p in procs) and time.perf_counter() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    time.sleep(1.0)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    outs = []
    for r, p in enumerate(procs):
        path = LM_MESH_DIR / f"rank{r}.pkl"
        if not path.exists():
            fail(f"lm mesh phase: rank {r} wrote no result (exit code "
                 f"{p.exitcode}; killed at the phase's limit of "
                 f"{LM_MESH_PHASE_LIMIT_S} s if still running)")
        ok, val = pickle.loads(path.read_bytes())
        if not ok:
            fail(f"lm mesh phase: rank {r} failed:\n{val}")
        outs.append(val)
    phase_s = time.perf_counter() - t_phase
    cases, counts = {}, {"rmsnorm": 0, "flash_attention": 0}
    tags = [tag for tag, _ in lm_mesh_configs(get_config(LM_ARCH))]
    for arch, spec, batch in LM_MESH_CASES:
        key = f"{arch} {spec}"
        mine = [o[key] for o in outs if key in o]
        label = shared_card_label(len(mine), smi)
        for r, c in enumerate(mine):
            # the logits are whole on every rank: every rank's gaps alike
            for k in [k for k in c if k.endswith(("gap", "err"))
                      and "cache" not in k]:
                if c[k] != mine[0][k]:
                    fail(f"lm mesh {key}: rank {r}'s {k} {c[k]} != rank "
                         f"0's {mine[0][k]}")
            for cell, cnt in c["counts"].items():
                n = LM_MESH_STEPS if cell.endswith("decode step") else 1
                for name in counts:
                    counts[name] += n * cnt[name]
            per_cell = {k: (v["rmsnorm"], v["flash_attention"])
                        for k, v in c["counts"].items()}
            print(f"[lm mesh {key}] rank {r}: (rmsnorm, flash) launches "
                  f"per cell {per_cell}; peak {c['peak_gb']:.2f} GB; "
                  f"{c['bitwise_leaves']} parameter blocks bitwise",
                  flush=True)
        # the cache's blocks differ by rank: the largest gap over them
        c = dict(mine[0], **{k: max(m[k] for m in mine) for k in (
            "fp32 cache err", "fp32 plain cache err") if k in mine[0]})
        ms = c["ms"]
        print(f"[lm mesh {key}] B={batch} S={LM_MESH_SEQ} ({label}): "
              + "; ".join(f"{t} prefill {ms[f'{t} prefill']:.1f} ms, decode "
                          f"step {ms[f'{t} decode step']:.1f} ms"
                          for t in tags)
              + "; kernel vs the mesh's plain path (limit): "
              + ", ".join(f"{t} {c[f'{t} kernel gap']:.4e} "
                          f"({c[f'{t} limit']:.4e})" for t in tags)
              + "; sharded vs unsharded (kernel / plain path): "
              + ", ".join(f"{t} {c[f'{t} gap']:.4e} / "
                          f"{c[f'{t} plain gap']:.4e}" for t in tags)
              + f"; bf16 {LM_MESH_LAYERS} layers from the fp32 evaluation "
              f"(mesh / unsharded): kernel {c['L4 err']:.4e} / "
              f"{c['L4 err un']:.4e}, plain {c['L4 plain err']:.4e} / "
              f"{c['L4 plain err un']:.4e}, the two evaluations "
              f"{c['L4 truth gap']:.3e} apart; fp32 cache "
              f"{c['fp32 cache err']:.3e}"
              + (f" (plain path {c['fp32 plain cache err']:.3e})"
                 if "fp32 plain cache err" in c else "")
              + f" of max |value| {c['fp32 cache max']:.3f}; decode tokens "
              "held against the mesh's plain path: "
              + ", ".join(f"{t} {c[f'{t} decode tokens held']}"
                          for t in tags)
              + f", fp32 against the unsharded run "
              f"{c['fp32 decode tokens held (unsharded)']}"
              + (f"; EP drops per layer bf16 {c['bf16 drops']}, fp32 "
                 f"{c['fp32 drops']}" if c["bf16 drops"] else "")
              + f"; case {c['case_s']:.1f} s; rank 0's collectives per "
              f"cell (calls, bytes put in) {c['collectives']}", flush=True)
        cases[key] = {"label": label, "ranks": mine}
    print(f"[lm mesh] phase 23 took {phase_s:.2f} s (references "
          f"{ref_s:.2f} s; limit {LM_MESH_PHASE_LIMIT_S:.0f} s); launches "
          f"over every rank and case {counts} ({smi}); depth cut: the deep "
          f"bf16 check at {LM_MESH_DEEP} layers of "
          + ", ".join(f"{a}'s {get_config(a).n_layers}"
                      for a in lm_mesh_archs())
          + " (every width kept), so that the whole run keeps within "
          "1000 s", flush=True)
    if phase_s > LM_MESH_PHASE_LIMIT_S:
        fail(f"lm mesh phase took {phase_s:.1f} s, more than "
             f"{LM_MESH_PHASE_LIMIT_S} s")
    return {"cases": cases, "counts": counts, "phase_s": phase_s,
            "ref_s": ref_s}


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# 24. the network server on the mesh: rank 0 serves and leads, the other
# ranks replay its command stream; ranks sharing the card
# ---------------------------------------------------------------------------
def mesh_rank_state(eng) -> dict:
    """What every rank of a mesh's engine must hold alike at the end."""
    return {"n_steps": eng.n_steps, "slot_steps": eng._slot_steps.tolist(),
            "digest": eng._digest(), "fault_log": list(eng._fault_log),
            "steps": list(eng.step_shapes)}


async def serve_until(server, stop: pathlib.Path, port: pathlib.Path):
    """(rank 0) Write the started server's port to `port`; serve until
    `stop` exists."""
    tmp = port.with_suffix(".tmp")
    tmp.write_text(str(server.port))
    tmp.replace(port)
    while not stop.exists():
        await asyncio.sleep(0.02)


def lead_server(eng, channel, script, ctx=None, **kw) -> dict:
    """(rank 0) An EngineServer over `eng` leading `channel`: runs
    `script(server, ctx)` against it, then drains it (its stop message
    ends the followers' replay)."""
    async def go():
        server = EngineServer(asr_engine=eng, channel=channel, **kw)
        await server.start()
        try:
            res = await script(server, ctx) or {}
        finally:
            await server.aclose(drain=True, timeout=NET_WAIT_S)
        if server.fatal is not None:
            raise RuntimeError(f"rank 0's server: {server.fatal}")
        res.update(stream=dict(server._leader.stats),
                   restarts=server._restarts["asr"])
        return res
    return asyncio.run(go())


async def sm_raise(server, ctx):
    """An asr_step raise matched on NET_POISON_SID: four clients opened
    in order (sids 0-3) stream at once."""
    h, p = server.host, server.port
    t0 = time.perf_counter()
    clients = [await AsrClient.open(h, p) for _ in ctx["utts"]]
    finals = await asyncio.gather(*[
        drive_stream(c, a, ctx["chunk"], t0)
        for c, a in zip(clients, ctx["utts"])])
    return {"finals": [f["final"] for f in finals],
            "healthz": (await fetch_healthz(h, p))[0]}


async def sm_deadline(server, ctx):
    """A client that pushes one chunk and stalls beside one that streams
    a whole utterance: the stalled session is reaped after
    SERVE_MESH_DEADLINE_S (rank 0's clock), its next push sees the
    fault; the other stream is untouched."""
    h, p = server.host, server.port
    stalled = await AsrClient.open(h, p)
    await stalled.push(ctx["utts"][0][:ctx["chunk"]])
    t0 = time.perf_counter()
    streamed = await net_stream(h, p, ctx["utts"][1], ctx["chunk"])

    async def reaped():
        m = await fetch_metrics(h, p)
        return m["asr"]["sessions"]["deadline_evicted"] >= 1
    await wait_for(reaped, "the stalled session's reap")
    reap_s = time.perf_counter() - t0
    err = await stalled.push(ctx["utts"][0][:ctx["chunk"]])
    await stalled.aclose()
    return {"streamed": streamed["final"], "error": err, "reap_s": reap_s}


async def sm_watchdog(server, ctx):
    """A warm stream, a session in flight, then a `pump` stall with the
    supervisor held until the heartbeat ages past the watchdog: /healthz
    503; the restart (whose quarantine goes through the new worker's
    stream), the zombie released, /healthz 200; a fresh stream."""
    h, p = server.host, server.port
    old = server._asr_worker
    warm = await net_stream(h, p, ctx["utts"][0], ctx["chunk"])
    inflight = await AsrClient.open(h, p)
    await inflight.push(ctx["utts"][1][:ctx["chunk"]])
    server._supervisor.cancel()
    try:
        await server._supervisor
    except asyncio.CancelledError:
        pass
    ctx["arm"]["on"] = True

    async def aged():
        return old.heartbeat_age() > NET_WATCHDOG_S
    await wait_for(aged, "the stalled worker's heartbeat age")
    ctx["arm"]["on"] = False
    wedged, _ = await fetch_healthz(h, p)
    server._supervisor = asyncio.get_running_loop().create_task(
        server._supervise())

    async def replaced():
        return server._asr_worker is not old
    await wait_for(replaced, "the restart")
    ctx["policy"].release()

    async def healthy():
        st, pl = await fetch_healthz(h, p)
        return (st, pl) if st == 200 else None
    status, payload = await wait_for(healthy, "/healthz 200 again")
    await inflight.aclose()
    fresh = await net_stream(h, p, ctx["utts"][2], ctx["chunk"])
    return {"warm": warm["final"], "fresh": fresh["final"],
            "wedged_healthz": wedged, "healthz": status,
            "restarts": payload["engines"]["asr"]["restarts"]}


async def sm_drain(server, ctx):
    """aclose(drain=True) with every stream mid-flight."""
    h, p = server.host, server.port
    opened = [asyncio.Event() for _ in ctx["utts"]]
    tasks = [asyncio.create_task(net_stream(h, p, a, ctx["chunk"],
                                            opened=opened[i]))
             for i, a in enumerate(ctx["utts"])]
    for ev in opened:
        await ev.wait()
    await server.aclose(drain=True, timeout=60.0)
    return {"finals": [r["final"] for r in await asyncio.gather(*tasks)]}


def sm_demo_engine(name, dev, demo, mesh):
    """The demo system's engine of one fault case, and its script's
    context."""
    ctx = {}
    kw = {}
    if name == "raise":
        kw["faults"] = FaultPolicy([FaultSpec(
            "asr_step", count=None, message="poisoned session",
            match=lambda c: NET_POISON_SID in c.get("sids", ()))])
    elif name == "deadline":
        kw["session_deadline"] = SERVE_MESH_DEADLINE_S
    elif name == "watchdog":
        arm = ctx["arm"] = {"on": False}
        ctx["policy"] = kw["faults"] = FaultPolicy(
            [FaultSpec("pump", action="stall", count=1,
                       match=lambda c: arm["on"])], stall_timeout=60.0)
        kw["worker_watchdog"] = NET_WATCHDOG_S
    eng, _ = asr_demo_engine(4, KernelPolicy("kernel"), device=dev,
                             system=demo, mesh=mesh, **kw)
    ctx.update(utts=[SyntheticASR(demo[1]).utterance(u)["audio"]
                     for u in range(4)],
               chunk=eng.plan.samples_per_step)
    return eng, ctx


SM_SCRIPTS = {"raise": sm_raise, "deadline": sm_deadline,
              "watchdog": sm_watchdog, "drain": sm_drain}


def serve_mesh_rank(rank, world, init, out_dir):
    """One rank of phase 24 (a spawned process).  (a) For each case of
    SERVE_MESH_CASES over the world's first ranks (the rest wait at a
    barrier): rank 0 serves phase 5's system with an EngineServer of
    NET_SLOTS slots and a queue of NET_MAX_QUEUE leading the case's
    command channel, tells the parent its port through a file and
    serves until the parent's stop file; the others replay its stream.
    The launch counts are set to 0 just before and read just after.
    (b) The fault cases on the demo system at SERVE_MESH_DEMO, their
    clients run by rank 0.  Writes (ok, results or traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    res = None
    out_dir = pathlib.Path(out_dir)
    try:
        dev = meshlib.init_ranks(None, init_method=init, rank=rank,
                                 world_size=world, timeout_s=MESH_TIMEOUT_S)
        fp32_numerics()
        _build.lib()
        system = full_width_system(dev)
        tds_cfg, _, lex, lm, params, dec_cfg = system
        out = {}
        for k, (spec, int8) in enumerate(SERVE_MESH_CASES):
            mesh, n = mesh_of(spec, world)
            channel = meshlib.make_channel(range(n), timeout_s=MESH_TIMEOUT_S)
            if mesh is not None:
                prog = AsrProgram(tds_cfg, lex, lm, dec_cfg=dec_cfg,
                                  use_int8=int8)
                eng = AsrEngine(EngineConfig(prog, n_slots=NET_SLOTS,
                                             max_queue=NET_MAX_QUEUE,
                                             mesh=mesh), params, device=dev)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                t0 = time.perf_counter()
                if rank == 0:
                    case = lead_server(eng, channel, lambda server, _: (
                        serve_until(server, out_dir / f"wave{k}.stop",
                                    out_dir / f"wave{k}.port")))
                else:
                    case = {"follow": follow(eng, channel)}
                torch.cuda.synchronize()
                case.update(mesh_rank_state(eng), counts=ops.launch_counts(),
                            case_s=time.perf_counter() - t0)
                out[f"{spec} {'int8' if int8 else 'fp32'}"] = case
                del eng
                torch.cuda.empty_cache()
            torch.distributed.barrier()
        del system, params
        torch.cuda.empty_cache()
        demo = asr_demo_system()
        mesh, n = mesh_of(SERVE_MESH_DEMO, world)
        for name, script in SM_SCRIPTS.items():
            channel = meshlib.make_channel(range(n), timeout_s=MESH_TIMEOUT_S)
            if mesh is not None:
                eng, ctx = sm_demo_engine(name, dev, demo, mesh)
                if rank == 0:
                    case = lead_server(eng, channel, script, ctx,
                                       watch_interval=0.05)
                else:
                    case = {"follow": follow(eng, channel)}
                case.update(mesh_rank_state(eng))
                out[f"demo {name}"] = case
            torch.distributed.barrier()
        res = (True, out)
    except BaseException:          # reported to the parent, which fails
        import traceback
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(out_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)


def mesh_wire_miss(got, want, int8=False):
    """Why a stream's final payload misses an in-process result, or None:
    words, tokens and steps must be equal, scores within MESH_SCORE_ATOL
    (int8: within INT8_SCORE_RTOL of |score|, see SERVE_MESH_CASES)."""
    if got.get("error"):
        return f"the stream ended in an error: {got}"
    w = as_wire(want)
    limit = INT8_SCORE_RTOL * abs(w["score"]) if int8 else MESH_SCORE_ATOL
    if any(got[k] != w[k] for k in ("words", "tokens", "steps")) or \
            not abs(got["score"] - w["score"]) < limit:
        return f"over the wire {got}, in process {w} (score limit " \
               f"{limit:.3e})"
    return None


def check_mesh_wire(tag, got, want, int8=False):
    """`mesh_wire_miss` as a check: fails the run on a miss."""
    miss = mesh_wire_miss(got, want, int8)
    if miss:
        fail(f"{tag}: {miss}")


def serve_mesh_wave(port: int, utts, chunk: int) -> dict:
    """(the parent) Phase 16's measured wave against rank 0's server: a
    warm-up wave of NET_SLOTS streams, then the utterances' streams
    NET_STAGGER_S apart, pushing `chunk` samples with a poll after each;
    the command stream's counts read from /metrics around the wave."""
    h = "127.0.0.1"

    async def go():
        await asyncio.gather(*[net_stream(h, port, utts[i], chunk,
                                          NET_STAGGER_S * i)
                               for i in range(NET_SLOTS)])
        before = (await fetch_metrics(h, port))["asr"]["command_stream"]
        t0 = time.perf_counter()
        wave = await asyncio.gather(*[
            net_stream(h, port, u, chunk, NET_STAGGER_S * i)
            for i, u in enumerate(utts)])
        wall = time.perf_counter() - t0
        after = await fetch_metrics(h, port)
        return wave, wall, before, after
    wave, wall, before, after = asyncio.run(go())
    stream = after["asr"]["command_stream"]
    audio_s = sum(len(u) for u in utts) / 16000.0
    return {"wave": wave, "wall_s": wall, "audio_s": audio_s,
            "wire_x_realtime": audio_s / wall,
            "first_result_ms": {f"p{q}": pct_ms(
                [r["first_result_s"] for r in wave], q) for q in (50, 99)},
            "finalize_ms": {f"p{q}": pct_ms(
                [r["finalize_s"] for r in wave], q) for q in (50, 99)},
            "wave_messages": stream["messages"] - before["messages"],
            "wave_bytes": stream["bytes"] - before["bytes"],
            "wave_commands": stream["commands"] - before["commands"],
            "wave_send_s": stream["send_s"] - before["send_s"],
            "queue_max_depth": after["asr"]["queue"]["max_depth"]}


def rank_pids(pid: int) -> list:
    """The pids whose parent is `pid` (from /proc): torchrun's ranks."""
    out = []
    for d in pathlib.Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                stat = (d / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(d.name))
    return out


def serve_mesh_launcher() -> dict:
    """`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    repro_torch.launch.serve --serve --mesh 2 --port 0` on the card (2
    ranks sharing it): one /asr stream, one LM generation and /metrics
    through rank 0's printed address; then SIGTERM to each rank, as
    torchrun forwards it: rank 0 drains, its stop message ends rank 1's
    replay, and torchrun exits 0, which it does only when every rank
    did."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
           "--serve", "--mesh", "2", "--port", "0", "--streams", "4"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving ASR"):
                break
        if not lines or not lines[-1].startswith("serving ASR"):
            fail(f"the --serve --mesh launcher printed no address: "
                 f"{''.join(lines)}")
        up_s = time.perf_counter() - t0
        addr = lines[-1].split("http://")[1].split()[0]
        host, port = addr.rsplit(":", 1)
        audio = SyntheticASR(asr_demo_system()[1]).utterance(0)["audio"]

        async def go():
            r = await net_stream(host, int(port), audio, 1280)
            gen = await lm_generate(host, int(port), [1, 2, 3, 4])
            return r, gen, await fetch_metrics(host, int(port))
        r, gen, metrics = asyncio.run(go())
        pids = rank_pids(proc.pid)
        if len(pids) != 2:
            fail(f"the --serve --mesh launcher runs ranks {pids}, not 2")
        for pid in pids:
            os.kill(pid, signal.SIGTERM)
        rest, _ = proc.communicate(timeout=NET_LAUNCHER_WAIT_S)
    except BaseException:
        if proc.poll() is None:
            proc.kill()
        rest, _ = proc.communicate()
        print(f"[serve mesh launcher] its output:\n{''.join(lines)}{rest}",
              file=sys.stderr, flush=True)
        raise
    text = "".join(lines) + rest
    final = r["final"]
    if final.get("error") or not np.isfinite(final["score"]) or \
            final["steps"] < 1:
        fail(f"the --serve --mesh launcher's ASR stream gave {final}")
    if not gen.get("done") or not gen.get("tokens"):
        fail(f"the --serve --mesh launcher's LM request gave {gen}")
    if set(metrics) != {"asr", "lm"} or \
            metrics["asr"]["command_stream"]["messages"] < 1:
        fail(f"the --serve --mesh launcher's /metrics gave {metrics}")
    if "drained; server stopped" not in text or \
            "[rank 1] stopped by rank 0" not in text or proc.returncode:
        fail(f"the --serve --mesh launcher did not drain cleanly (torchrun "
             f"rc {proc.returncode}):\n{text}")
    return {"up_s": up_s, "wall_s": time.perf_counter() - t0,
            "asr_steps": final["steps"], "lm_tokens": len(gen["tokens"]),
            "messages": metrics["asr"]["command_stream"]["messages"],
            "rc": proc.returncode}


def rel_score_gaps(wave, want) -> list:
    """Each stream's final score gap over the in-process |score|."""
    return [float(f"{abs(r['final']['score'] - w['score']) / abs(w['score']):.3e}")
            for r, w in zip(wave, want)]


def serve_mesh_checks(outs, waves, results) -> dict:
    """Phase 24's checks on the ranks' results: per wave case every
    stream equals phase 5's in-process result, every rank ends in rank
    0's state with launches = its steps x the per-step counts; the fault
    cases as their scripts say, with every rank's fault log rank 0's."""
    n_fc = tds.kernel_census(TDS_CONFIG)["fc"]
    counts = {}
    cases = {}
    for (spec, int8), wave in zip(SERVE_MESH_CASES, waves):
        key = f"{spec} {'int8' if int8 else 'fp32'}"
        want = results[int8]
        mine = [o[key] for o in outs if key in o]
        lead = mine[0]
        for i, (r, w) in enumerate(zip(wave["wave"], want)):
            check_mesh_wire(f"serve mesh {key} utt {i}", r["final"], w, int8)
        if int8:
            # the control: the same mesh's fp32 wave, held to the int8
            # limit against phase 5's int8 results, must miss it
            fp32 = waves[SERVE_MESH_CASES.index((spec, False))]["wave"]
            misses = [mesh_wire_miss(r["final"], w, True)
                      for r, w in zip(fp32, want)]
            print(f"[serve mesh {key}] score gaps over |score|, utt 0-"
                  f"{len(want) - 1}: over the wire "
                  f"{rel_score_gaps(wave['wave'], want)}; control, the "
                  f"{spec} fp32 wave: {rel_score_gaps(fp32, want)} (limit "
                  f"{INT8_SCORE_RTOL:.0e}; misses at utt "
                  f"{[i for i, m in enumerate(misses) if m]})", flush=True)
            if not any(misses):
                fail(f"serve mesh {key}: the control, the fp32 wave over "
                     f"the wire, met the int8 check against phase 5's int8 "
                     f"results: the check cannot tell the programs apart")
        for r, o in enumerate(mine):
            for k in ("n_steps", "slot_steps", "digest", "fault_log"):
                if o[k] != lead[k]:
                    fail(f"serve mesh {key}: rank {r}'s {k} {o[k]} != rank "
                         f"0's {lead[k]}")
            if r and o["follow"]["messages"] != lead["stream"]["messages"]:
                fail(f"serve mesh {key}: rank {r} replayed "
                     f"{o['follow']['messages']} messages of "
                     f"{lead['stream']['messages']}")
            n = len(o["steps"])
            expect = {name: 0 for name in o["counts"]}
            expect.update({"logmel": n, "tds_conv": 18 * n,
                           "layernorm": 15 * n,
                           "hypothesis_unit": sum(w for _, _, w in o["steps"]),
                           "int8_matmul": n_fc * n if int8 else 0})
            if o["counts"] != expect or not n:
                fail(f"serve mesh {key} rank {r}: launches {o['counts']} "
                     f"!= expected {expect}")
            for name, c in o["counts"].items():
                counts[name] = counts.get(name, 0) + c
        cases[key] = dict({k: v for k, v in wave.items() if k != "wave"},
                          score_gaps=[abs(r["final"]["score"] - w["score"])
                                      for r, w in zip(wave["wave"], want)],
                          ranks=len(mine), n_steps=lead["n_steps"],
                          stream=lead["stream"], case_s=lead["case_s"],
                          counts_by_rank=[o["counts"] for o in mine])
    demo = {}
    for name in SM_SCRIPTS:
        key = f"demo {name}"
        mine = [o[key] for o in outs if key in o]
        lead = mine[0]
        for r, o in enumerate(mine[1:], 1):
            if o["fault_log"] != lead["fault_log"] or \
                    o["digest"] != lead["digest"]:
                fail(f"serve mesh {key}: rank {r}'s fault log "
                     f"{o['fault_log']} / state {o['digest']} != rank 0's "
                     f"{lead['fault_log']} / {lead['digest']}")
        demo[name] = lead
    return {"cases": cases, "demo": demo, "counts": counts}


def rank_failures(work: pathlib.Path) -> list:
    """The tracebacks of the spawned ranks that have failed so far."""
    out = []
    for path in sorted(work.glob("rank*.pkl")):
        ok, val = pickle.loads(path.read_bytes())
        if not ok:
            out.append(f"{path.stem}: {val}")
    return out


def serve_mesh_phase(dev, smi, utts, full_results, full_results8,
                     net) -> dict:
    """Phase 24 (see the module docstring): MESH_WORLD ranks spawned on
    the card (gloo over CUDA tensors for the step, host tensors for the
    command channel; a file:// rendezvous under build/chip_smoke/), the
    kernel library built before they start.  Within
    SERVE_MESH_PHASE_LIMIT_S.  `net`: phase 16's result, None when the
    phase runs alone (--only-phase 24)."""
    import multiprocessing as mp
    t_phase = time.perf_counter()
    demo = asr_demo_system()
    clean = demo_results(dev, demo, [SyntheticASR(demo[1]).utterance(u)[
        "audio"] for u in range(4)], KernelPolicy("kernel"))
    work = SERVE_MESH_DIR
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    init = f"file://{work / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=serve_mesh_rank,
                         args=(r, MESH_WORLD, init, str(work)))
             for r in range(MESH_WORLD)]
    for p in procs:
        p.start()
    deadline = t_phase + SERVE_MESH_PHASE_LIMIT_S
    chunk = make_step_plan(TDS_CONFIG, FEATURE_CONFIG, 80.0,
                           DECODER_CONFIG.beam_size).samples_per_step
    waves = []
    try:
        for k, (spec, int8) in enumerate(SERVE_MESH_CASES):
            port = work / f"wave{k}.port"
            while not port.exists():
                failed = rank_failures(work)
                if failed or any(p.exitcode not in (None, 0)
                                 for p in procs) or \
                        time.perf_counter() > deadline:
                    fail(f"serve mesh: rank 0 served no case {spec} (exit "
                         f"codes {[p.exitcode for p in procs]}):\n"
                         + "\n".join(failed))
                time.sleep(0.05)
            waves.append(serve_mesh_wave(int(port.read_text()), utts, chunk))
            (work / f"wave{k}.stop").write_text("")
        while any(p.is_alive() for p in procs) and \
                time.perf_counter() < deadline:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    outs = []
    for r, p in enumerate(procs):
        path = work / f"rank{r}.pkl"
        if not path.exists():
            fail(f"serve mesh: rank {r} wrote no result (exit code "
                 f"{p.exitcode}; killed at the phase's limit of "
                 f"{SERVE_MESH_PHASE_LIMIT_S} s if still running)")
        ok, val = pickle.loads(path.read_bytes())
        if not ok:
            fail(f"serve mesh: rank {r} failed:\n{val}")
        outs.append(val)
    ranks_s = time.perf_counter() - t_phase
    res = serve_mesh_checks(outs, waves, {False: full_results,
                                          True: full_results8})
    net16 = "not run" if net is None else f"{net['wire_x_realtime']:.3f}x"
    for key, c in res["cases"].items():
        label = shared_card_label(c["ranks"], smi)
        print(f"[serve mesh {key}] 8 full-width streams over the wire, "
              f"every one equal to phase 5's (scores at most "
              f"{max(c['score_gaps']):.3e} apart); {c['n_steps']} steps on every "
              f"rank, launches equal to steps x the per-step counts on "
              f"every rank: {c['counts_by_rank'][0]}; {label}: first-result "
              f"p50 {c['first_result_ms']['p50']:.3f} ms, p99 "
              f"{c['first_result_ms']['p99']:.3f} ms; finalize p50 "
              f"{c['finalize_ms']['p50']:.3f} ms, p99 "
              f"{c['finalize_ms']['p99']:.3f} ms; "
              f"{c['wire_x_realtime']:.3f}x realtime over the wire "
              f"({c['audio_s']:.2f} s of audio in {c['wall_s']:.3f} s; "
              f"phase 16, one rank: {net16}); command "
              f"stream: {c['wave_messages']} messages, {c['wave_commands']} "
              f"commands, {c['wave_bytes']} bytes over the wave "
              f"({c['wave_messages'] / len(utts):.2f} messages, "
              f"{c['wave_bytes'] / len(utts):.0f} bytes a stream; rank 0 "
              f"{c['wave_send_s'] * 1e3 / max(c['wave_messages'], 1):.3f} ms "
              f"a message in its sends), {c['stream']['keepalives']} "
              f"keep-alives in the case", flush=True)
    d = res["demo"]
    bad = d["raise"]["finals"][NET_POISON_SID]
    if not (bad.get("faulted") and "poisoned session" in bad.get("error", "")):
        fail(f"serve mesh raise: the poisoned stream ended with {bad}")
    for i, r in enumerate(d["raise"]["finals"]):
        if i != NET_POISON_SID:
            check_mesh_wire(f"serve mesh raise: utt {i}", r, clean[i])
    if d["raise"]["healthz"] != 200 or \
            [e["sid"] for e in d["raise"]["fault_log"]] != [NET_POISON_SID]:
        fail(f"serve mesh raise: /healthz {d['raise']['healthz']}, fault "
             f"log {d['raise']['fault_log']}")
    dl = d["deadline"]
    if not (dl["error"].get("faulted")
            and "session_deadline" in dl["error"].get("error", "")) or \
            [(e["sid"], e["deadline"]) for e in dl["fault_log"]] != [(0, True)]:
        fail(f"serve mesh deadline: {dl['error']}, fault log "
             f"{dl['fault_log']}")
    check_mesh_wire("serve mesh deadline: the streaming client",
                    dl["streamed"], clean[1])
    wd = d["watchdog"]
    if wd["wedged_healthz"] != 503 or wd["healthz"] != 200 or \
            wd["restarts"] != 1 or [e["reason"].split(":")[0]
                                    for e in wd["fault_log"]] != [
                                        "pool quarantined"]:
        fail(f"serve mesh watchdog: /healthz {wd['wedged_healthz']} then "
             f"{wd['healthz']}, {wd['restarts']} restarts, fault log "
             f"{wd['fault_log']}")
    check_mesh_wire("serve mesh watchdog: warm stream", wd["warm"], clean[0])
    check_mesh_wire("serve mesh watchdog: fresh stream", wd["fresh"],
                    clean[2])
    for i, r in enumerate(d["drain"]["finals"]):
        check_mesh_wire(f"serve mesh drain: utt {i}", r, clean[i])
    print(f"[serve mesh faults] on the demo system at {SERVE_MESH_DEMO}: an "
          f"asr_step raise on sid {NET_POISON_SID} faulted that stream "
          f"alone; a stalled client was reaped after "
          f"{dl['reap_s']:.3f} s (deadline {SERVE_MESH_DEADLINE_S} s, rank "
          f"0's clock); a pump stall gave /healthz 503, then 200 after 1 "
          f"restart; drain under load returned {len(d['drain']['finals'])} "
          f"results; every rank's fault log equals rank 0's: "
          + "; ".join(f"{n}: {d[n]['fault_log']}" for n in SM_SCRIPTS),
          flush=True)
    launcher = serve_mesh_launcher()
    print(f"[serve mesh launcher] torchrun --nproc-per-node 2 ... --serve "
          f"--mesh 2 up in {launcher['up_s']:.2f} s; /asr "
          f"{launcher['asr_steps']} steps, /lm {launcher['lm_tokens']} "
          f"tokens, {launcher['messages']} command messages; SIGTERM to "
          f"each rank drained it, torchrun rc {launcher['rc']} "
          f"({launcher['wall_s']:.2f} s)", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[serve mesh] phase 24 took {phase_s:.2f} s (ranks {ranks_s:.2f} "
          f"s; limit {SERVE_MESH_PHASE_LIMIT_S:.0f} s); launches over every "
          f"rank and case {res['counts']}", flush=True)
    if phase_s > SERVE_MESH_PHASE_LIMIT_S:
        fail(f"serve mesh phase took {phase_s:.1f} s, more than "
             f"{SERVE_MESH_PHASE_LIMIT_S} s")
    return {"cases": res["cases"], "counts": res["counts"],
            "faults": {n: {k: v for k, v in d[n].items()
                           if k not in ("finals",)} for n in SM_SCRIPTS},
            "launcher": launcher, "phase_s": phase_s, "card": smi}


# ---------------------------------------------------------------------------
# 25. training on the mesh: launch.train --mesh on ranks sharing the card,
# and the gradients at 4 layers in fp32 against the one-device port's
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def timed_train_steps(times: list):
    """Wrap the step `launch.train` builds so that each call is timed to
    a synchronize (the launcher's own loop does not wait for the card)."""
    orig = train.make_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    train.make_train_step = make
    try:
        yield times
    finally:
        train.make_train_step = orig


def train_mesh_args(steps_n: int = TRAIN_MESH_STEPS, lr: float = 3e-4):
    return ["--arch", LM_ARCH, "--batch", str(TRAIN_MESH_BATCH), "--seq",
            str(TRAIN_MESH_SEQ), "--steps", str(steps_n), "--lr", str(lr),
            "--log-every", "1"]


class Fp64Mode(torch.overrides.TorchFunctionMode):
    """Every fp32 that the program asks for becomes fp64: `Tensor.float()`
    gives fp64, and torch.float32 in any argument (`.to(...)`,
    `dtype=`, `promote_types`) becomes torch.float64.  On fp64
    parameters the fp32 program then runs in fp64: phase 25's floor.
    `seen` maps the dtype of each floating tensor that an op returned
    to the first such op, so a caller can check that nothing ran
    narrower."""

    def __init__(self):
        super().__init__()
        self.seen = {}

    @staticmethod
    def _wide(v):
        if v is torch.float32:
            return torch.float64
        if isinstance(v, (tuple, list)):
            return type(v)(Fp64Mode._wide(u) for u in v)
        return v

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.float:
            out = args[0].double()
        else:
            out = func(*self._wide(tuple(args)),
                       **{k: self._wide(v) for k, v in kwargs.items()})
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.seen.setdefault(t.dtype, getattr(func, "__name__",
                                                      str(func)))
        return out


def fp64_grads(lm, params, batch):
    """(loss, gradients) of `lm.loss_fn` on `params` made fp64, its
    forward in `Fp64Mode` with nothing recomputed (`torch.utils
    .checkpoint` replaced by a plain call: the mode is off while
    `autograd.grad` runs, so a recompute would run in fp32; the
    backward runs on the saved fp64 tensors); fails if any op returned
    a floating tensor narrower than fp64."""
    from repro_torch.models import transformer
    p64 = tree_map(lambda t: t.double(), params)
    mode = Fp64Mode()
    saved = transformer.checkpoint
    transformer.checkpoint = lambda fn, *a, use_reentrant=False: fn(*a)
    try:
        with mode:
            (loss, _), grads = value_and_grad(
                lambda p: lm.loss_fn(p, batch), p64, has_aux=True)
    finally:
        transformer.checkpoint = saved
    if set(mode.seen) != {torch.float64}:
        fail(f"train mesh: the fp64 floor ran ops in {mode.seen}")
    return float(loss), grads


def card_grad_gaps(got, want) -> dict:
    """`grad_gaps` of two gradient trees both on the card."""
    w = dict(leaves_with_paths(want))
    return {"/".join(map(str, path)): float(
        (g.float() - w[path].float()).abs().max()
        / max(float(w[path].abs().max()), 1e-30))
        for path, g in leaves_with_paths(got)}


def train_mesh_grads(dev, arch: str, mesh, rank: int) -> dict:
    """(b) of phase 25 for one (arch, mesh) on this rank: `LM.loss_fn`
    under the mesh at TRAIN_MESH_LAYERS layers in fp32 on the rank's
    blocks (`init_local`, seed SEED) and rows of one SyntheticLM batch,
    its gradients completed (`sharding.complete_grads`) and gathered
    whole, the clip's norm from the blocks (`adamw._global_sq`); rank 0
    then computes the one-device loss and gradients on the whole tree
    and compares (the others wait at a barrier)."""
    cfg = replace(get_config(arch), n_layers=TRAIN_MESH_LAYERS,
                  dtype="float32")
    lm = steps.build_lm(cfg, mesh, PLAIN)
    specs = lm.param_specs(False)
    o_specs = steps.opt_specs(lm, adamw.AdamWConfig())
    shape = ShapeSpec("train", TRAIN_MESH_NUM_SEQ, TRAIN_MESH_BATCH, "train")
    layout = lm.layout(shape, int8=False)
    whole_b = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(cfg.vocab_size, TRAIN_MESH_NUM_SEQ,
                   TRAIN_MESH_BATCH)).batch(0).items()}
    bspec = shlib.batch_shardings(whole_b, mesh)
    batch = {k: shlib.local_block(v, bspec[k], mesh).contiguous()
             for k, v in whole_b.items()}
    params = lm.init_local(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (loss, met), grads = value_and_grad(
        lambda p: lm.loss_fn(p, batch, layout=layout), params, has_aux=True)
    grads = shlib.complete_grads(grads, specs, mesh, layout["bl"])
    paths = [path for path, _ in leaves_with_paths(params)]
    gnorm = float(torch.sqrt(adamw._global_sq(grads, paths, o_specs, mesh)))
    torch.cuda.synchronize()
    grad_ms = (time.perf_counter() - t0) * 1e3
    whole = tree_map(lambda t, sp: shlib.gather_dims(t, sp, mesh), grads,
                     specs)
    del params, grads
    out = {"loss": float(loss), "ntok": int(met["ntok"]), "gnorm": gnorm,
           "grad_ms": grad_ms}
    if rank == 0:
        one = LM(cfg, PLAIN)
        p1 = one.init(torch.Generator(device=dev).manual_seed(SEED))
        (l1, _), g1 = value_and_grad(lambda p: one.loss_fn(p, whole_b), p1,
                                     has_aux=True)
        # the floor: the one device's and the mesh's fp32 gradients, each
        # against the same program in fp64
        l64, g64 = fp64_grads(one, p1, whole_b)
        del p1
        floor = card_grad_gaps(g1, g64)
        mesh64 = card_grad_gaps(whole, g64)
        gaps = card_grad_gaps(whole, g1)
        g1n = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for _, g in leaves_with_paths(g1))))
        doubled = dict(whole, final_norm={
            k: 2 * v for k, v in whole["final_norm"].items()})
        control = card_grad_gaps(doubled, g1)["final_norm/scale"]
        control64 = card_grad_gaps(doubled, g64)["final_norm/scale"]
        worst = max(gaps, key=gaps.get)
        out.update(loss_one=float(l1), gnorm_one=g1n,
                   gnorm_rel=abs(gnorm - g1n) / g1n, grad_worst=gaps[worst],
                   grad_worst_leaf=worst,
                   grad_median=float(np.median(list(gaps.values()))),
                   control=control, leaves=len(gaps), loss_fp64=l64,
                   one_fp64=max(floor.values()),
                   one_fp64_leaf=max(floor, key=floor.get),
                   mesh_fp64=max(mesh64.values()),
                   mesh_fp64_leaf=max(mesh64, key=mesh64.get),
                   floor_at_worst=floor[worst], mesh_fp64_at_worst=mesh64[
                       worst], control_fp64=control64)
        del g1, g64
    del whole
    gc.collect()
    torch.cuda.empty_cache()
    torch.distributed.barrier()
    return out


def train_mesh_rank(rank, world, init, out_dir, spec):
    """One rank of phase 25's world of `world` ranks (a spawned process)
    on the card: (a) `launch.train.main` on the mesh `spec` at full
    width (its losses, each step's synchronized time, the collectives by
    kind and bytes, the peak memory), then (b) each arch of
    TRAIN_MESH_NUMERICS[spec].  Writes (ok, results or traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    res = None
    try:
        dev = meshlib.init_ranks(None, init_method=init, rank=rank,
                                 world_size=world,
                                 timeout_s=TRAIN_MESH_TIMEOUT_S)
        fp32_numerics()
        out = {"device": str(dev)}
        model = int(spec.split("x")[1])
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with timed_train_steps([]) as times, \
                counting_lm_collectives() as coll:
            losses = train.main(train_mesh_args() + [
                "--mesh", "local", "--model-parallel", str(model)])
        out["launcher"] = {
            "losses": losses, "step_ms": list(times),
            "wall_s": time.perf_counter() - t0,
            "collectives": {k: (n / TRAIN_MESH_STEPS, b / TRAIN_MESH_STEPS)
                            for k, (n, b) in coll.items()},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        gc.collect()
        torch.cuda.empty_cache()
        mesh = meshlib.make_local_mesh(model=model)
        for arch in TRAIN_MESH_NUMERICS[spec]:
            out[arch] = train_mesh_grads(dev, arch, mesh, rank)
        out["launches"] = ops.launch_counts()
        res = (True, out)
    except BaseException:          # reported to the parent, which fails
        import traceback
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def spawn_ranks(target, world: int, work: pathlib.Path, deadline: float,
                tag: str, limit: float, *extra) -> list:
    """Spawn `world` ranks of `target(rank, world, init, work, *extra)` on
    the card and return their results in rank order; fails on any
    rank's error or at the deadline (the ranks still running are
    killed)."""
    import multiprocessing as mp
    init = f"file://{work / 'rendezvous'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(k, world, init, str(work)) + extra)
             for k in range(world)]
    for p in procs:
        p.start()
    while any(p.is_alive() for p in procs) and time.perf_counter() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.5)
    time.sleep(1.0)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(30)
    outs = []
    for k, p in enumerate(procs):
        path = work / f"rank{k}.pkl"
        if not path.exists():
            fail(f"{tag}: rank {k} wrote no result (exit code {p.exitcode}; "
                 f"killed at the phase's limit of {limit} s if still "
                 f"running)")
        ok, val = pickle.loads(path.read_bytes())
        if not ok:
            fail(f"{tag}: rank {k} failed:\n{val}")
        outs.append(val)
    return outs


def train_mesh_world(spec: str, deadline: float) -> list:
    """Spawn the ranks of mesh `spec` on the card and return their results
    in rank order; fails on any rank's error or at the deadline."""
    r, m = (int(v) for v in spec.split("x"))
    work = TRAIN_MESH_DIR / spec
    work.mkdir(parents=True)
    return spawn_ranks(train_mesh_rank, r * m, work, deadline,
                       f"train mesh {spec}", TRAIN_MESH_PHASE_LIMIT_S, spec)


def train_mesh_phase(dev, smi) -> dict:
    """Phase 25 (see TRAIN_MESH_*): the one-device launcher and its
    control in this process, then a world of ranks on the card for each
    mesh of TRAIN_MESH_MESHES; every check made here on the ranks'
    results; within TRAIN_MESH_PHASE_LIMIT_S."""
    t_phase = time.perf_counter()
    deadline = t_phase + TRAIN_MESH_PHASE_LIMIT_S
    shutil.rmtree(TRAIN_MESH_DIR, ignore_errors=True)
    TRAIN_MESH_DIR.mkdir(parents=True)
    one = {}
    for tag, lr in (("one device", 3e-4), ("control (lr / 2)", 1.5e-4)):
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        t0 = time.perf_counter()
        with timed_train_steps(times):
            losses = train.main(train_mesh_args(lr=lr) + ["--device",
                                                          str(dev)])
        one[tag] = {"losses": losses, "step_ms": times,
                    "wall_s": time.perf_counter() - t0,
                    "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train mesh] {LM_ARCH} full width, {tag}: losses {losses}; "
              f"steps {[round(t, 1) for t in times]} ms (synchronized); "
              f"peak {one[tag]['peak_gb']:.2f} GB", flush=True)
    base = one["one device"]["losses"]
    control = max(abs(a - b) / abs(b) for a, b in zip(
        one["control (lr / 2)"]["losses"][1:], base[1:]))
    if not control > TRAIN_MESH_LOSS_RTOL:
        fail(f"train mesh: the control (half the learning rate) moves the "
             f"second loss by {control:.3e} of it, within the limit "
             f"{TRAIN_MESH_LOSS_RTOL}: the limit cannot tell a wrong update")
    meshes, launches = {}, {}
    for spec in TRAIN_MESH_MESHES:
        outs = train_mesh_world(spec, deadline)
        label = shared_card_label(len(outs), smi)
        for r, o in enumerate(outs):
            launches = {k: launches.get(k, 0) + v
                        for k, v in o["launches"].items()}
            if o["launcher"]["losses"] != outs[0]["launcher"]["losses"]:
                fail(f"train mesh {spec}: rank {r}'s losses "
                     f"{o['launcher']['losses']} != rank 0's")
        la = outs[0]["launcher"]
        gap = max(abs(a - b) / abs(b) for a, b in zip(la["losses"], base))
        print(f"[train mesh {spec}] {LM_ARCH} full width through "
              f"launch.train --mesh local: losses {la['losses']} against "
              f"the one device's {base}: max relative gap {gap:.3e} (limit "
              f"{TRAIN_MESH_LOSS_RTOL}; control {control:.3e}); steps "
              f"{[round(t, 1) for t in la['step_ms']]} ms (synchronized, "
              f"one device "
              f"{[round(t, 1) for t in one['one device']['step_ms']]} ms); "
              f"collectives a step on rank 0 (calls, bytes put in) "
              f"{la['collectives']}; peak memory per rank "
              f"{[round(o['launcher']['peak_gb'], 2) for o in outs]} GB "
              f"({label})", flush=True)
        if not (len(la["losses"]) == TRAIN_MESH_STEPS and gap
                <= TRAIN_MESH_LOSS_RTOL and np.isfinite(la["losses"]).all()):
            fail(f"train mesh {spec}: losses {la['losses']} against the one "
                 f"device's {base} (limit {TRAIN_MESH_LOSS_RTOL})")
        num = {}
        for arch in TRAIN_MESH_NUMERICS[spec]:
            g = outs[0][arch]
            num[arch] = g
            print(f"[train mesh {spec}] {arch} at {TRAIN_MESH_LAYERS} layers "
                  f"fp32, (B, S) = ({TRAIN_MESH_BATCH}, "
                  f"{TRAIN_MESH_NUM_SEQ}): loss {g['loss']:.6f} (one device "
                  f"{g['loss_one']:.6f}); gradients over {g['leaves']} "
                  f"leaves, gathered whole: worst max|err| / max|g| "
                  f"{g['grad_worst']:.3e} at {g['grad_worst_leaf']}, median "
                  f"{g['grad_median']:.3e} (limit {TRAIN_MESH_GRAD_RTOL}); "
                  f"the clip's norm {g['gnorm']:.6f} vs {g['gnorm_one']:.6f} "
                  f"(relative {g['gnorm_rel']:.3e}); control (final_norm's "
                  f"gradient doubled) {g['control']:.3e}; loss and gradients "
                  f"{g['grad_ms']:.1f} ms on the mesh ({label})", flush=True)
            print(f"[train mesh {spec}] {arch} floor, each fp32 gradient "
                  f"against the one device's fp64 (loss "
                  f"{g['loss_fp64']:.9f}): the one device's worst "
                  f"{g['one_fp64']:.3e} at {g['one_fp64_leaf']}, the "
                  f"mesh's worst {g['mesh_fp64']:.3e} at "
                  f"{g['mesh_fp64_leaf']}; at {g['grad_worst_leaf']} the "
                  f"one device {g['floor_at_worst']:.3e}, the mesh "
                  f"{g['mesh_fp64_at_worst']:.3e}; the mesh's worst within "
                  f"{TRAIN_MESH_FLOOR_RATIO}x the one device's; control "
                  f"(final_norm's gradient doubled) {g['control_fp64']:.3e}",
                  flush=True)
            if not (g["grad_worst"] <= TRAIN_MESH_GRAD_RTOL
                    and g["gnorm_rel"] <= TRAIN_MESH_GRAD_RTOL
                    and abs(g["loss"] - g["loss_one"]) <= LM_LOSS_RTOL
                    * abs(g["loss_one"])):
                fail(f"train mesh {spec} {arch}: the mesh's loss or "
                     f"gradients are off: {g}")
            if not g["control"] > TRAIN_MESH_GRAD_RTOL:
                fail(f"train mesh {spec} {arch}: the doubled leaf's control "
                     f"passes the check ({g['control']:.3e})")
            if not g["mesh_fp64"] <= TRAIN_MESH_FLOOR_RATIO * g["one_fp64"]:
                fail(f"train mesh {spec} {arch}: the mesh's gradients sit "
                     f"{g['mesh_fp64']:.3e} of max |g| from fp64, more than "
                     f"{TRAIN_MESH_FLOOR_RATIO}x the one device's "
                     f"{g['one_fp64']:.3e}: not the fp32 floor")
            if not g["control_fp64"] > TRAIN_MESH_FLOOR_RATIO * g["one_fp64"]:
                fail(f"train mesh {spec} {arch}: the doubled leaf's control "
                     f"passes the floor check ({g['control_fp64']:.3e})")
        meshes[spec] = {"label": label, "launcher": [o["launcher"]
                                                     for o in outs],
                        "numerics": num}
    if any(launches.values()):
        fail(f"train mesh: the phase launched kernels {launches}")
    phase_s = time.perf_counter() - t_phase
    print(f"[train mesh] phase 25 took {phase_s:.2f} s (limit "
          f"{TRAIN_MESH_PHASE_LIMIT_S:.0f} s); no kernel launched (plain "
          f"paths: no kernel has a backward) ({smi})", flush=True)
    if phase_s > TRAIN_MESH_PHASE_LIMIT_S:
        fail(f"train mesh phase took {phase_s:.1f} s, more than "
             f"{TRAIN_MESH_PHASE_LIMIT_S} s")
    return {"one_device": one, "control_gap": control, "meshes": meshes,
            "phase_s": phase_s}


# ---------------------------------------------------------------------------
# phase 26: elastic restart, compressed_psum and the pipeline on the mesh
# ---------------------------------------------------------------------------
def elastic_cfg():
    return replace(get_config(LM_ARCH), n_layers=ELASTIC_LAYERS,
                   dtype="float32")


def elastic_state(dev, cfg, mesh, ocfg, seed=SEED):
    """(lm, this rank's blocks of a fresh training state, its spec tree)."""
    lm = steps.build_lm(cfg, mesh, PLAIN)
    params = lm.init_local(torch.Generator(device=dev).manual_seed(seed))
    specs = elastic.state_specs(cfg, mesh, ocfg.moment_dtype)
    return lm, {"params": params,
                "opt": adamw.init(params, ocfg, mesh=mesh, specs=specs["opt"]),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}, specs


def elastic_steps(dev, lm, mesh, state, ocfg, start, n, times):
    """`n` train steps from `start` on this rank's rows of SyntheticLM's
    batches, each timed to a synchronize; (state, losses)."""
    step = make_train_step(lm, ocfg, shape=ShapeSpec(
        "train", ELASTIC_SEQ, ELASTIC_BATCH, "train"))
    data = SyntheticLM(DataConfig(lm.cfg.vocab_size, ELASTIC_SEQ,
                                  ELASTIC_BATCH))
    b_spec = shlib.batch_shardings(
        {"x": torch.empty((ELASTIC_BATCH,), device="meta")}, mesh)["x"]
    losses = []
    for s in range(start, start + n):
        batch = {k: shlib.local_block(torch.from_numpy(v), b_spec + (None,),
                                      mesh).contiguous().to(dev)
                 for k, v in data.batch(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    return state, losses


def timed_save(ck, step, state) -> dict:
    """`ck.save` with its two halves timed: the gather to rank 0's host
    (every rank, the calling thread) and the write (rank 0's thread;
    the others wait for its outcome)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save_async(step, state)
    t1 = time.perf_counter()
    ck.wait()
    return {"gather_s": t1 - t0, "write_s": time.perf_counter() - t1}


def restored_from_disk(state, specs, mesh, d: pathlib.Path) -> bool:
    """Whether each block of `state` equals `local_block` of its leaf
    read back from `d` with numpy (every rank reads the file itself)."""
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    same = True
    for path, blk in leaves_with_paths(state):
        with warnings.catch_warnings():   # a read-only map: nothing writes
            warnings.simplefilter("ignore", UserWarning)
            whole = torch.from_numpy(np.load(d / manifest["/".join(
                map(str, path))]["file"], mmap_mode="r"))
        spec = specs
        for k in path:
            spec = spec[k]
        same &= bool(torch.equal(blk.cpu(), shlib.local_block(whole, spec,
                                                              mesh)))
    return same


def elastic_runs(dev, rank, meshes, work: pathlib.Path) -> dict:
    """(a) on this rank: the straight run on 2x2 (every rank), saved twice;
    then ranks 0-1 resume it on 1x2 (and the control) while ranks 2-3 run
    straight on their own 1x2.  Each run's final parameters are saved
    whole for the parent to compare."""
    cfg, ocfg = elastic_cfg(), adamw.AdamWConfig(lr=3e-4)
    out = {"step_ms": {}, "save": {}}
    mesh = meshes["2x2"]
    lm, state, specs = elastic_state(dev, cfg, mesh, ocfg)
    ck = Checkpointer(work / "saved", mesh=mesh, specs=specs)
    times, losses = out["step_ms"].setdefault("2x2", []), []
    for s in range(ELASTIC_STEPS):
        state, ls = elastic_steps(dev, lm, mesh, state, ocfg, s, 1, times)
        losses += ls
        if s + 1 in (ELASTIC_CONTROL, ELASTIC_SAVED):
            out["save"][f"2x2 step {s + 1}"] = timed_save(ck, s + 1, state)
    out["straight 2x2"] = losses
    Checkpointer(work / "straight_2x2", mesh=mesh,
                 specs={"params": specs["params"]}).save(
        ELASTIC_STEPS, {"params": state["params"]})
    del state
    gc.collect()
    torch.cuda.empty_cache()
    mesh = meshes["1x2"]
    rest = ELASTIC_STEPS - ELASTIC_SAVED
    if rank < 2:
        lm, tmpl, specs = elastic_state(dev, cfg, mesh, ocfg, seed=SEED + 1)
        for name, saved in (("resumed", ELASTIC_SAVED),
                            ("control", ELASTIC_CONTROL)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = elastic.replace_state(cfg, Checkpointer(work / "saved"),
                                          tmpl, mesh, step=saved)
            torch.cuda.synchronize()
            out[f"restore_s {name}"] = time.perf_counter() - t0
            out[f"from disk {name}"] = restored_from_disk(
                state, specs, mesh, work / "saved" / f"step_{saved:09d}")
            state, ls = elastic_steps(dev, lm, mesh, state, ocfg,
                                      ELASTIC_SAVED, rest,
                                      out["step_ms"].setdefault(name, []))
            out[name] = ls
            out["save"][name] = timed_save(Checkpointer(
                work / name, mesh=mesh, specs={"params": specs["params"]}),
                ELASTIC_STEPS, {"params": state["params"]})
            del state
    else:
        lm, state, specs = elastic_state(dev, cfg, mesh, ocfg)
        state, out["straight 1x2"] = elastic_steps(
            dev, lm, mesh, state, ocfg, 0, ELASTIC_STEPS,
            out["step_ms"].setdefault("1x2", []))
        Checkpointer(work / "straight_1x2", mesh=mesh,
                     specs={"params": specs["params"]}).save(
            ELASTIC_STEPS, {"params": state["params"]})
        del state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def int8_round_trip(dev, mesh, work: pathlib.Path) -> dict:
    """(a) on ranks 0-1: a state with int8 moments after one step, saved
    on 1x2 and restored into a template of other values: every block
    bitwise, in its dtype."""
    cfg = elastic_cfg()
    ocfg = adamw.AdamWConfig(lr=3e-4, moment_dtype="int8")
    lm, state, specs = elastic_state(dev, cfg, mesh, ocfg)
    state, _ = elastic_steps(dev, lm, mesh, state, ocfg, 0, 1, [])
    ck = Checkpointer(work / "int8", mesh=mesh, specs=specs)
    save = timed_save(ck, 1, state)
    tmpl = elastic_state(dev, cfg, mesh, ocfg, seed=SEED + 1)[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = ck.restore(tmpl)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    want = dict(leaves_with_paths(state))
    same = all(torch.equal(t, want[p]) and t.dtype == want[p].dtype
               and t.device == want[p].device
               for p, t in leaves_with_paths(got))
    q = [t for p, t in leaves_with_paths(got["opt"]) if p[-1] == "q"]
    out = {"bitwise": same, "save": save, "restore_s": restore_s,
           "q_leaves": len(q), "q_nonzero": sum(int(t.count_nonzero())
                                                for t in q)}
    del state, got, tmpl
    gc.collect()
    torch.cuda.empty_cache()
    return out


def compress_runs(dev, rank, mesh) -> dict:
    """(b) on ranks 2-3 ('data' of 2): compressed_psum of seeded random
    gradients at every leaf shape of (a)'s model, timed against plain
    all-reduces of the same tree; each leaf's mean held bitwise against
    the mean of both ranks' dequantized payloads (gathered; the first
    rank checks); the EF drift of COMPRESS_ROUNDS rounds on the
    embedding."""
    ax = mesh.axis("data")
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + ax.index)
    shapes = LM(elastic_cfg()).param_shapes()
    grads = {p: torch.randn(t.shape, generator=gen, device=dev)
             for p, t in leaves_with_paths(shapes)}
    errs = {p: torch.zeros_like(g) for p, g in grads.items()}
    out = {"elements": sum(g.numel() for g in grads.values())}
    for rep in range(2):                  # the first: warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hats = {p: compress.compressed_psum(g, errs[p], ax)
                for p, g in grads.items()}
        torch.cuda.synchronize()
        out["compressed_ms"] = (time.perf_counter() - t0) * 1e3
        del hats
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for g in grads.values():
            ax.all_reduce(g.clone())
        torch.cuda.synchronize()
        out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3
    same = True
    for p, g in grads.items():
        g_hat, new_err = compress.compressed_psum(g, errs[p], ax)
        qs, err_own = compress.compress(g, errs[p])
        both = ax.all_gather(compress.decompress(qs).contiguous()[None], 0)
        same &= bool(torch.equal(g_hat, (both[0] + both[1]) / 2)
                     and torch.equal(new_err, err_own))
    out["bitwise"] = same
    g_true = grads[("embed", "w")]
    err = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(COMPRESS_ROUNDS):
        qs, err = compress.compress(g_true, err)
        acc += compress.decompress(qs)
    out["drift"] = float((acc / COMPRESS_ROUNDS - g_true).abs().max())
    out["drift_bound"] = float(g_true.abs().max()) / 127 + 1e-5
    del grads, errs, acc, err
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pipeline_run(dev, rank, mesh) -> dict:
    """(c) on every rank ('stage' of 4): pipeline_apply of tanh(h @ w)
    forward and backward (timed, the second of two runs), each stage's
    gradient gathered; the first rank runs the stages in sequence and
    compares."""
    ax = mesh.axis("stage")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    w = torch.randn(PIPE_STAGES, PIPE_D, PIPE_D, generator=gen,
                    device=dev) / math.sqrt(PIPE_D)
    x = torch.randn(PIPE_MICRO, PIPE_ROWS, PIPE_D, generator=gen, device=dev)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"])
    out = {}
    for rep in range(2):
        blk = w[rank:rank + 1].clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = pipeline.pipeline_apply(stage_fn, {"w": blk}, x, mesh)
        (g,) = torch.autograd.grad((y ** 2).sum(), [blk])
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
    g_all = ax.all_gather(g.detach(), 0)
    if ax.index == 0:
        wt = w.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = x
        for s in range(PIPE_STAGES):
            h = stage_fn({"w": wt[s]}, h)
        (gs,) = torch.autograd.grad((h ** 2).sum(), [wt])
        torch.cuda.synchronize()
        out["sequential_ms"] = (time.perf_counter() - t0) * 1e3
        out["out_rel"] = float((y.detach() - h.detach()).abs().max()
                               / h.detach().abs().max())
        out["grad_rel"] = float((g_all - gs).abs().max() / gs.abs().max())
        # the control: the last two stages' gradients swapped
        swapped = g_all[[0, 1, 3, 2]]
        out["control_rel"] = float((swapped - gs).abs().max()
                                   / gs.abs().max())
    return out


def elastic_rank(rank, world, init, out_dir):
    """One rank of phase 26's world (a spawned process) on the card: the
    meshes every rank makes alike, then (a), (a)'s int8 round trip on
    ranks 0-1 beside (b) on ranks 2-3, then (c).  Writes (ok, results or
    traceback)."""
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    torch.set_num_threads(1)
    res = None
    try:
        dev = meshlib.init_ranks(None, init_method=init, rank=rank,
                                 world_size=world,
                                 timeout_s=ELASTIC_TIMEOUT_S)
        fp32_numerics()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        # every rank makes every mesh (new_group is collective)
        names = ("data", "model")
        pair = [meshlib.make_mesh((1, 2), names, ranks=r)
                for r in ((0, 1), (2, 3))]
        meshes = {"2x2": meshlib.make_mesh((2, 2), names),
                  "1x2": pair[rank // 2],
                  "data": meshlib.make_mesh((2,), ("data",), ranks=(2, 3)),
                  "stage": meshlib.make_mesh((PIPE_STAGES,), ("stage",))}
        work = pathlib.Path(out_dir)
        t0 = time.perf_counter()
        out = {"elastic": elastic_runs(dev, rank, meshes, work)}
        out["elastic_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if rank < 2:
            out["int8"] = int8_round_trip(dev, meshes["1x2"], work)
        else:
            out["compress"] = compress_runs(dev, rank, meshes["data"])
        out["side_s"] = time.perf_counter() - t0
        torch.distributed.barrier()
        t0 = time.perf_counter()
        out["pipeline"] = pipeline_run(dev, rank, meshes["stage"])
        out["pipeline_s"] = time.perf_counter() - t0
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out["launches"] = ops.launch_counts()
        res = (True, out)
    except BaseException:          # reported to the parent, which fails
        import traceback
        res = (False, traceback.format_exc())
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)


def param_gaps(a: pathlib.Path, b: pathlib.Path) -> dict:
    """{leaf: (||a - b|| / ||b||, max |a - b| / max |b|)} of two saved
    parameter trees, read back with numpy one leaf at a time.  The first
    (L2) is the check's: Adam's first steps move an element by ~lr times
    the sign of its gradient, so a gradient within rounding of 0 can
    step the other way on another topology (2 lr apart), which the max
    shows as ~1e-2 of a leaf and the L2 norm does not, while one step
    more or less moves every element."""
    ma = json.loads((a / "manifest.json").read_text())["leaves"]
    mb = json.loads((b / "manifest.json").read_text())["leaves"]
    if sorted(ma) != sorted(mb):
        fail(f"elastic: the saved trees {a} and {b} differ in their leaves")
    out = {}
    for key in ma:
        x = np.load(a / ma[key]["file"], mmap_mode="r")
        y = np.load(b / mb[key]["file"], mmap_mode="r")
        d = np.asarray(x, np.float64) - np.asarray(y, np.float64)
        out[key] = (float(np.linalg.norm(d)) / max(float(np.linalg.norm(
            np.asarray(y, np.float64))), 1e-30),
            float(np.abs(d).max()) / max(float(np.abs(y).max()), 1e-30))
    return out


def dir_bytes(d: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def elastic_phase(dev, smi) -> dict:
    """Phase 26 (see ELASTIC_*, COMPRESS_*, PIPE_*): one world of
    ELASTIC_WORLD ranks on the card runs (a), (b) and (c); every check
    is made here on the ranks' results and on what they saved; within
    ELASTIC_PHASE_LIMIT_S (its goal: ELASTIC_PHASE_GOAL_S)."""
    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    ELASTIC_DIR.mkdir(parents=True)
    cfg = elastic_cfg()
    n_params = cfg.param_counts()["total"]
    reckoned = n_params * 4 * 3           # fp32 parameters, m and v
    label = shared_card_label(ELASTIC_WORLD, smi)
    print(f"[elastic] {LM_ARCH} at every width, {ELASTIC_LAYERS} layers "
          f"(cut from {get_config(LM_ARCH).n_layers}), fp32 with fp32 "
          f"moments: {n_params} parameters (param_counts), a checkpoint "
          f"of ~{reckoned / 1e9:.3f} GB (parameters, m, v in fp32)",
          flush=True)
    outs = spawn_ranks(elastic_rank, ELASTIC_WORLD, ELASTIC_DIR,
                       t_phase + ELASTIC_PHASE_LIMIT_S, "elastic",
                       ELASTIC_PHASE_LIMIT_S)
    launches = {}
    for o in outs:
        launches = {k: launches.get(k, 0) + v
                    for k, v in o["launches"].items()}
    if any(launches.values()):
        fail(f"elastic: the phase launched kernels {launches}")
    e0, e2 = outs[0]["elastic"], outs[2]["elastic"]
    # (a) the restores, the floor, the resumed run and its control
    for r in (0, 1):
        for name in ("resumed", "control"):
            if not outs[r]["elastic"][f"from disk {name}"]:
                fail(f"elastic: rank {r}'s {name} blocks differ from "
                     f"local_block of the leaves read back with numpy")
    saved = ELASTIC_DIR / "saved" / f"step_{ELASTIC_SAVED:09d}"
    ckpt_bytes = dir_bytes(saved)
    last = f"step_{ELASTIC_STEPS:09d}"
    s12 = ELASTIC_DIR / "straight_1x2" / last
    floor = param_gaps(ELASTIC_DIR / "straight_2x2" / last, s12)
    resumed = param_gaps(ELASTIC_DIR / "resumed" / last, s12)
    control = param_gaps(ELASTIC_DIR / "control" / last, s12)
    l12, l22 = e2["straight 1x2"][-1], e0["straight 2x2"][-1]
    lr_, lc = e0["resumed"][-1], e0["control"][-1]
    def worst(gaps, i=0):
        key = max(gaps, key=lambda k: gaps[k][i])
        return gaps[key][i], key
    floor_p, floor_at = worst(floor)
    bound_p = max(ELASTIC_FLOOR_RATIO * floor_p, ELASTIC_MIN_REL)
    floor_l = abs(l22 - l12) / abs(l12)
    bound_l = max(ELASTIC_FLOOR_RATIO * floor_l, ELASTIC_MIN_REL)
    gap_p, gap_c = worst(resumed)[0], worst(control)[0]
    maxes = {k: worst(g, 1)[0] for k, g in (("floor", floor),
                                            ("resumed", resumed),
                                            ("control", control))}
    gap_l, gap_lc = abs(lr_ - l12) / abs(l12), abs(lc - l12) / abs(l12)
    saves = e0["save"]                  # rank 0 writes every one
    print(f"[elastic] (a) 2x2 for {ELASTIC_SAVED} steps, saved, resumed on "
          f"1x2 for {ELASTIC_STEPS - ELASTIC_SAVED}: losses 2x2 "
          f"{e0['straight 2x2']}, 1x2 {e2['straight 1x2']}, resumed "
          f"{e0['resumed']}, control {e0['control']}; final loss gap to "
          f"the straight 1x2 {gap_l:.3e} relative (floor 2x2 vs 1x2 "
          f"{floor_l:.3e}, bound {bound_l:.3e}; control {gap_lc:.3e}); "
          f"worst parameter gap (||d|| / ||p|| a leaf) {gap_p:.3e} (floor "
          f"{floor_p:.3e} at {floor_at}, bound {bound_p:.3e}; control "
          f"{gap_c:.3e}); max |d| / max |p| a leaf {maxes['resumed']:.3e} "
          f"(floor {maxes['floor']:.3e}, control {maxes['control']:.3e})",
          flush=True)
    print(f"[elastic] (a) the checkpoint of step {ELASTIC_SAVED}: "
          f"{ckpt_bytes} bytes on disk (reckoned {reckoned}); gather / "
          f"write seconds "
          + "; ".join(f"{k} {v['gather_s']:.2f} / {v['write_s']:.2f}"
                      for k, v in saves.items())
          + f"; restore on 1x2 {e0['restore_s resumed']:.2f} s (control "
          f"{e0['restore_s control']:.2f}); restored blocks equal "
          f"local_block of the leaves read back with numpy on ranks 0-1; "
          f"steps (ms, synchronized) 2x2 "
          f"{[round(t, 1) for t in e0['step_ms']['2x2']]}, 1x2 "
          f"{[round(t, 1) for t in e2['step_ms']['1x2']]}, resumed "
          f"{[round(t, 1) for t in e0['step_ms']['resumed']]}; peak "
          f"memory per rank {[round(o['peak_gb'], 2) for o in outs]} GB "
          f"({label})", flush=True)
    if not (gap_p <= bound_p and gap_l <= bound_l
            and np.isfinite(e0["resumed"]).all()):
        fail(f"elastic: the resumed run is {gap_p:.3e} (parameters) and "
             f"{gap_l:.3e} (loss) from the straight 1x2 run, beyond "
             f"{ELASTIC_FLOOR_RATIO}x the topology's floor ({bound_p:.3e}, "
             f"{bound_l:.3e})")
    if not gap_c > bound_p:
        fail(f"elastic: the control (step {ELASTIC_CONTROL} resumed as step "
             f"{ELASTIC_SAVED}) passes the parameter check ({gap_c:.3e})")
    i8 = outs[0]["int8"]
    print(f"[elastic] (a) int8 moments on 1x2: save "
          f"{i8['save']['gather_s']:.2f} / {i8['save']['write_s']:.2f} s, "
          f"restore {i8['restore_s']:.2f} "
          f"s, {i8['q_leaves']} q leaves ({i8['q_nonzero']} nonzero "
          f"elements), bitwise {i8['bitwise']}", flush=True)
    if not (outs[0]["int8"]["bitwise"] and outs[1]["int8"]["bitwise"]
            and i8["q_nonzero"] > 0):
        fail(f"elastic: the int8 moments' round trip is not bitwise: "
             f"{[o['int8'] for o in outs[:2]]}")
    # (b)
    c2 = outs[2]["compress"]
    print(f"[elastic] (b) compressed_psum over 2 ranks on (a)'s gradient "
          f"shapes ({c2['elements']} elements): {c2['compressed_ms']:.1f} ms "
          f"against plain all-reduces {c2['all_reduce_ms']:.1f} ms (rank "
          f"3: {outs[3]['compress']['compressed_ms']:.1f} / "
          f"{outs[3]['compress']['all_reduce_ms']:.1f}); bitwise the mean "
          f"of the dequantized payloads: {c2['bitwise']}; EF drift over "
          f"{COMPRESS_ROUNDS} rounds on embed/w {c2['drift']:.4e} (bound "
          f"{c2['drift_bound']:.4e}) ({shared_card_label(2, smi)})",
          flush=True)
    if not (c2["bitwise"] and outs[3]["compress"]["bitwise"]):
        fail("elastic: compressed_psum differs from the mean of the "
             "dequantized payloads")
    if not all(o["compress"]["drift"] < o["compress"]["drift_bound"]
               for o in outs[2:]):
        fail(f"elastic: the EF drift exceeds the reference's bound: "
             f"{[o['compress'] for o in outs[2:]]}")
    # (c)
    pp = outs[0]["pipeline"]
    bubble = pipeline.bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    print(f"[elastic] (c) pipeline_apply, {PIPE_STAGES} stages of "
          f"tanh(h @ w) at d = {PIPE_D}, {PIPE_MICRO} microbatches of "
          f"{PIPE_ROWS} rows, fp32: output {pp['out_rel']:.3e} of max "
          f"(limit {PIPE_OUT_RTOL}), gradients {pp['grad_rel']:.3e} of max "
          f"|g| (limit {PIPE_GRAD_RTOL}; control, two stages' swapped, "
          f"{pp['control_rel']:.3e}); forward + backward "
          f"{[round(o['pipeline']['ms'], 1) for o in outs]} ms a rank, "
          f"sequential on one rank {pp['sequential_ms']:.1f} ms; bubble "
          f"fraction {bubble:.4f} ({label})", flush=True)
    if not (pp["out_rel"] <= PIPE_OUT_RTOL and pp["grad_rel"]
            <= PIPE_GRAD_RTOL):
        fail(f"elastic: the pipeline is off: {pp}")
    if not pp["control_rel"] > PIPE_GRAD_RTOL:
        fail(f"elastic: the pipeline's control passes ({pp['control_rel']})")
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[elastic] phase 26 took {phase_s:.2f} s (goal "
          f"{ELASTIC_PHASE_GOAL_S:.0f} s, limit {ELASTIC_PHASE_LIMIT_S:.0f} "
          f"s; ranks: (a) {[round(o['elastic_s'], 1) for o in outs]} s, "
          f"int8 / compress {[round(o['side_s'], 1) for o in outs]} s, "
          f"(c) {[round(o['pipeline_s'], 1) for o in outs]} s); no kernel "
          f"launched (plain paths) ({smi})", flush=True)
    if phase_s > ELASTIC_PHASE_LIMIT_S:
        fail(f"elastic phase took {phase_s:.1f} s, more than "
             f"{ELASTIC_PHASE_LIMIT_S} s")
    return {"checkpoint_bytes": ckpt_bytes, "reckoned_bytes": reckoned,
            "saves": saves, "losses": {"2x2": e0["straight 2x2"],
                                       "1x2": e2["straight 1x2"],
                                       "resumed": e0["resumed"],
                                       "control": e0["control"]},
            "gaps": {"floor": floor_p, "resumed": gap_p, "control": gap_c,
                     "floor_loss": floor_l, "resumed_loss": gap_l,
                     "control_loss": gap_lc, "max_abs": maxes},
            "restore_s": e0["restore_s resumed"],
            "step_ms": {**e0["step_ms"], "1x2": e2["step_ms"]["1x2"]},
            "int8": outs[0]["int8"], "compress": [o["compress"]
                                                  for o in outs[2:]],
            "pipeline": {"rank0": pp, "ms": [o["pipeline"]["ms"]
                                             for o in outs],
                         "bubble": bubble},
            "peak_gb": [o["peak_gb"] for o in outs], "phase_s": phase_s,
            "label": label}


# ---------------------------------------------------------------------------
# 27. the dry-run tooling's counts against measured cells on the card
# ---------------------------------------------------------------------------
def roof_args(dev, cfg, kind, B, S, mesh, meta_args):
    """Tensors on the card for a cell's arguments, checked against the
    cell's meta shapes: the rank's int8 serving blocks (`init_local`,
    seed SEED) and random tokens; a decode step's cache is the prefill's
    of the same rows; the train state's parameters are the bf16 tree
    with `adamw.init`'s fp32 moments."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)
    lm = steps.build_lm(cfg, mesh, KernelPolicy("auto"))
    if kind == "train":
        params = lm.init_local(gen, int8=False)
        opt = adamw.init(params, adamw.AdamWConfig(moment_dtype="float32"))
        args = ({"params": params, "opt": opt,
                 "step": torch.zeros((), dtype=torch.int32, device=dev)},
                {"tokens": toks, "labels": torch.roll(toks, -1, 1)})
    else:
        params = lm.init_local(gen, int8=True)
        if kind == "prefill":
            args = (params, {"tokens": toks})
        else:
            fn_p, _ = steps.build_cell(cfg, ShapeSpec("p", S, B, "prefill"),
                                       mesh, policy=KernelPolicy("auto"))
            _, cache = fn_p(params, {"tokens": toks})
            args = (params, cache, {"tokens": toks[:, -1:]})
    got = [(tuple(t.shape), t.dtype) for _, t in leaves_with_paths(args)]
    want = [(tuple(t.shape), t.dtype)
            for _, t in leaves_with_paths(meta_args)]
    if got != want:
        fail(f"roofline {kind}: the card's arguments are not build_cell's "
             f"shapes")
    return args


def roof_cell(dev, smi, cfg, kind, B, S) -> dict:
    """One cell of phase 27(a): counted on meta (`dryrun.count_cell`, the
    same 1x1 mesh and policy), then on the card: one call's launches
    against the counter's kernel ops, the median of ROOF_REPS timed calls
    after a warm-up (CUDA events), the device's busy time in one call
    (profiler), and the peak of allocated memory in one call against the
    predicted high-water mark."""
    mesh = meshlib.make_mesh((1, 1), ("data", "model"))
    shape = ShapeSpec(kind, S, B, kind)
    policy = None if kind == "train" else KernelPolicy("auto")
    rec = dryrun.count_cell(cfg, shape, mesh)
    if rec["status"] != "ok":
        fail(f"roofline {kind}: the count failed: {rec['error']}\n"
             f"{rec['traceback']}")
    fn, meta_args = steps.build_cell(cfg, shape, mesh, policy=policy)
    args = roof_args(dev, cfg, kind, B, S, mesh, meta_args)
    fn(*args)                                    # warm-up
    torch.cuda.synchronize()
    gc.collect()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    fn(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    if launched != rec["kernel_ops"]:
        fail(f"roofline {kind}: the counter's kernel ops "
             f"{rec['kernel_ops']} are not the card's launches {launched}")
    ms = host_ms(lambda: fn(*args), n=ROOF_REPS, warmup=1)
    prof = device_breakdown(lambda: fn(*args), f"roofline {kind}",
                            f"{cfg.name} {kind} (B={B}, S={S})", ms)
    r, mem = rec["roofline"], rec["memory_analysis"]
    bound = max(r["t_compute"], r["t_memory"], r["t_collective"]) * 1e3
    share = bound / ms
    busy = prof["device_busy_ms"]
    out = {"B": B, "S": S, "flops": r["flops_by_dtype"],
           "bytes": r["bytes_per_device"], "t_compute_ms": r["t_compute"] * 1e3,
           "t_memory_ms": r["t_memory"] * 1e3, "bound_ms": bound,
           "bound_by": r["bottleneck"], "ms": ms, "share": share,
           "busy_ms": busy, "busy_share": None if busy is None else busy / ms,
           "predicted_hbm_bytes": mem["total_hbm_bytes_per_device"],
           "predicted_argument_bytes": mem["argument_size_in_bytes"],
           "resident_bytes": resident, "max_allocated_bytes": peak,
           "kernel_ops": rec["kernel_ops"], "count_s": rec["count_s"]}
    flops = ", ".join(f"{k} {v:.4e}" for k, v in r["flops_by_dtype"].items()
                      if v)
    print(f"[roofline] {cfg.name} {kind} (B={B}, S={S}) 1x1: FLOPs {flops}; "
          f"bytes {r['bytes_per_device']:.4e}; t_compute "
          f"{out['t_compute_ms']:.3f} ms, t_memory {out['t_memory_ms']:.3f} "
          f"ms: bound {bound:.3f} ms by {r['bottleneck']}; measured "
          f"{ms:.3f} ms (median of {ROOF_REPS}): share {share:.4f}; device "
          f"busy {busy} ms, busy share "
          f"{'not measured' if busy is None else f'{busy / ms:.4f}'}; HBM "
          f"predicted {mem['total_hbm_bytes_per_device'] / 1e9:.3f} GB "
          f"(arguments {mem['argument_size_in_bytes'] / 1e9:.3f}) against "
          f"max allocated {peak / 1e9:.3f} GB (resident before the call "
          f"{resident / 1e9:.3f}); kernel ops = launches {launched}; "
          f"counted on meta in {rec['count_s']} s ({smi})", flush=True)
    if not share <= ROOF_SHARE_MAX:
        fail(f"roofline {kind}: the bound is {share:.3f} of the measured "
             f"time (limit {ROOF_SHARE_MAX}): the count is wrong")
    del args
    return out


def roofline_phase(dev, smi) -> dict:
    """Phase 27: (a) each ROOF_CELLS cell of ROOF_ARCH counted and
    measured (`roof_cell`); (b) ROOF_DRY dry at rank 0 and at the last
    rank (`dryrun.run_cell`): both ranks' terms and HBM printed, the last
    rank's attention operations above rank 0's.  Within
    ROOF_PHASE_LIMIT_S."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ROOF_ARCH)
    cells = {}
    for kind, B, S in ROOF_CELLS:
        cells[kind] = roof_cell(dev, smi, cfg, kind, B, S)
        gc.collect()
        torch.cuda.empty_cache()
    arch, shape, mesh = ROOF_DRY
    dry = {}
    for rank in (0, None):
        rec = dryrun.run_cell(arch, shape, mesh, rank=rank, save=False)
        if rec["status"] != "ok":
            fail(f"roofline: {arch} {shape} {mesh} rank {rank} dry: "
                 f"{rec['error']}")
        r = rec["roofline"]
        dry[rec["rank"]] = {
            "coords": rec["coords"], "t_compute": r["t_compute"],
            "t_memory": r["t_memory"], "t_collective": r["t_collective"],
            "bottleneck": r["bottleneck"],
            "attention_flops": rec["flops_by_op"].get("flash_attention", 0.0),
            "flops": r["flops_by_dtype"],
            "hbm_bytes": rec["memory_analysis"]["total_hbm_bytes_per_device"],
            "count_s": rec["count_s"]}
        d = dry[rec["rank"]]
        print(f"[roofline] {arch} {shape} {mesh} dry, rank {rec['rank']} "
              f"{rec['coords']}: t = ({d['t_compute']:.4f}, "
              f"{d['t_memory']:.4f}, {d['t_collective']:.4f}) s, bound by "
              f"{d['bottleneck']}; attention {d['attention_flops']:.4e} of "
              f"{r['flops_per_device']:.4e} operations; HBM "
              f"{d['hbm_bytes'] / 1e9:.3f} GB a rank of "
              f"{roofline.HBM_BYTES / 1e9:.0f}; counted in {d['count_s']} s "
              f"(derived from NVIDIA H100 SXM published peaks, not measured)",
              flush=True)
    first, last = dry[0], dry[max(dry)]
    if not last["attention_flops"] > first["attention_flops"]:
        fail(f"roofline: the last rank's attention "
             f"{last['attention_flops']:.4e} is not above rank 0's "
             f"{first['attention_flops']:.4e}")
    counts = {name: sum(c["kernel_ops"].get(name, 0) for c in cells.values())
              for name in ops.KERNEL_MODULES}
    phase_s = time.perf_counter() - t_phase
    print(f"[roofline] phase 27 took {phase_s:.2f} s (limit "
          f"{ROOF_PHASE_LIMIT_S:.0f} s); every share at most "
          f"{ROOF_SHARE_MAX}; kernel ops equal the launches ({smi})",
          flush=True)
    if phase_s > ROOF_PHASE_LIMIT_S:
        fail(f"roofline phase took {phase_s:.1f} s, more than "
             f"{ROOF_PHASE_LIMIT_S} s")
    return {"cells": cells, "dry": {str(k): v for k, v in dry.items()},
            "counts": counts, "phase_s": phase_s}


# ---------------------------------------------------------------------------
# 28. analysis and guards: the port's linter and kernel registry on the
# card's build, and the engines' steps under their host-sync guard
# ---------------------------------------------------------------------------
def lint_phase() -> dict:
    """28(a): the port's linter in process over src/repro_torch (0
    findings), then the half of RPL002 only a build can check: every C
    entry point of KERNEL_REGISTRY resolves in the library `_build`
    built."""
    t0 = time.perf_counter()
    findings, suppressed = lint.run_paths([str(ROOT / "src" / "repro_torch")],
                                          root=ROOT)
    lint_s = time.perf_counter() - t0
    if findings:
        fail("repro_torch.analysis over src/repro_torch: "
             + "; ".join(f.format() for f in findings))
    registry = KERNEL_REGISTRY
    handle = ctypes.CDLL(str(_build.build()))
    entries = sorted({e for meta in registry.values()
                      for e in meta["entry_points"]})
    missing = [e for e in entries if not hasattr(handle, e)]
    if missing or set(entries) != set(_build.SIGNATURES):
        fail(f"KERNEL_REGISTRY's entry points {entries}: not in the built "
             f"library {missing}; _build.SIGNATURES "
             f"{sorted(_build.SIGNATURES)}")
    print(f"[analysis] repro_torch.analysis over src/repro_torch: 0 "
          f"findings, {len(suppressed)} suppressed, {lint_s:.2f} s; "
          f"KERNEL_REGISTRY: {len(registry)} kernels, all {len(entries)} C "
          f"entry points resolve in {_build.build().name}", flush=True)
    return {"findings": 0, "suppressed": len(suppressed), "lint_s": lint_s,
            "kernels": sorted(registry), "entry_points": entries}


@contextlib.contextmanager
def engine_guard(module, active: bool, entered: list):
    """Run `module`'s engine steps under the engine's own guard
    (`active`) or with it taken out (a null context), to compare the
    same steps; `entered` counts the blocks the engine opened."""
    real = module.no_implicit_transfers

    def guard(*args, **kwargs):
        entered.append(1)
        return real(*args, **kwargs) if active else contextlib.nullcontext()
    module.no_implicit_transfers = guard
    try:
        yield
    finally:
        module.no_implicit_transfers = real


def sync_sites(fn) -> tuple:
    """Run `fn` with the sync debug mode at warn: (its result, the number
    of synchronizing calls, {"file:line in the port": count})."""
    sites = {}
    prev = torch.cuda.get_sync_debug_mode()
    show = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return show(message, category, filename, lineno, file, line)
        frames = [f for f in traceback.extract_stack()
                  if "repro_torch" in f.filename]
        where = (f"{frames[-1].filename.split('src/')[-1]}:"
                 f"{frames[-1].lineno}" if frames else f"{filename}:{lineno}")
        sites[where] = sites.get(where, 0) + 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
            warnings.showwarning = show
    return out, sum(sites.values()), sites


def guarded_or_sites(tag, fn, module):
    """`fn()` (steps under `module`'s engine guard); where the guard
    raises, the same steps again with the guard taken out, under warn
    mode, name every sync; then fail."""
    try:
        return fn()
    except RuntimeError as exc:
        if SYNC_WARNING not in str(exc):
            raise
        with engine_guard(module, False, []):
            _, n, sites = sync_sites(fn)
        fail(f"{tag}: a guarded step synchronised ({exc}); under warn mode "
             f"{n} syncs at {sites}")


def guard_asr(dev, system, utts, use_int8) -> dict:
    """28(b): GUARD_STEPS warmed steps of the full-width engine at
    GUARD_SLOTS slots, at each w of GUARD_WINDOWS, under the engine's own
    guard (error mode) and compilation_budget(0); then the same steps on
    a fresh engine with the guard taken out.  The words of every slot
    must be equal, the guard entered once a step, and the kernels of the
    path launched as a step launches them."""
    tag = f"guard asr {'int8' if use_int8 else 'fp32'}"
    slots = list(range(GUARD_SLOTS))
    counts = {name: 0 for name in ops.KERNEL_MODULES}
    out = {"steps": 0}
    for w in GUARD_WINDOWS:
        words, scores = {}, {}
        for active in (True, False):
            eng = full_engine(dev, system, KernelPolicy("auto"),
                              use_int8=use_int8)
            for s in slots:
                eng.feed_slot(s, utts[s])
            n = min(eng.slot_windows(s) for s in slots) // w - 1
            if n < GUARD_STEPS:
                fail(f"{tag}: {n + 1} steps of w={w} buffered, need "
                     f"{GUARD_STEPS + 1}")
            entered = []
            with engine_guard(asrmod, active, entered):
                guarded_or_sites(f"{tag} w={w} warm-up",        # warm-up
                                 lambda: eng._step_slots(slots, w), asrmod)
                torch.cuda.synchronize()
                ops.reset_launch_counts()

                def run():
                    with guards.compilation_budget(0, f"{tag} w={w}"):
                        for _ in range(GUARD_STEPS):
                            eng._step_slots(slots, w)
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                guarded_or_sites(f"{tag} w={w}", run, asrmod)
                ms = (time.perf_counter() - t0) * 1e3 / GUARD_STEPS
                got = ops.launch_counts()
            res = [eng.slot_best(s) for s in slots]
            words[active] = [r["words"].tolist() for r in res]
            scores[active] = [r["score"] for r in res]
            if active:
                if len(entered) != GUARD_STEPS + 1:
                    fail(f"{tag} w={w}: the engine entered its guard "
                         f"{len(entered)} times in {GUARD_STEPS + 1} steps")
                expect = {name: 0 for name in got}
                expect.update({"logmel": GUARD_STEPS,
                               "tds_conv": 18 * GUARD_STEPS,
                               "layernorm": 15 * GUARD_STEPS,
                               "hypothesis_unit": w * GUARD_STEPS,
                               "int8_matmul": 29 * GUARD_STEPS * use_int8})
                if got != expect:
                    fail(f"{tag} w={w}: launches {got} != {expect}")
                for name, c in got.items():
                    counts[name] += c
                out[f"w={w} guarded_ms"] = ms
            else:
                out[f"w={w} unguarded_ms"] = ms
            del eng
        gap = max(abs(a - b) for a, b in zip(scores[True], scores[False]))
        if words[True] != words[False]:
            fail(f"{tag} w={w}: words under the guard {words[True]} != "
                 f"without it {words[False]}")
        out["steps"] += GUARD_STEPS
        out[f"w={w} score_gap"] = gap
        print(f"[analysis] {tag} w={w}: {GUARD_STEPS} warmed steps of "
              f"{GUARD_SLOTS} slots under the engine's guard (error mode), "
              f"0 builds or loads; words equal to the unguarded steps' "
              f"(scores {gap:.3e} apart); {out[f'w={w} guarded_ms']:.3f} / "
              f"{out[f'w={w} unguarded_ms']:.3f} ms a step guarded / not "
              f"(synchronized at the end)", flush=True)
    out["counts"] = counts
    return out


def guard_lm(dev) -> dict:
    """28(c): GUARD_LM_STEPS warmed LmEngine decode steps of LM_ARCH at
    full width, bf16, GUARD_SLOTS slots, under the engine's guard and
    compilation_budget(0); then the same steps with the guard taken out,
    from the same prompts on a fresh engine: equal tokens."""
    cfg = get_config(LM_ARCH)
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    prompts = lm_prompts(GUARD_LM_PROMPTS, cfg.vocab_size, seed=SEED + 3)
    program = LmProgram(cfg, cache_len=GUARD_LM_BUCKETS[-1] + GUARD_LM_STEPS
                        + 2, max_new=GUARD_LM_STEPS + 2,
                        prefill_buckets=GUARD_LM_BUCKETS)
    tokens, out = {}, {}
    for active in (True, False):
        eng = LmEngine(EngineConfig(program, n_slots=GUARD_SLOTS,
                                    kernels=KernelPolicy("auto")),
                       params, device=dev)
        for p in prompts:
            eng.open().push(p)                  # admission: the prefills
        entered = []
        with engine_guard(lmmod, active, entered):
            guarded_or_sites("guard lm warm-up", eng._step, lmmod)
            torch.cuda.synchronize()
            ops.reset_launch_counts()

            def run():
                with guards.compilation_budget(0, "guard lm"):
                    for _ in range(GUARD_LM_STEPS):
                        eng._step()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            guarded_or_sites("guard lm", run, lmmod)
            ms = (time.perf_counter() - t0) * 1e3 / GUARD_LM_STEPS
            got = ops.launch_counts()
        tokens[active] = [list(eng._gen[s]) for s in range(GUARD_SLOTS)]
        out[f"{'guarded' if active else 'unguarded'}_ms"] = ms
        if active:
            expect = {name: 0 for name in got}
            expect["rmsnorm"] = LM_LAUNCHES[LM_ARCH][0] * GUARD_LM_STEPS
            if got != expect or len(entered) != GUARD_LM_STEPS + 1:
                fail(f"guard lm: launches {got} != {expect}, or the guard "
                     f"entered {len(entered)} times in {GUARD_LM_STEPS + 1} "
                     f"steps")
            out["counts"] = got
        del eng
    if tokens[True] != tokens[False]:
        fail(f"guard lm: tokens under the guard {tokens[True]} != without "
             f"it {tokens[False]}")
    print(f"[analysis] guard lm {cfg.name} bf16: {GUARD_LM_STEPS} warmed "
          f"decode steps of {GUARD_SLOTS} slots under the engine's guard "
          f"(error mode), 0 builds or loads; tokens equal to the unguarded "
          f"steps'; {out['guarded_ms']:.3f} / {out['unguarded_ms']:.3f} ms "
          f"a step guarded / not", flush=True)
    out["params"] = params
    out["prompts"] = prompts
    return out


def guard_controls(dev) -> list:
    """28(d): what the guard must refuse, inside it: an `.item()` on a
    CUDA tensor and a blocking upload of pageable memory."""
    x = torch.ones(4, device=dev)
    host = np.zeros((1024,), np.float32)
    raised = []
    for name, fn in ((".item() on a CUDA tensor", lambda: x.sum().item()),
                     ("a blocking upload of pageable memory",
                      lambda: torch.from_numpy(host).to(dev))):
        try:
            with guards.no_implicit_transfers():
                fn()
        except RuntimeError as exc:
            if SYNC_WARNING not in str(exc):
                raise
            raised.append(name)
        else:
            fail(f"guard control: {name} did not raise inside "
                 f"no_implicit_transfers()")
    torch.cuda.synchronize()
    print(f"[analysis] controls raised inside no_implicit_transfers(): "
          f"{raised}", flush=True)
    return raised


def sync_counts(dev, system, utts, lm_res) -> dict:
    """28(e): synchronizing calls, counted under warn mode (not failures):
    one LM prefill (a 1-row admission), one `slot_best` readout, one TDS
    training step (forward, CTC loss, backward, AdamW)."""
    cfg = get_config(LM_ARCH)
    program = LmProgram(cfg, cache_len=GUARD_LM_BUCKETS[-1] + 2, max_new=2,
                        prefill_buckets=GUARD_LM_BUCKETS)
    eng = LmEngine(EngineConfig(program, n_slots=2,
                                kernels=KernelPolicy("auto")),
                   lm_res["params"], device=dev)
    eng.open().push(lm_res["prompts"][0])              # warm-up admission
    out = {}
    sess = eng.open()
    _, out["lm prefill"], sites_p = sync_sites(
        lambda: sess.push(lm_res["prompts"][1]))
    asr = full_engine(dev, system, KernelPolicy("auto"))
    for s in range(GUARD_SLOTS):
        asr.feed_slot(s, utts[s])
    asr._step_slots(list(range(GUARD_SLOTS)), 1)
    asr.slot_best(0)
    _, out["slot_best"], sites_r = sync_sites(lambda: asr.slot_best(1))
    words = system[1]
    _, _, feats, labels = asr_train_batch(words, dev, 0, 2)
    params = tree_to(tds.init_tds(torch.Generator().manual_seed(SEED),
                                  TDS_CONFIG), dev)
    ocfg = adamw.AdamWConfig(lr=ASR_TRAIN_LR, weight_decay=0.0)
    opt = adamw.init(params, ocfg)

    def step(p, o):
        loss, g = value_and_grad(lambda q: asr_loss(q, feats, labels), p)
        return adamw.update(g, o, p, ocfg)
    params, opt = step(params, opt)                     # warm-up
    torch.cuda.synchronize()
    _, out["tds train step"], sites_t = sync_sites(lambda: step(params, opt))
    torch.cuda.synchronize()
    for what, sites in (("lm prefill", sites_p), ("slot_best", sites_r),
                        ("tds train step", sites_t)):
        print(f"[analysis] warn mode: {out[what]} synchronizing calls in "
              f"one {what}: {sites}", flush=True)
    out["sites"] = {"lm prefill": sites_p, "slot_best": sites_r,
                    "tds train step": sites_t}
    return out


def analysis_phase(dev, smi) -> dict:
    """Phase 28: (a) `lint_phase`, (b) `guard_asr` fp32 and int8, (c)
    `guard_lm`, (d) `guard_controls`, (e) `sync_counts`; within
    GUARD_PHASE_LIMIT_S."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fp32_numerics()
    out = {"lint": lint_phase()}
    system = full_width_system(dev)
    utts = full_width_utterances(system[1])
    out["asr fp32"] = guard_asr(dev, system, utts, False)
    out["asr int8"] = guard_asr(dev, system, utts, True)
    lm_res = guard_lm(dev)
    out["lm"] = {k: v for k, v in lm_res.items()
                 if k not in ("params", "prompts")}
    out["controls"] = guard_controls(dev)
    out["syncs"] = sync_counts(dev, system, utts, lm_res)
    del lm_res, system
    counts = {name: out["asr fp32"]["counts"][name]
              + out["asr int8"]["counts"][name] + out["lm"]["counts"][name]
              for name in ops.KERNEL_MODULES}
    out["counts"] = counts
    phase_s = time.perf_counter() - t_phase
    out["phase_s"] = phase_s
    print(f"[analysis] phase 28 took {phase_s:.2f} s (limit "
          f"{GUARD_PHASE_LIMIT_S:.0f} s); launches of the guarded steps "
          f"{counts} ({smi})", flush=True)
    if phase_s > GUARD_PHASE_LIMIT_S:
        fail(f"analysis phase took {phase_s:.1f} s, more than "
             f"{GUARD_PHASE_LIMIT_S} s")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", type=pathlib.Path, default=None,
                    help="a checkout of the parent commit: also time its "
                         "int8_matmul and hypothesis_unit kernels")
    ap.add_argument("--only-phase", type=int, choices=(24, 25, 26, 27, 28),
                    default=None,
                    help="build, then run this phase alone (24: after "
                         "serving phase 5's system in process for its "
                         "references), to compare two trees in one call; "
                         "prints no ok line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA device")

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    (OUT / "build_log.txt").write_text(_build.build_log)
    print(f"[build] {len(_build.sources())} sources -> {lib_path.name}: "
          f"{build_s:.2f} s ({'built' if _build.build_seconds else 'reused'})",
          flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"[build] {line.strip()}", flush=True)

    if args.only_phase == 25:
        train_mesh_phase(dev, smi)
        return
    if args.only_phase == 26:
        elastic_phase(dev, smi)
        return
    if args.only_phase == 27:
        roofline_phase(dev, smi)
        return
    if args.only_phase == 28:
        analysis_phase(dev, smi)
        return

    if args.only_phase == 24:
        system = full_width_system(dev)
        utts = full_width_utterances(system[1])
        results = [full_phase(dev, system, utts, use_int8=int8)[3]
                   for int8 in (False, True)]
        del system
        gc.collect()
        torch.cuda.empty_cache()
        serve_mesh_phase(dev, smi, utts, *results, None)
        return

    # 2. kernel checks
    errs = check_kernels(dev)

    # 3. demo system, kernel vs ref policy, fp32 and int8 programs
    demo_phase(dev)
    torch.cuda.synchronize()

    # 4. the ASRPU command shims (int8 program)
    shim_counts = shim_phase(dev)

    # 5. full width
    t0 = time.perf_counter()
    system = full_width_system(dev)
    utts = full_width_utterances(system[1])
    print(f"[full] system: TDS_CONFIG, {len(system[1])} words, "
          f"{system[2].n_nodes} trie nodes, K={system[5].beam_size}, "
          f"C={system[5].max_children}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    counts, steps, lp_err, full_results, warm_s = full_phase(dev, system,
                                                            utts)
    torch.cuda.synchronize()
    counts8, steps8, lp_err8, full_results8, _ = full_phase(
        dev, system, utts, use_int8=True)
    torch.cuda.synchronize()
    # the rows of an utterance's first step (beams filling up: many live,
    # long segments) and of its third (the beams' steady width)
    hu_first = capture_decoder_rows(dev, system, utts, advance=0)
    hu_rows = capture_decoder_rows(dev, system, utts)
    errs["hypothesis_unit"] = max(errs["hypothesis_unit"],
                                  check_hypothesis_rows(hu_first),
                                  check_hypothesis_rows(hu_rows))
    census = {"first step": row_census(hu_first),
              "third step": row_census(hu_rows)}

    # 6. timing
    before = None if args.before is None else Before(args.before)
    rows = timing_phase(dev, hu_rows=hu_rows, hu_first=hu_first,
                        before=before)
    rows11 = timing_phase(dev, 1, 1, only=("logmel", "tds_conv", "layernorm",
                                           "int8_matmul"), before=before)
    # the floor of one launch in these events: one small elementwise op
    z = torch.zeros((16, 1840), device=dev)
    floor_ms = device_ms(lambda: z.add_(1.0))
    print(f"[timing] launch floor: one elementwise launch over (16, 1840) "
          f"{floor_ms * 1e3:.2f} us in the same events", flush=True)
    torch.cuda.synchronize()
    conv_ln = {}
    for (b, w), rs in (((4, 4), rows), ((1, 1), rows11)):
        tc, ln = rs["tds_conv"], rs["layernorm"]
        conv_ln[f"b={b} w={w}"] = {
            "ms": tc["ms"] + ln["ms"],
            "conv_block_per_row_ms": tc["alt_ms"] + ln["ms"],
            "library_ms": (None if None in (tc["library_ms"],
                                            ln["library_ms"])
                           else tc["library_ms"] + ln["library_ms"]),
            "plain_ms": tc["plain_ms"] + ln["plain_ms"],
            "bound_ms": tc["bound_ms"] + ln["bound_ms"],
            "tds_conv": {k: tc[k] for k in ("ms", "alt_ms", "plain_ms",
                                             "library_ms", "bound_ms",
                                             "step_launches", "shapes")},
            "layernorm": {k: ln[k] for k in ("ms", "plain_ms", "library_ms",
                                             "bound_ms", "step_launches",
                                             "shapes")}}
        print(f"[timing b={b} w={w}] conv + LayerNorm work of one step: "
              f"{tc['step_launches']} tds_conv + {ln['step_launches']} "
              f"layernorm launches, {(tc['ms'] + ln['ms']) * 1e3:.1f} us "
              f"(tds_conv {tc['ms'] * 1e3:.1f}, layernorm "
              f"{ln['ms'] * 1e3:.1f}); conv in the block-per-row design "
              f"{tc['alt_ms'] * 1e3:.1f} us; cuDNN / F.layer_norm composite "
              f"{conv_ln[f'b={b} w={w}']['library_ms']} ms; bound "
              f"{(tc['bound_ms'] + ln['bound_ms']) * 1e3:.2f} us", flush=True)
    steps_ms = step_times(dev, system, utts)
    prof = profile_step(dev, system, utts, steps_ms["kernel b=4 w=4"])
    prof8 = profile_step(dev, system, utts, steps_ms["int8 kernel b=4 w=4"],
                         use_int8=True)
    torch.cuda.synchronize()
    del system
    torch.cuda.empty_cache()

    # 7. LM kernel checks at the three LM paths' shapes
    lm_errs = check_lm_kernels(dev)
    torch.cuda.empty_cache()

    # 8. the LM main path: full-width bf16 serving
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, window {cfg.attn_window}; "
          f"{n_params} parameters ({cfg.dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    serve = lm_serve_phase(dev, cfg, params)
    if serve["flash_by_design"]["bf16 tma"] != serve["counts"][
            "flash_attention"]:
        fail(f"{cfg.name} bf16 flash launches by design "
             f"{serve['flash_by_design']}: D = {cfg.head_dim} must run "
             f"the TMA design only")

    # 9. kernel path vs plain path
    parity = lm_parity_phase(dev, cfg, params)

    # 10. LM timing (all three paths' shapes) and profile
    lm_timing = lm_timing_phase(dev)
    lm_prof = lm_profile(serve["engine"], dev, cfg.vocab_size,
                         serve["prefill_ms"]["B=1 S=2048"],
                         serve["decode_step_ms"])
    torch.cuda.synchronize()
    lm_rows = lm_kernel_rows(lm_timing)
    del serve["engine"], params
    torch.cuda.empty_cache()

    # 11. mamba2-1.3b and 12. qwen2-moe-a2.7b served at full width in bf16
    lm2, lm2_params = {}, {}
    for arch, short, buckets, prompts in (
            (MAMBA_ARCH, "mamba", LM_BUCKETS, LM_PROMPTS),
            (MOE_ARCH, "moe", MOE_BUCKETS, MOE_PROMPTS)):
        cfg2 = get_config(arch)
        t0 = time.perf_counter()
        params2 = LM(cfg2).init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        n2 = sum(t.numel() for t in _leaves(params2))
        print(f"[{short} serve] {cfg2.name}: {cfg2.n_layers} layers "
              f"'{cfg2.layer_pattern}', d_model {cfg2.d_model}, d_ff "
              f"{cfg2.d_ff}, vocab {cfg2.vocab_size}, ssm {cfg2.ssm}, moe "
              f"{cfg2.moe}; {n2} parameters ({cfg2.dtype}) drawn on the card "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        sv = lm_serve_phase(dev, cfg2, params2, prompts, buckets,
                            tag=f"{short} serve")
        sv["profile"] = lm_profile(sv.pop("engine"), dev, cfg2.vocab_size,
                                   sv["prefill_ms"]["B=1 S=2048"],
                                   sv["decode_step_ms"], tag=f"{short} bf16")
        sv["parameters"] = n2
        lm2[arch], lm2_params[arch] = sv, params2
        torch.cuda.empty_cache()

    # 13. kernel path vs plain path for both: fp32 tokens, logits, and
    # every layer on the same input in fp32 and bf16
    for arch, short, buckets, prompts, cut, gated in (
            (MAMBA_ARCH, "mamba", LM_BUCKETS, LM_PARITY_PROMPTS, None, ()),
            (MOE_ARCH, "moe", MOE_BUCKETS, MOE_PARITY_PROMPTS,
             MOE_PARITY_LAYERS, (torch.float32,))):
        cfg2, tag = get_config(arch), f"lm2 parity {short}"
        par = lm_parity_phase(dev, cfg2, lm2_params[arch], prompts, buckets,
                              fp32_layers=cut, gated=gated, tag=tag)
        prompt = lm_prompts(prompts, cfg2.vocab_size, seed=SEED + 1)[0]
        bucket = min(b for b in buckets if b >= len(prompt))
        par["layers"] = {
            name: layer_parity(dev, cfg2, lm2_params[arch], prompt, bucket,
                               dtype, f"{tag} {name} layers")
            for name, dtype in (("fp32", torch.float32),
                                ("bf16", torch.bfloat16))}
        lm2[arch]["parity"] = par
    del lm2_params, params2      # the loop's last model: 28.7 GB in bf16
    torch.cuda.empty_cache()

    # 14. beam_prune checks; 15. the prune path and its timing
    bp_err = check_beam_prune(dev)
    bp_counts = beam_prune_phase(dev)
    bp_timing = beam_prune_timing(dev, before)

    # 16. the network front-end: phase 5's system over the wire, faults,
    # the --serve launcher
    network = network_phase(dev, smi, full_results, warm_s)

    # 17. ASR training at full width; 18. LM training at full width.  The
    # LM serving models went after phase 13, phase 5's system after phase
    # 6: the card holds nothing of them here
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated before the training phases", flush=True)
    asr_train = asr_train_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lm_train = lm_train_phase(dev)

    # 19. the LM kernels at qwen2-vl-7b's and musicgen-medium's shapes
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm3_errs = check_lm3_kernels(dev)
    lm3_timing = lm_timing_phase(dev, LM3_FLASH_TIMED, LM3_RMS_TIMED,
                                 LM3_LN_TIMED, tag="lm3 timing")
    lm3_rows = lm3_kernel_rows(lm3_timing)
    print(f"[lm3 kernels] phase 19 took {time.perf_counter() - t0:.2f} s",
          flush=True)
    # 20. qwen2-vl-7b and 21(a). musicgen-medium at full width, bf16, one
    # after the other; 21(b). int8 LM serving weights
    vlm = embed_model_phase(dev, VLM_ARCH, "vlm")
    audio = embed_model_phase(dev, AUDIO_ARCH, "audio")
    t0 = time.perf_counter()
    int8_lm = {"vlm": int8_vlm(dev, (vlm["prefill_ms"],
                                     vlm["decode_step_ms"])),
               "engine": int8_engine(dev, serve)}
    int8_lm["phase_s"] = time.perf_counter() - t0
    print(f"[int8] phase 21(b) took {int8_lm['phase_s']:.2f} s", flush=True)
    lm3_paths = {"vlm bf16": vlm["counts"], "audio bf16": audio["counts"],
                 "int8 weights": {name: int8_lm["vlm"]["counts"][name]
                                  + int8_lm["engine"]["counts"][name]
                                  for name in vlm["counts"]}}

    # 22. the sharded ASR serving step: rank groups sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phase(smi, full_results)
    # 23. the sharded LM serving cells (build_cell prefill and decode)
    gc.collect()
    torch.cuda.empty_cache()
    lm_mesh = lm_mesh_phase(dev, smi)
    # 24. the network server on the mesh: --serve --mesh, rank 0 leading
    gc.collect()
    torch.cuda.empty_cache()
    serve_mesh = serve_mesh_phase(dev, smi, utts, full_results,
                                  full_results8, network)
    # 25. training on the mesh: launch.train --mesh, gradients at 4 layers
    gc.collect()
    torch.cuda.empty_cache()
    train_mesh = train_mesh_phase(dev, smi)
    # 26. elastic restart with a sharded checkpoint, compressed_psum and
    # the pipeline, on ranks sharing the card
    gc.collect()
    torch.cuda.empty_cache()
    elastic_res = elastic_phase(dev, smi)
    # 27. the dry-run tooling's counts against measured cells on the card
    gc.collect()
    torch.cuda.empty_cache()
    roof = roofline_phase(dev, smi)
    # 28. the port's linter and registry on this build; the engines'
    # steps under their host-sync guard
    analysis = analysis_phase(dev, smi)

    kernels = []
    for name in KERNELS:
        r = rows[name]
        asr_path = "asr int8" if name == "int8_matmul" else "asr fp32"
        by_path = {asr_path: (counts8 if name == "int8_matmul"
                              else counts)[name],
                   "network": network["counts"][name],
                   "trained asr fp32": asr_train["decode_fp32"]["counts"][name],
                   "trained asr int8": asr_train["decode_int8"]["counts"][name],
                   "asr mesh (all ranks)": mesh["counts"][name],
                   "serve mesh (all ranks)": serve_mesh["counts"][name],
                   "guarded steps": analysis["counts"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces(name),
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_s"] >= r["ops_s"] else "operations",
            "library_ms": r["library_ms"],
            "work": f"the {r['step_launches']} launches of one full-width "
                    f"step at b=4, w=4 (device time)",
            "launch_inclusive_ms": r["host_ms"],
        })
        if name == "tds_conv":
            kernels[-1]["library"] = ("composite: F.conv2d (cuDNN, no TF32) "
                                      "+ ReLU + residual + F.layer_norm")
            kernels[-1]["block_per_row_ms"] = r["alt_ms"]
        if name == "layernorm":
            kernels[-1]["library"] = ("composite: F.layer_norm((y + b) + "
                                      "res); F.layer_norm for final_ln")
            by_path.update({path: c[name] for path, c in lm3_paths.items()})
            kernels[-1]["launches"] = sum(by_path.values())
            kernels[-1]["max_abs_err"] = max(errs[name], lm3_errs[name])
            kernels[-1]["max_abs_err_bf16"] = lm3_errs["layernorm bf16"]
            kernels[-1].update(lm3_rows[name])
        if r["context_ms"] is not None:
            kernels[-1]["fp32_matmul_ms"] = r["context_ms"]
        for key, val in r.items():
            if key.endswith("_ms") and key not in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "host_ms",
                    "context_ms", "alt_ms"):
                kernels[-1][key] = val
        if name == "hypothesis_unit":
            kernels[-1]["work"] = (
                f"the {r['step_launches']} launches of one b=4, w=4 step on "
                f"the rows the full-width fp32 decoder fed it (device time)")
            kernels[-1]["rows"] = {step: {"L": c["L"], "H": c["H"]}
                                   for step, c in census.items()}
        if name == "logmel":
            kernels[-1]["work"] = (
                "one launch: the whole MFCC of one full-width b=4, w=4 "
                "step's (4, 4, 1520) samples, 128 frames (device time)")
            kernels[-1]["library"] = ("rfft + matmul pipeline: pre-emphasis, "
                                      "unfold, torch.fft.rfft, |.|^2, mel "
                                      "and DCT matmuls")
            kernels[-1]["b=1 w=1"] = {k: v for k, v in
                                      rows11["logmel"].items()
                                      if k == "ms" or k.endswith("_ms")}
        if name == "int8_matmul":
            kernels[-1]["work"] += "; quantization included"
            kernels[-1]["library"] = ("quantize_rows + torch._int_mm + "
                                      "rescale")
            r11 = rows11["int8_matmul"]
            kernels[-1]["b=1 w=1"] = {k: v for k, v in r11.items()
                                      if k == "ms" or k.endswith("_ms")}
    for name in LM_KERNELS:
        r = dict(lm_rows[name], **lm3_rows[name])
        by_path = {LM_ARCH: serve["counts"][name]}
        by_path.update({arch: lm2[arch]["counts"][name] for arch in lm2})
        by_path.update({path: c[name] for path, c in lm3_paths.items()})
        by_path["lm mesh (all ranks)"] = lm_mesh["counts"][name]
        by_path["roofline cells"] = roof["counts"][name]
        by_path["guarded steps"] = analysis["counts"][name]
        lm_errs[name] = max(lm_errs[name], lm3_errs[name])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/"
                      f"{SOURCES.get(name, name)}.cu",
            "replaces": replaces(name), "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": lm_errs[name], **r})
    for name in PRUNE_KERNELS:
        r = bp_timing[BP_N]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces(name), "launches": bp_counts[name],
            "max_abs_err": bp_err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "work": f"one launch at N={BP_N}, beam {BP_BEAM} (device time); "
                    f"no serving path calls it, as in the reference",
            "launch_inclusive_ms": r["launch_inclusive_ms"],
            f"N={BP_BIG}": {k: v for k, v in bp_timing[BP_BIG].items()
                            if k == "ms" or k.endswith("_ms")}})
        if "before_ms" in r:
            kernels[-1]["before_ms"] = r["before_ms"]
    lm_results = {
        "arch": cfg.name, "parameters": n_params,
        "launch_counts": serve["counts"],
        "prefills": serve["prefills"], "prefill_ms": serve["prefill_ms"],
        "decode_step_ms": serve["decode_step_ms"],
        "decode_steps_ms": serve["decode_steps"],
        "n_prefills": serve["n_prefills"],
        "n_decode_steps": serve["n_decode_steps"],
        "wall_s": serve["wall_s"], "tokens": serve["tokens"],
        "tokens_per_s": serve["tokens_per_s"], "parity": parity,
        "timing": lm_timing,
        "profile": lm_prof}
    lm2_results = {
        arch: {k: v for k, v in sv.items() if k != "decode_steps"}
        for arch, sv in lm2.items()}
    bp_results = {"launch_counts": bp_counts, "max_abs_err": bp_err,
                  "timing": {str(n): r for n, r in bp_timing.items()}}
    (OUT / "results.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "build_s": build_s, "kernels": kernels, "steps": steps,
        "launch_counts": counts, "logp_max_abs_err": lp_err,
        "int8_steps": steps8, "int8_launch_counts": counts8,
        "int8_logp_max_abs_err": lp_err8, "shim_launch_counts": shim_counts,
        "step_ms": steps_ms, "profile": prof, "profile_int8": prof8,
        "conv_layernorm": conv_ln, "launch_floor_ms": floor_ms,
        "int8_b1w1": rows11["int8_matmul"], "hypothesis_rows": census,
        "lm": lm_results, "lm2": lm2_results, "beam_prune": bp_results,
        "network": network, "asr_train": asr_train, "lm_train": lm_train,
        "lm3": {"max_abs_err": lm3_errs, "timing": lm3_timing, VLM_ARCH: vlm,
                AUDIO_ARCH: audio, "int8": int8_lm}, "mesh": mesh,
        "lm_mesh": lm_mesh, "serve_mesh": serve_mesh,
        "train_mesh": train_mesh, "elastic": elastic_res,
        "roofline": roof, "analysis": analysis}, indent=1))
    print(f"[done] launches on the fp32 path: {counts}; on the int8 path: "
          f"{counts8}; on the LM path: {serve['counts']}; on the "
          + "; on the ".join(f"{arch} path: {sv['counts']}"
                             for arch, sv in lm2.items())
          + f"; on the prune path: {bp_counts}; on the network path: "
          f"{network['counts']}; decoding with the trained weights: fp32 "
          f"{asr_train['decode_fp32']['counts']}, int8 "
          f"{asr_train['decode_int8']['counts']}; training itself launched "
          f"none (KernelPolicy('ref')); "
          + "; ".join(f"{path}: {c}" for path, c in lm3_paths.items())
          + f"; the sharded ASR step (every rank, every mesh): "
          f"{mesh['counts']}; the sharded LM cells (every rank, every "
          f"case): {lm_mesh['counts']}; the mesh server (every rank, every "
          f"case): {serve_mesh['counts']}; training on the mesh, elastic "
          f"restart, compressed_psum and the pipeline: none; the roofline "
          f"cells (phase 27): {roof['counts']}; the guarded steps (phase "
          f"28): {analysis['counts']}",
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
