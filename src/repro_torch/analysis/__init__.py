"""repro-lint for the PyTorch/CUDA port: repo-specific static analysis
(`python -m repro_torch.analysis src/repro_torch`).

Port of `repro.analysis`: the same eight codes, each the counterpart of
the reference's rule of that code, reading the port's idioms (README
"PyTorch/CUDA port" has the rule table):

  RPL001  host reads in a guarded step: the functions called inside a
          `with no_implicit_transfers()` block, and their callees two
          levels deep, may not read a tensor back (`.item()`,
          `.tolist()`, `.cpu()`, `.numpy()`, `int()`/`float()`/`bool()`
          or an `if`/`while` on a tensor), call an op sized by its data
          (`nonzero`, `bincount`, `unique`, `masked_select`, one-argument
          `torch.where`) or index by a scalar tensor (a full reduction, a
          0-d constructor): each makes the host wait on the card every
          step (a decode step's cache slot indexed by a 0-d tensor,
          `bincount` in the MoE dispatch).
  RPL002  kernel contract: every `kernels/csrc/*.cu` has a
          KERNEL_REGISTRY entry in kernels/policy.py naming its C entry
          points (keys of `_build.SIGNATURES`), its wrapper module (which
          refuses grad and counts its launches), its plain twin(s) in
          kernels/ref.py, its kernels/cost.py formula, a CPU parity test
          against the reference and a `cuda`-marked kernel-vs-plain test.
  RPL003  aliasing: results built from engine-owned slot state must
          route through `copy_result` before they escape the engine.
  RPL004  thread discipline: `@worker_only` engine methods may not be
          called from asyncio handlers (or supervisor/watchdog entry
          points) except through an EngineWorker submit/call thunk.
  RPL005  RNG discipline: a module that runs sharded compute (a
          `MeshAxis` collective, `sharding.local_block`, `LM.init_local`)
          draws only from an explicit `torch.Generator`, seeded alike on
          every rank: no `torch.manual_seed`, no `rand*`/`normal_`/
          `randint` without `generator=`.
  RPL006  collective/axis discipline (interprocedural): a `MeshAxis`
          collective names an axis the cell's mesh declares; a product
          over a contraction split by `local_block` reaches a reduction
          (`MeshAxis.all_reduce`, `reduce_from`, `all_reduce_max`) before
          it escapes (the silent partial-sum class, on
          `linear_row`).
  RPL007  kernel entry contract: KERNEL_REGISTRY 'entry' names a real
          public function of kernels/ops.py or of the wrapper module
          whose signature covers a registered plain twin, and each
          wrapper's device/dtype/shape/contiguity checks dominate its
          ctypes launch.
  RPL008  commit discipline: engine slot/pool state mutated before a
          may-raise call (`_run_step`, `LM.decode_step`, `LM.prefill`, a
          kernel wrapper, the fault injector's `check`) without a
          commit=False probe or a restoring try/finally.

RPL003/004/005 are per-file; RPL001/002/006/007/008 run over the
project-wide symbol table and call graph (`repro_torch.analysis.callgraph` /
`repro_torch.analysis.interproc`), with facts propagated through
bounded two-level call summaries: anything the engine cannot resolve is
unknown, and unknown is never flagged.

Suppress a finding with a trailing or preceding-line comment
`# repro-lint: disable=RPL001` (comma-separate several codes), or a
whole file with `# repro-lint: disable-file=RPL001`, as in the
reference: both linters read the same comments.

The runtime counterpart lives in `repro_torch.analysis.guards`: the
engines' steps run under `no_implicit_transfers()` (the card's sync
debug mode in error; process-wide), and `compilation_budget(n)` counts
builds and loads of the kernel library.
"""
from repro_torch.analysis.core import Finding, RULE_DOCS, run_paths

__all__ = ["Finding", "RULE_DOCS", "run_paths"]
