// Shared memory above the 48 KB default (dynamic plus the kernel's
// `static_bytes`) needs an explicit per-kernel opt-in.  Raise it only
// when a launch needs more than any earlier one did: cudaFuncSetAttribute
// is not free, and calling it on every launch stalled the host behind the
// work already queued.
#pragma once
#include <cuda_runtime.h>

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed,
                              size_t static_bytes = 0) {
  if (bytes + static_bytes <= 48 * 1024 || bytes <= *allowed)
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *allowed = bytes;
  return e;
}
