// Launch helpers shared by the matmul kernels (the bf16 loop of
// mma_tile.cuh and int8_matmul.cu): a dynamic shared memory limit raised
// once per kernel and device, and the programmatic dependent launch of a
// K split's reduce pass with its two device-side halves.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <utility>

namespace {

// Let `kern` take `bytes` of dynamic shared memory: above the default 48 KB
// only after cudaFuncSetAttribute, which is called once per device for each
// kernel (`set_on` is that kernel's own flag word, a bit per device id; ids
// past 63 set it on every launch).  The device is the current one, which
// the Python side makes the operands' device for every launch
// (`kernels/runtime.py` `launch`).  An error goes back to the caller, whose
// launch it would refuse.
inline cudaError_t allow_dynamic_smem(const void* kern, int bytes,
                                      std::atomic<uint64_t>& set_on) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (set_on.load(std::memory_order_relaxed) & bit)) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) set_on.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// Launch `kern` as a programmatic dependent of the kernel before it on
// `stream`: its CTAs are scheduled while that grid's last CTAs run, and
// each waits in pdl_wait() until the grid has finished and its writes are
// visible.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kern)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, std::forward<Args>(args)...);
}

// In the primary kernel: let the dependent launched after it be scheduled
// early (it still waits for this grid's completion).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// In the dependent kernel: wait until the primary grid has finished.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

}  // namespace
