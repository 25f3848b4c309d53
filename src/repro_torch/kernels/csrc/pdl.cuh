// Programmatic dependent launch (PDL) on Hopper.
//
// A kernel launched by launch_pdl may be scheduled while the kernel before
// it on the stream is still running: its launch and block scheduling then
// overlap that kernel's tail.  Such a kernel calls grid_dependency_wait()
// as its first statement, before any global read or write (the caching
// allocator may hand it, as an output, memory the previous kernel still
// reads), and launch_dependents() after its last global load, which lets
// the next PDL kernel on the stream be scheduled.  Launched without the
// attribute, or after a kernel that never calls launch_dependents(), the
// wait returns once the previous kernel has finished, as a plain launch
// would: the kernel is correct whatever precedes it.
//
// resident_threads<Kernel, Block>() sizes such a kernel's grid from the card
// it runs on.
#pragma once

#include <cuda_runtime.h>

// griddepcontrol.wait: blocks until the grids this one depends on have
// completed and their memory operations are visible.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// griddepcontrol.launch_dependents: once every block has issued it (or
// exited), the dependent grid may be scheduled.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// kernel<<<grid, block, 0, stream>>>(args...) through cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization.  Returns the launch's
// cudaError_t (then cudaGetLastError()).
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = 0;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t rc =
      cudaLaunchKernelEx(&config, kernel, args...);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// Threads of Kernel, in blocks of Block, that the current device holds at
// once: its SMs times the blocks an SM takes (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Found on the first call
// that succeeds, for each kernel and block size; 0 while the runtime could
// not say.
template <auto Kernel, int Block>
long long resident_threads() {
  static long long threads = 0;
  if (threads == 0) {
    int device = 0, sms = 0, blocks = 0;
    if (cudaGetDevice(&device) == cudaSuccess &&
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, Kernel, Block,
                                                      0) == cudaSuccess)
      threads = static_cast<long long>(sms) * blocks * Block;
  }
  return threads;
}

// The launcher's answer when resident_threads() found nothing: the
// runtime's error, or cudaErrorUnknown.
inline int residency_error() {
  const cudaError_t rc = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : cudaErrorUnknown);
}
