// Truncated-Neumann tier-2 denoise  y = p - lam * (L^T L) p.
//
// Replaces src/repro/kernels/tridiag.py::stencil_denoise (_stencil_kernel).
// (L^T L) p is a 3-point stencil down the rows of the (n, batch) panel:
// (1 + h^2) p_i + h (p_{i-1} + p_{i+1}), row 0 with diagonal 1, zero beyond
// the ends.
//
// Bound: one read of p and one write of y, 8*n*batch bytes, against about
// 6 flops an element, so device memory bounds it (at the engine's shapes,
// n = 32768 and batch <= 8, the panel is at most 1 MiB and the launch itself
// dominates).
//
// Design: one thread per element, grid-stride; the two neighbours are the
// elements one row stride (batch) away and come from L1/L2, since the
// neighbouring threads read them too.  No shared memory: there is no reuse
// beyond the stencil's own three words.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stencil_kernel(const float* __restrict__ p, float* __restrict__ y,
               long long n, int batch, float lam, float diag, float h,
               float hh) {
  const long long total = n * batch;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long i = idx / batch;
    const float v = p[idx];
    const float up = i + 1 < n ? p[idx + batch] : 0.f;
    const float dn = i > 0 ? p[idx - batch] : 0.f;
    float kp = diag * v + h * (up + dn);
    if (i == 0) kp = kp - hh * v;
    y[idx] = v - lam * kp;
  }
}

}  // namespace

extern "C" {

// p and y are contiguous (n, batch) float32 panels.  Returns the
// cudaError_t of the launch.
int repro_stencil_denoise(const float* p, float* y, long long n, int batch,
                          float lam, float h, void* stream) {
  const long long total = n * batch;
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  stencil_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      p, y, n, batch, lam, 1.0f + h * h, h, h * h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
