// Fused digital halves of one solver iteration.
//
//   cg_update:          x' = x + alpha_b p,  r' = r - alpha_b Ap   (per column b)
//   richardson_update:  r = b - y,           x' = x + omega r
//
// Replace src/repro/kernels/solver_update.py::cg_update (_cg_kernel) and
// ::richardson_update (_richardson_kernel).  alpha (batch,) and omega (a
// scalar) are read from device memory, so the host never waits for them.
//
// Bound: pure streaming, each input read once and each output written once:
// 24*n*batch bytes for cg_update, 20*n*batch for richardson_update, about
// two flops an element, so device memory bounds both.  At the solver's shapes
// (n = 32768, batch 1) the panels are 128 KiB and the launch dominates.
//
// Design: one thread per element of the (n, batch) panel, grid-stride.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ x_out,
                 float* __restrict__ r_out, long long total, int batch) {
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const float a = alpha[idx % batch];
    x_out[idx] = x[idx] + a * p[idx];
    r_out[idx] = r[idx] - a * ap[idx];
  }
}

__global__ void __launch_bounds__(kThreads)
richardson_update_kernel(const float* __restrict__ x,
                         const float* __restrict__ b,
                         const float* __restrict__ y,
                         const float* __restrict__ omega,
                         float* __restrict__ x_out, float* __restrict__ r_out,
                         long long total) {
  const float w = *omega;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const float r = b[idx] - y[idx];
    r_out[idx] = r;
    x_out[idx] = x[idx] + w * r;
  }
}

}  // namespace

extern "C" {

// All panels are contiguous (n, batch) float32; alpha is (batch,).
int repro_cg_update(const float* x, const float* r, const float* p,
                    const float* ap, const float* alpha, float* x_out,
                    float* r_out, long long n, int batch, void* stream) {
  const long long total = n * batch;
  if (total == 0) return static_cast<int>(cudaSuccess);
  cg_update_kernel<<<grid_for(total), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, r, p, ap, alpha, x_out, r_out, total, batch);
  return static_cast<int>(cudaGetLastError());
}

// omega points at one float32 on the device.
int repro_richardson_update(const float* x, const float* b, const float* y,
                            const float* omega, float* x_out, float* r_out,
                            long long n, int batch, void* stream) {
  const long long total = n * batch;
  if (total == 0) return static_cast<int>(cudaSuccess);
  richardson_update_kernel<<<grid_for(total), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      x, b, y, omega, x_out, r_out, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
