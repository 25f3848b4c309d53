// Tier-2 denoise kernels on an (n, batch) panel, row-major:
//
//   stencil_denoise  y = p - lam * (L^T L) p         (truncated Neumann)
//   thomas_solve     y = (I + lam L^T L)^{-1} p      (exact)
//
// ---- stencil_denoise --------------------------------------------------------
// Replaces src/repro/kernels/tridiag.py::stencil_denoise (_stencil_kernel).
// (L^T L) p is a 3-point stencil down the rows of the panel:
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
//
// ---- thomas_solve -----------------------------------------------------------
// Replaces src/repro/kernels/tridiag.py::thomas_solve (_thomas_kernel).  The
// matrix is constant, so the elimination coefficients c' and the pivots come
// precomputed (the wrapper's fp32 recurrence, as the JAX wrapper does) and
// the kernel runs the two right-hand-side recurrences of each column:
//
//   forward   d'_i = (p_i - a d'_{i-1}) piv_i       (d'_{-1} = 0)
//   backward  y_i  = d'_i - c'_i y_{i+1}             (c'_{n-1} = 0, y_n = 0)
//
// with a = lam * h.  d' is written into the output and overwritten in place
// by the backward pass, as the Pallas kernel does with its VMEM scratch.
//
// Bound: 4*(2*n*batch + 2*n) bytes (p, c', piv read, y written) and 5 flops
// an element: about 0.3 us at n = 32768, batch 1.  What limits it is the
// chain: each column is 2n dependent steps (FMA + multiply forward, FMA
// backward, about 8 and 4 cycles), one thread per column, so at batch 1 a
// single thread takes roughly 12 * 32768 cycles, 0.2 ms at 1.98 GHz.
//
// Design: the Pallas kernel keeps the whole (n, block_b) panel in VMEM; an SM
// has 227 KB, so here the panel is staged through shared memory in chunks of
// rows.  A block of kTThreads threads owns up to kTCols columns; lane c < cols
// of warp 0 runs column c's recurrence, reading p (or d') and piv (or c')
// from shared memory, never from device memory, so no global-load latency
// sits in the chain.  All threads of the block copy the next chunk with
// cp.async (double-buffered) while warp 0 works on the current one, so the
// copies overlap the chain.  Chunks hold kTBuf panel elements, at most
// kTMaxRows rows.
#include <cuda_pipeline_primitives.h>
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

constexpr int kTThreads = 128;
constexpr int kTCols = 32;      // columns per block: the lanes of warp 0
constexpr int kTBuf = 4096;     // staged panel elements per buffer
constexpr int kTMaxRows = 1024; // rows per staged chunk

// Copy rows [i0, i0 + rc) of columns [c0, c0 + cols) of the (n, batch)
// panel src into panel (as [row][col]) and coefficient rows [i0, i0 + rc)
// into coef, asynchronously; commits one cp.async group.
__device__ __forceinline__ void stage(float* panel, float* coef,
                                      const float* src, const float* csrc,
                                      int i0, int rc, int cols, int batch,
                                      int c0) {
  for (int e = threadIdx.x; e < rc * cols; e += kTThreads) {
    const int i = e / cols, c = e - i * cols;
    __pipeline_memcpy_async(panel + e,
                            src + (size_t)(i0 + i) * batch + c0 + c, 4);
  }
  for (int i = threadIdx.x; i < rc; i += kTThreads)
    __pipeline_memcpy_async(coef + i, csrc + i0 + i, 4);
  __pipeline_commit();
}

__global__ void __launch_bounds__(kTThreads)
thomas_kernel(const float* __restrict__ p, const float* __restrict__ cp,
              const float* __restrict__ piv, float* __restrict__ y, int n,
              int batch, float a) {
  __shared__ float panel[2][kTBuf];
  __shared__ float coef[2][kTMaxRows];
  const int c0 = blockIdx.x * kTCols;
  const int cols = min(kTCols, batch - c0);
  const int rows = min(kTMaxRows, kTBuf / cols);
  const int chunks = (n + rows - 1) / rows;
  const int lane = threadIdx.x;
  const bool runs = lane < cols;  // lanes of warp 0 only (cols <= 32)

  // Forward: chunk t covers rows [t * rows, ...).
  float d = 0.f;
  stage(panel[0], coef[0], p, piv, 0, min(rows, n), cols, batch, c0);
  for (int t = 0; t < chunks; ++t) {
    const int i0 = t * rows, rc = min(rows, n - i0), s = t & 1;
    if (t + 1 < chunks) {
      const int j0 = i0 + rows;
      stage(panel[s ^ 1], coef[s ^ 1], p, piv, j0, min(rows, n - j0), cols,
            batch, c0);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // chunk t has landed for every thread
    if (runs) {
      const float* pv = panel[s] + lane;
      const float* pw = coef[s];
      float* out = y + (size_t)i0 * batch + c0 + lane;
#pragma unroll 8
      for (int i = 0; i < rc; ++i) {
        d = fmaf(-a, d, pv[i * cols]) * pw[i];
        out[(size_t)i * batch] = d;
      }
    }
    __syncthreads();  // buffer s is free before it is staged again
  }

  // Backward, over d' in y: chunk t covers rows [(chunks-1-t) * rows, ...),
  // walked from its last row.  The forward stores are visible to the block
  // after the barrier above.
  float v = 0.f;
  {
    const int q0 = (chunks - 1) * rows;
    stage(panel[0], coef[0], y, cp, q0, n - q0, cols, batch, c0);
  }
  for (int t = 0; t < chunks; ++t) {
    const int i0 = (chunks - 1 - t) * rows, rc = min(rows, n - i0);
    const int s = t & 1;
    if (t + 1 < chunks) {
      stage(panel[s ^ 1], coef[s ^ 1], y, cp, i0 - rows, rows, cols, batch,
            c0);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (runs) {
      const float* pv = panel[s] + lane;
      const float* pw = coef[s];
      float* out = y + (size_t)i0 * batch + c0 + lane;
#pragma unroll 8
      for (int i = rc - 1; i >= 0; --i) {
        v = fmaf(-pw[i], v, pv[i * cols]);
        out[(size_t)i * batch] = v;
      }
    }
    __syncthreads();
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

// p and y are distinct contiguous (n, batch) float32 panels; cp and piv hold
// the n elimination coefficients and pivots; a = lam * h.  Returns the
// cudaError_t of the launch.
int repro_thomas_solve(const float* p, const float* cp, const float* piv,
                       float* y, int n, int batch, float a, void* stream) {
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((batch + kTCols - 1) / kTCols);
  thomas_kernel<<<blocks, kTThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, cp, piv, y, n, batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
