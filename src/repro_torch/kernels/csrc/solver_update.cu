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
// cg_update: the panel is read as rows of 4-float units (a vector, batch 1,
// as n / 4 rows of 4); a thread keeps one column group (4 columns, or the
// vector's 4 rows) with its 4 alphas read once, and walks rows with the
// grid's stride, in a grid of one wave (the card's residency, pdl.cuh).
// 16-byte loads and stores when every panel is 16-byte aligned and batch is
// 1 or a multiple of 4, scalar ones otherwise and for a vector's last
// partial unit.  It is launched with
// programmatic dependent launch (pdl.cuh): alpha comes from the reduction
// just before it on the stream, so the grid waits for that kernel before
// its first load.  The expressions are those of the one-thread-an-element
// kernel it replaces, so its outputs are the same bit for bit.
//
// richardson_update: one thread per element of the (n, batch) panel,
// grid-stride.
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;

unsigned grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Thread t < groups * row_threads: column group t % groups, rows t /
// groups, + row_threads, ... of the (rows, groups) units.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* __restrict__ x, const float* __restrict__ r,
                 const float* __restrict__ p, const float* __restrict__ ap,
                 const float* __restrict__ alpha, float* __restrict__ x_out,
                 float* __restrict__ r_out, long long n, int batch,
                 long long rows, int groups, long long row_threads) {
  grid_dependency_wait();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t < row_threads * groups) {
    const int g = (int)(t % groups);
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = 0.f;
    if (batch == 1) {
      a[0] = a[1] = a[2] = a[3] = alpha[0];
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < batch) a[j] = alpha[4 * g + j];
    }
    for (long long row = t / groups; row < rows; row += row_threads) {
      const long long off = batch == 1 ? 4 * row : row * batch + 4 * g;
      const long long left = batch == 1 ? n - 4 * row : batch - 4 * g;
      const int w = left < 4 ? (int)left : 4;
      if (kVec && w == 4) {
        const float4 xv = *reinterpret_cast<const float4*>(x + off);
        const float4 rv = *reinterpret_cast<const float4*>(r + off);
        const float4 pv = *reinterpret_cast<const float4*>(p + off);
        const float4 av = *reinterpret_cast<const float4*>(ap + off);
        *reinterpret_cast<float4*>(x_out + off) =
            make_float4(xv.x + a[0] * pv.x, xv.y + a[1] * pv.y,
                        xv.z + a[2] * pv.z, xv.w + a[3] * pv.w);
        *reinterpret_cast<float4*>(r_out + off) =
            make_float4(rv.x - a[0] * av.x, rv.y - a[1] * av.y,
                        rv.z - a[2] * av.z, rv.w - a[3] * av.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < w) {
            x_out[off + j] = x[off + j] + a[j] * p[off + j];
            r_out[off + j] = r[off + j] - a[j] * ap[off + j];
          }
        }
      }
    }
  }
  launch_dependents();
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
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const bool aligned =
      ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(r) |
        reinterpret_cast<size_t>(p) | reinterpret_cast<size_t>(ap) |
        reinterpret_cast<size_t>(x_out) | reinterpret_cast<size_t>(r_out)) %
       16) == 0;
  const bool vec = aligned && (batch == 1 || batch % 4 == 0);
  const long long wave =
      vec ? resident_threads<cg_update_kernel<true>, kThreads>()
          : resident_threads<cg_update_kernel<false>, kThreads>();
  if (wave == 0) return residency_error();
  const int groups = batch == 1 ? 1 : (batch + 3) / 4;
  const long long rows = batch == 1 ? (n + 3) / 4 : n;
  const long long units = rows * groups;
  const long long threads = units < wave ? units : wave;
  const long long row_threads = threads / groups > 0 ? threads / groups : 1;
  const dim3 grid(static_cast<unsigned>(
      (row_threads * groups + kThreads - 1) / kThreads));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      vec ? launch_pdl(cg_update_kernel<true>, grid, dim3(kThreads), st, x,
                       r, p, ap, alpha, x_out, r_out, n, batch, rows, groups,
                       row_threads)
          : launch_pdl(cg_update_kernel<false>, grid, dim3(kThreads), st, x,
                       r, p, ap, alpha, x_out, r_out, n, batch, rows, groups,
                       row_threads));
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
