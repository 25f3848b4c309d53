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
// Both read the panel as rows of 4-float units (a vector, batch 1, as n / 4
// rows of 4); a thread keeps one column group (4 columns, or the vector's 4
// rows) with its coefficients read once, and walks rows with the grid's
// stride, in a grid of one wave (the card's residency, pdl.cuh; one helper,
// launch_units, sizes and launches both).  16-byte loads and stores when
// every panel is 16-byte aligned and batch is 1 or a multiple of 4, scalar
// ones otherwise and for a vector's last partial unit.  Both are launched
// with programmatic dependent launch (pdl.cuh): alpha comes from the
// reduction just before cg_update on the stream, omega may come from the
// power iteration's kernels, and the panels from the stencil of the MVM
// just before, so each grid waits for the kernel before it ahead of its
// first global access, and lets the next kernel be scheduled at its end.
// (richardson_update triggering after a thread's last load took 1.09 us
// at 1 x 1 but 2.08 us at 32,768 x 8 on an H100; at the end, 1.15 and 1.77
// us.  On the solver's path the next kernel, a norm, is launched plainly
// and gains nothing from an early trigger.)  The expressions are those of
// the one-thread-an-element kernels they replace, so their outputs are the
// same bit for bit.
//
// launch_floor_kernel replaces no TPU kernel: it is a measurement probe.
// One thread writes one float, launched with a plain <<<>>> (no PDL), so
// that chip_smoke.py can time the least a separate launch costs on the
// card; no solver or model path calls it.
#include <cuda_runtime.h>

#include "pdl.cuh"

namespace {

constexpr int kThreads = 256;

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

// The w <= 4 floats of a unit at p: one 16-byte access when kVec and w is
// 4, else w scalar ones (the rest of the float4 is 0).
template <bool kVec>
__device__ __forceinline__ float4 load_unit(const float* p, int w) {
  if (kVec && w == 4) return *reinterpret_cast<const float4*>(p);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (w > 0) v.x = p[0];
  if (w > 1) v.y = p[1];
  if (w > 2) v.z = p[2];
  if (w > 3) v.w = p[3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store_unit(float* p, float4 v, int w) {
  if (kVec && w == 4) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  if (w > 0) p[0] = v.x;
  if (w > 1) p[1] = v.y;
  if (w > 2) p[2] = v.z;
  if (w > 3) p[3] = v.w;
}

// Thread t walks the units that cg_update_kernel's thread t walks; omega
// is read once a thread, after the wait.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
richardson_update_kernel(const float* __restrict__ x,
                         const float* __restrict__ b,
                         const float* __restrict__ y,
                         const float* __restrict__ omega,
                         float* __restrict__ x_out, float* __restrict__ r_out,
                         long long n, int batch, long long rows, int groups,
                         long long row_threads) {
  grid_dependency_wait();
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= row_threads * groups) return;
  const int g = (int)(t % groups);
  const float om = *omega;
  for (long long row = t / groups; row < rows; row += row_threads) {
    const long long off = batch == 1 ? 4 * row : row * batch + 4 * g;
    const long long left = batch == 1 ? n - 4 * row : batch - 4 * g;
    const int w = left < 4 ? (int)left : 4;
    const float4 bv = load_unit<kVec>(b + off, w);
    const float4 yv = load_unit<kVec>(y + off, w);
    const float4 xv = load_unit<kVec>(x + off, w);
    const float4 rv = make_float4(bv.x - yv.x, bv.y - yv.y, bv.z - yv.z,
                                  bv.w - yv.w);
    store_unit<kVec>(r_out + off, rv, w);
    store_unit<kVec>(x_out + off,
                     make_float4(xv.x + om * rv.x, xv.y + om * rv.y,
                                 xv.z + om * rv.z, xv.w + om * rv.w),
                     w);
  }
  launch_dependents();
}

__global__ void launch_floor_kernel(float* out) { *out = 1.f; }

// True when every pointer is 16-byte aligned and a row of the (n, batch)
// panel is whole units (batch 1 or a multiple of 4): the float4 kernels.
template <typename... Ptrs>
bool vec_units(int batch, Ptrs... ptrs) {
  return ((reinterpret_cast<size_t>(ptrs) | ...) % 16) == 0 &&
         (batch == 1 || batch % 4 == 0);
}

// Launches Vec (vec) or Scalar, the two instances of one unit kernel, with
// PDL on a grid of at most one wave of the card over the (n, batch)
// panel's units: rows of groups column groups (a vector: n / 4 rows of one
// group), each group walked by row_threads threads.  The kernel's
// arguments are args..., then n, batch, rows, groups and row_threads.
template <auto Vec, auto Scalar, typename... Args>
int launch_units(bool vec, long long n, int batch, void* stream,
                 Args... args) {
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const long long wave = vec ? resident_threads<Vec, kThreads>()
                             : resident_threads<Scalar, kThreads>();
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
      vec ? launch_pdl(Vec, grid, dim3(kThreads), st, args..., n, batch,
                       rows, groups, row_threads)
          : launch_pdl(Scalar, grid, dim3(kThreads), st, args..., n, batch,
                       rows, groups, row_threads));
}

}  // namespace

extern "C" {

// All panels are contiguous (n, batch) float32; alpha is (batch,).
int repro_cg_update(const float* x, const float* r, const float* p,
                    const float* ap, const float* alpha, float* x_out,
                    float* r_out, long long n, int batch, void* stream) {
  return launch_units<cg_update_kernel<true>, cg_update_kernel<false>>(
      vec_units(batch, x, r, p, ap, x_out, r_out), n, batch, stream, x, r, p,
      ap, alpha, x_out, r_out);
}

// All panels are contiguous (n, batch) float32; omega points at one
// float32 on the device.
int repro_richardson_update(const float* x, const float* b, const float* y,
                            const float* omega, float* x_out, float* r_out,
                            long long n, int batch, void* stream) {
  return launch_units<richardson_update_kernel<true>,
                      richardson_update_kernel<false>>(
      vec_units(batch, x, b, y, x_out, r_out), n, batch, stream, x, b, y,
      omega, x_out, r_out);
}

// Writes 1.0f to out[0] with a plain launch (the probe above).
int repro_launch_floor(float* out, void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
