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
// 6 flops an element, so device memory bounds it.  On a solver's column
// (n = 32768, batch 1: 256 KiB) the launch itself dominates; on an LM
// dense's (d_out, rows) panel (151,936 x 1,024: 1.24 GB) the bytes do.
//
// Design: two kernels behind one launcher, both launched with programmatic
// dependent launch (pdl.cuh), so that the launch and block scheduling
// overlap the tail of the kernel before it on the stream.
//  * A panel (batch > 1), stencil_panel_kernel: a thread owns 4 adjacent
//    columns and walks a chunk of R rows down them, p[i-1], p[i] and p[i+1]
//    in registers, so each element comes from device memory once, plus two
//    halo rows a chunk.  16-byte loads and stores when batch % 4 == 0 and
//    both panels are 16-byte aligned, scalar ones otherwise (a contiguous
//    view may start at any 4-byte offset).  The row is the loop counter: no
//    division an element.  R is the largest that keeps the grid at two waves
//    of the card (the SMs times the blocks an SM holds: 132 x 8 of 128 at
//    64 registers a thread on an H100), a multiple of the kRowsInFlight
//    rows a thread loads at a time, or 1 or 2 on a panel too narrow for
//    that, so a narrow panel gets short chunks and many threads.  (A fixed
//    2,048 threads an SM, twice what the kernel gets, would give R = 2 on a
//    6,144 x 1,024 panel, 7 % slower there on an H100.)  The residency is
//    pdl.cuh's resident_threads(), taken from the card.
//  * A column (batch == 1), stencil_column_kernel: a thread owns 4
//    consecutive rows as one float4; p[4q - 1] and p[4q + 4] come from the
//    lanes beside it by warp shuffles, and the warp's two edge words from
//    one extra load each.  An unaligned column takes scalar loads; rows past
//    the last multiple of 4 are a scalar tail.
// Both run in blocks of 128 threads.  (One-warp blocks on a small panel,
// to spread it over more SMs, were up to 0.4 us slower on an H100.)
// Every element is computed by the expressions, in the order, of the
// one-thread-an-element kernel these replace, so the output is the same bit
// for bit.
//
// ---- thomas_solve -----------------------------------------------------------
// Replaces src/repro/kernels/tridiag.py::thomas_solve (_thomas_kernel).  The
// matrix is constant, so the elimination coefficients c' and the pivots come
// precomputed (the wrapper's fp32 recurrence, as the JAX wrapper does) and
// the kernel solves the two right-hand-side recurrences of each column:
//
//   forward   d'_i = alpha_i d'_{i-1} + beta_i  alpha_i = -a piv_i,
//                                               beta_i = piv_i p_i, d'_{-1} = 0
//   backward  y_i  = gamma_i y_{i+1} + d'_i     gamma_i = -c'_i, y_n = 0
//
// with a = lam * h (c'_{n-1} = 0).  Both are affine, and affine maps compose
// associatively, (A2, B2) o (A1, B1) = (A2 A1, A2 B1 + B2), so each runs as
// a scan: exact, with no truncation that leans on |alpha| being small (at
// lam = 1e3, |c'| is about 0.97).
//
// Bound: p read and y written, 8*n*batch bytes (the coefficients reach a
// fixed point within a few hundred rows, below), and a few flops an element:
// about 0.08 us at n = 32768, batch 1.  A sequential recurrence is 2n
// dependent steps on one thread; here a thread's chain is 2 * (2R + 11)
// steps (R = kSR rows, 11 shuffle levels of the block scan), and the rest is
// getting one column through one SM.
//
// Design: one block of T <= kSMaxThreads threads per column (grid = batch),
// thread t owning rows [t R, t R + R) of a tile of T R rows, held in
// registers (512 threads of 64 rows leave 128 registers a thread; 1,024
// threads would leave 64, too few for 32 rows and the scan without spills).  For each pass and tile: the thread
// composes its chunk's map, an exclusive block scan of the T maps (warp
// shuffles, then one warp over the warp totals) gives each chunk its
// carry-in, and the thread replays its chunk from it.  The tile's carry-out
// (the last replayed value) enters the next tile, so an n above T R walks
// tiles in order; d' goes to y between the passes, except for the last
// tile, whose d' stays in registers (a one-tile column never writes it).
//
// Memory: a column comes in and goes out through padded shared memory by
// 16-byte copies (cp.async in, vector stores out), so loads and stores are
// coalesced and the thread's 16-byte reads of its own rows are free of bank
// conflicts.  The columns of a panel with batch > 1 are strided (4 useful
// bytes a 32-byte sector), so the launcher first transposes the panel into
// a workspace of contiguous, 16-byte aligned columns, solves there in place,
// and transposes back.  The coefficients: from row `head` on c' and the
// pivot repeat one value each (the recurrence's fixed point; head is 0 to
// 168 rows for lam in 1e-12 .. 1e3, 1,846 at 1e6), so a chunk past head
// runs on the two values in registers and only the head rows are read,
// through the read-only cache.  (Every thread reading its own rows of both
// columns by 16-byte loads, in the composing and the replaying step, took
// 26 us a column against 15 us on an H100 at n = 32768 and spilled.)
//
// Deterministic: no atomics, the association depends on (n, lam) alone.
// fp32 throughout, one FMA a step.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "pdl.cuh"

namespace {

constexpr int kStencilThreads = 128;
constexpr int kRowsInFlight = 4;  // rows a panel thread loads at once
constexpr unsigned kLanes = 0xffffffffu;

// y of one element from p_i (v), p_{i+1} (up) and p_{i-1} (dn).
__device__ __forceinline__ float denoise(float v, float up, float dn,
                                         bool first, float lam, float diag,
                                         float h, float hh) {
  float kp = diag * v + h * (up + dn);
  if (first) kp = kp - hh * v;
  return v - lam * kp;
}

__device__ __forceinline__ float4 denoise4(float4 v, float4 up, float4 dn,
                                           bool first, float lam, float diag,
                                           float h, float hh) {
  return make_float4(denoise(v.x, up.x, dn.x, first, lam, diag, h, hh),
                     denoise(v.y, up.y, dn.y, first, lam, diag, h, hh),
                     denoise(v.z, up.z, dn.z, first, lam, diag, h, hh),
                     denoise(v.w, up.w, dn.w, first, lam, diag, h, hh));
}

// The first w <= 4 floats at a (16-byte aligned with kVec, w then 4),
// zeros after them.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ a, int w) {
  if (kVec) return *reinterpret_cast<const float4*>(a);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (w > 0) v.x = a[0];
  if (w > 1) v.y = a[1];
  if (w > 2) v.z = a[2];
  if (w > 3) v.w = a[3];
  return v;
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ a, float4 v,
                                       int w) {
  if (kVec) {
    *reinterpret_cast<float4*>(a) = v;
    return;
  }
  if (w > 0) a[0] = v.x;
  if (w > 1) a[1] = v.y;
  if (w > 2) a[2] = v.z;
  if (w > 3) a[3] = v.w;
}

// Thread t < threads: columns 4 (t % groups) .. + 3 of rows [R c, R c + R),
// c = t / groups.
template <bool kVec>
__global__ void __launch_bounds__(kStencilThreads)
stencil_panel_kernel(const float* __restrict__ p, float* __restrict__ y,
                     long long n, int batch, int groups, long long threads,
                     int rows_per_chunk, float lam, float diag, float h,
                     float hh) {
  grid_dependency_wait();
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < threads) {
    const int g = (int)(t % groups);
    const long long i0 = t / groups * rows_per_chunk;
    const long long i1 = i0 + rows_per_chunk < n ? i0 + rows_per_chunk : n;
    const int w = batch - 4 * g < 4 ? batch - 4 * g : 4;
    const float* pc = p + 4 * g;
    float* yc = y + 4 * g;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 dn = i0 > 0 ? load4<kVec>(pc + (i0 - 1) * batch, w) : zero;
    float4 v = load4<kVec>(pc + i0 * batch, w);
    for (long long i = i0; i < i1; i += kRowsInFlight) {
      float4 next[kRowsInFlight];  // rows i + 1 .. i + 4, up to the halo i1
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        const long long r = i + 1 + j;
        next[j] = r <= i1 && r < n ? load4<kVec>(pc + r * batch, w) : zero;
      }
#pragma unroll
      for (int j = 0; j < kRowsInFlight; ++j) {
        if (i + j < i1) {
          store4<kVec>(yc + (i + j) * batch,
                       denoise4(v, next[j], dn, i + j == 0, lam, diag, h, hh),
                       w);
          dn = v;
          v = next[j];
        }
      }
    }
  }
  launch_dependents();
}

// Thread q: rows 4q .. 4q + 3 of the column while q < units (units = n / 4
// with kVec, else n rounded up over 4); with kVec, thread q also takes row
// 4 units + q of the tail when it is below n.
template <bool kVec>
__global__ void __launch_bounds__(kStencilThreads)
stencil_column_kernel(const float* __restrict__ p, float* __restrict__ y,
                      long long n, long long units, float lam, float diag,
                      float h, float hh) {
  grid_dependency_wait();
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long i = 4 * q;
  const bool mine = q < units;
  const int w = mine ? (int)(n - i < 4 ? n - i : 4) : 0;
  const float4 v = mine ? load4<kVec>(p + i, w)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  // Rows i - 1 and i + 4 from the lanes beside this one (every lane takes
  // part); the warp's edges and the last unit's successor are loaded.
  float dn = __shfl_up_sync(kLanes, v.w, 1);
  float up = __shfl_down_sync(kLanes, v.x, 1);
  const int lane = threadIdx.x & 31;
  if (mine && lane == 0) dn = i > 0 ? p[i - 1] : 0.f;
  if (mine && (lane == 31 || q + 1 == units)) up = i + 4 < n ? p[i + 4] : 0.f;
  const long long e = 4 * units + q;
  const bool tail = kVec && e < n;
  float ev = 0.f, eu = 0.f, ed = 0.f;
  if (tail) {
    ev = p[e];
    eu = e + 1 < n ? p[e + 1] : 0.f;
    ed = e > 0 ? p[e - 1] : 0.f;
  }
  launch_dependents();
  if (mine)
    store4<kVec>(y + i,
                 make_float4(denoise(v.x, v.y, dn, i == 0, lam, diag, h, hh),
                             denoise(v.y, v.z, v.x, false, lam, diag, h, hh),
                             denoise(v.z, v.w, v.y, false, lam, diag, h, hh),
                             denoise(v.w, up, v.z, false, lam, diag, h, hh)),
                 w);
  if (tail) y[e] = denoise(ev, eu, ed, e == 0, lam, diag, h, hh);
}

// Blocks of kStencilThreads for `threads` threads.
dim3 stencil_grid(long long threads) {
  return dim3(static_cast<unsigned>((threads + kStencilThreads - 1) /
                                    kStencilThreads));
}

constexpr int kSR = 64;             // rows a thread owns in a tile
constexpr int kSMaxThreads = 512;   // threads of a block: one column
constexpr int kTile = 32;           // transpose tile (kTile x 8 threads)
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory word of tile row e: 4 words of padding every kSR rows.
// Thread t's rows start at word (kSR + 4) t, so its 16-byte reads (8
// threads a phase) fall on 8 distinct 16-byte bank groups, and the tile's
// row-order copies (consecutive words) on distinct banks.
__device__ __forceinline__ int padded(int e) { return e + 4 * (e / kSR); }

// cp.async of the first `bytes` of 16 (zero-filling the rest).
__device__ __forceinline__ void copy16_part(float* dst, const float* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// cp.async rows [i0, i0 + T R) of a contiguous, 16-byte aligned column into
// the tile s, zeros past row n, and waits for them.
__device__ __forceinline__ void stage(float* s, const float* col, int i0,
                                      int n) {
#pragma unroll 4
  for (int k = 0; k < kSR / 4; ++k) {
    const int e = 4 * (k * blockDim.x + threadIdx.x), left = n - i0 - e;
    copy16_part(s + padded(e), col + (left > 0 ? i0 + e : 0),
                left >= 4 ? 16 : left > 0 ? 4 * left : 0);
  }
  copy_commit();
  copy_wait<0>();
  __syncthreads();
}

// Store tile s as rows [i0, i0 + T R) of the column, the rows below n.
__device__ __forceinline__ void unstage(float* col, const float* s, int i0,
                                        int n) {
#pragma unroll 4
  for (int k = 0; k < kSR / 4; ++k) {
    const int e = 4 * (k * blockDim.x + threadIdx.x), i = i0 + e;
    const float4 w = *reinterpret_cast<const float4*>(s + padded(e));
    if (i + 4 <= n) {
      *reinterpret_cast<float4*>(col + i) = w;
    } else {
      if (i < n) col[i] = w.x;
      if (i + 1 < n) col[i + 1] = w.y;
      if (i + 2 < n) col[i + 2] = w.z;
    }
  }
}

// A thread's R rows between the tile and registers (16-byte accesses).
__device__ __forceinline__ void load_chunk(float* v, const float* mine) {
#pragma unroll
  for (int q = 0; q < kSR / 4; ++q) {
    const float4 w = reinterpret_cast<const float4*>(mine)[q];
    v[4 * q] = w.x, v[4 * q + 1] = w.y, v[4 * q + 2] = w.z,
    v[4 * q + 3] = w.w;
  }
}

__device__ __forceinline__ void store_chunk(float* mine, const float* v) {
#pragma unroll
  for (int q = 0; q < kSR / 4; ++q)
    reinterpret_cast<float4*>(mine)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// The coefficients of row i: from row head on, the tail values (c' up to
// row n - 2); below it the rows themselves.  Past the last row both are 0:
// the padding maps keep 0 and pass nothing into row n - 1, as c'_{n-1} = 0
// does.
struct Coefs {
  const float* piv;
  const float* cp;
  int head, n;
  float piv_tail, cp_tail;

  __device__ __forceinline__ float pivot(int i) const {
    if (i >= n) return 0.f;
    return i >= head ? piv_tail : __ldg(piv + i);
  }
  __device__ __forceinline__ float upper(int i) const {
    if (i >= n - 1) return 0.f;
    return i >= head ? cp_tail : __ldg(cp + i);
  }
};

// Forward over a chunk starting at row r0: kCompose builds its map (v: p ->
// beta), else it replays from d (v: beta -> d').  kTail: every row of the
// chunk takes the tail pivot.
template <bool kTail, bool kCompose>
__device__ __forceinline__ float forward_rows(float* v, const Coefs& c,
                                             int r0, float a, float d,
                                             float* A) {
#pragma unroll
  for (int j = 0; j < kSR; ++j) {
    const float pv = kTail ? c.piv_tail : c.pivot(r0 + j), al = -a * pv;
    if (kCompose) {
      v[j] = pv * v[j];
      *A *= al;
    }
    d = fmaf(al, d, v[j]);
    if (!kCompose) v[j] = d;
  }
  return d;
}

// Backward over a chunk, from its last row: kCompose builds its map, else
// it replays from u (v: d' -> y).  kTail: every row takes the tail c'.
template <bool kTail, bool kCompose>
__device__ __forceinline__ float backward_rows(float* v, const Coefs& c,
                                               int r0, float u, float* A) {
#pragma unroll
  for (int j = kSR - 1; j >= 0; --j) {
    const float g = -(kTail ? c.cp_tail : c.upper(r0 + j));
    if (kCompose) *A *= g;
    u = fmaf(g, u, v[j]);
    if (!kCompose) v[j] = u;
  }
  return u;
}

// The value entering this thread's chunk.  Chunk maps x -> A x + B apply in
// the order of q (q = thread forward, T - 1 - thread with kReverse); x0
// enters the first.  An inclusive scan over the lanes of each warp by
// shuffles, one warp over the warp totals, then the lanes before this one:
// a fixed association for a given T.
template <bool kReverse>
__device__ __forceinline__ float chunk_carry(float A, float B, float x0,
                                             float2* warp_map,
                                             float* warp_in) {
  const int nw = blockDim.x >> 5, phys = threadIdx.x & 31;
  const int lane = kReverse ? 31 - phys : phys;
  const int warp = kReverse ? nw - 1 - (int)(threadIdx.x >> 5)
                            : (int)(threadIdx.x >> 5);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float pa = kReverse ? __shfl_down_sync(kFull, A, off)
                              : __shfl_up_sync(kFull, A, off);
    const float pb = kReverse ? __shfl_down_sync(kFull, B, off)
                              : __shfl_up_sync(kFull, B, off);
    if (lane >= off) {
      B = fmaf(A, pb, B);
      A *= pa;
    }
  }
  float ea = kReverse ? __shfl_down_sync(kFull, A, 1)
                      : __shfl_up_sync(kFull, A, 1);
  float eb = kReverse ? __shfl_down_sync(kFull, B, 1)
                      : __shfl_up_sync(kFull, B, 1);
  if (lane == 0) ea = 1.f, eb = 0.f;
  if (lane == 31) warp_map[warp] = make_float2(A, B);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int w = threadIdx.x;
    float wa = 1.f, wb = 0.f;
    if (w < nw) wa = warp_map[w].x, wb = warp_map[w].y;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float pa = __shfl_up_sync(kFull, wa, off);
      const float pb = __shfl_up_sync(kFull, wb, off);
      if (w >= off) {
        wb = fmaf(wa, pb, wb);
        wa *= pa;
      }
    }
    const float before = __shfl_up_sync(kFull, fmaf(wa, x0, wb), 1);
    if (w < nw) warp_in[w] = w == 0 ? x0 : before;
  }
  __syncthreads();
  return fmaf(ea, warp_in[warp], eb);
}

__global__ void __launch_bounds__(kSMaxThreads, 1)
thomas_kernel(const float* p, float* y, long long col_stride,
              const float* __restrict__ cp, const float* __restrict__ piv,
              int n, float a, int head, float piv_tail, float cp_tail) {
  extern __shared__ __align__(16) float tile[];  // T R rows, padded
  __shared__ float2 warp_map[32];
  __shared__ float warp_in[32];
  __shared__ float carry;
  const int T = blockDim.x, rows = T * kSR, tiles = (n + rows - 1) / rows;
  const Coefs c{piv, cp, head, n, piv_tail, cp_tail};
  const float* pc = p + blockIdx.x * col_stride;
  float* yc = y + blockIdx.x * col_stride;
  const int base = threadIdx.x * kSR;  // this thread's first row in a tile
  float* mine = tile + padded(base);
  float v[kSR];

  // Forward: v = p, then beta, then d'.
  float x0 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int i0 = t * rows, r0 = i0 + base;
    const bool tail = r0 >= head && r0 + kSR <= n;
    __syncthreads();  // the tile is free
    stage(tile, pc, i0, n);
    load_chunk(v, mine);
    float A = 1.f;
    const float B = tail ? forward_rows<true, true>(v, c, r0, a, 0.f, &A)
                         : forward_rows<false, true>(v, c, r0, a, 0.f, &A);
    float d = chunk_carry<false>(A, B, x0, warp_map, warp_in);
    d = tail ? forward_rows<true, false>(v, c, r0, a, d, &A)
             : forward_rows<false, false>(v, c, r0, a, d, &A);
    if (t + 1 < tiles) {  // d' of this tile waits in y
      if (threadIdx.x == T - 1) carry = d;
      store_chunk(mine, v);  // every chunk was read before the scan
      __syncthreads();
      unstage(yc, tile, i0, n);
      x0 = carry;
    }
  }

  // Backward, from the last tile (its d' still in v) down: v = y.
  x0 = 0.f;
  for (int t = tiles - 1; t >= 0; --t) {
    const int i0 = t * rows, r0 = i0 + base;
    const bool tail = r0 >= head && r0 + kSR <= n - 1;
    if (t + 1 < tiles) {
      __syncthreads();  // the tile is free
      stage(tile, yc, i0, n);
      load_chunk(v, mine);
    }
    float A = 1.f;
    const float B = tail ? backward_rows<true, true>(v, c, r0, 0.f, &A)
                         : backward_rows<false, true>(v, c, r0, 0.f, &A);
    float u = chunk_carry<true>(A, B, x0, warp_map, warp_in);
    u = tail ? backward_rows<true, false>(v, c, r0, u, &A)
             : backward_rows<false, false>(v, c, r0, u, &A);
    if (threadIdx.x == 0) carry = u;
    store_chunk(mine, v);
    __syncthreads();
    unstage(yc, tile, i0, n);
    x0 = carry;
  }
}

// dst[c * ld_dst + r] = src[r * ld_src + c] for r < rows, c < cols, through
// a padded kTile x kTile tile: reads and writes both along rows.
__global__ void __launch_bounds__(kTile * 8)
transpose_kernel(const float* __restrict__ src, long long ld_src,
                 float* __restrict__ dst, long long ld_dst, int rows,
                 int cols) {
  __shared__ float t[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
#pragma unroll
  for (int k = threadIdx.y; k < kTile; k += 8) {
    const int r = r0 + k, col = c0 + threadIdx.x;
    if (r < rows && col < cols) t[k][threadIdx.x] = src[r * ld_src + col];
  }
  __syncthreads();
#pragma unroll
  for (int k = threadIdx.y; k < kTile; k += 8) {
    const int col = c0 + k, r = r0 + threadIdx.x;
    if (r < rows && col < cols) dst[col * ld_dst + r] = t[threadIdx.x][k];
  }
}

// Whether thomas_solve runs on the panel in place of a transposed copy:
// one contiguous column, 16-byte aligned in and out.
bool direct(const float* p, const float* y, int batch) {
  return batch == 1 && ((reinterpret_cast<size_t>(p) |
                         reinterpret_cast<size_t>(y)) % 16) == 0;
}

cudaError_t transpose(const float* src, long long ld_src, float* dst,
                      long long ld_dst, int rows, int cols,
                      cudaStream_t stream) {
  const dim3 grid((cols + kTile - 1) / kTile, (rows + kTile - 1) / kTile);
  transpose_kernel<<<grid, dim3(kTile, 8), 0, stream>>>(src, ld_src, dst,
                                                        ld_dst, rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p and y are contiguous (n, batch) float32 panels.  Returns the
// cudaError_t of the launch.
int repro_stencil_denoise(const float* p, float* y, long long n, int batch,
                          float lam, float h, void* stream) {
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float diag = 1.0f + h * h, hh = h * h;
  const bool aligned = ((reinterpret_cast<size_t>(p) |
                         reinterpret_cast<size_t>(y)) % 16) == 0;
  const dim3 block(kStencilThreads);
  if (batch == 1) {
    const long long units = aligned ? n / 4 : (n + 3) / 4;
    const long long threads = units > n - 4 * units ? units : n - 4 * units;
    const dim3 grid = stencil_grid(threads);
    return static_cast<int>(
        aligned ? launch_pdl(stencil_column_kernel<true>, grid, block, st, p,
                             y, n, units, lam, diag, h, hh)
                : launch_pdl(stencil_column_kernel<false>, grid, block, st,
                             p, y, n, units, lam, diag, h, hh));
  }
  // Chunks of R rows: the most rows that still give two waves of threads.
  const bool vec = aligned && batch % 4 == 0;
  const int groups = (batch + 3) / 4;
  const long long wave =
      vec ? resident_threads<stencil_panel_kernel<true>, kStencilThreads>()
          : resident_threads<stencil_panel_kernel<false>, kStencilThreads>();
  if (wave == 0) return residency_error();
  const long long want = 2 * wave / groups;  // chunks for two waves
  long long rows = want > 0 ? n / want : n;
  rows = rows >= kRowsInFlight ? rows / kRowsInFlight * kRowsInFlight
                               : (rows > 0 ? rows : 1);
  const long long threads = (n + rows - 1) / rows * groups;
  const dim3 grid = stencil_grid(threads);
  return static_cast<int>(
      vec ? launch_pdl(stencil_panel_kernel<true>, grid, block, st, p, y, n,
                       batch, groups, threads, static_cast<int>(rows), lam,
                       diag, h, hh)
          : launch_pdl(stencil_panel_kernel<false>, grid, block, st, p, y, n,
                       batch, groups, threads, static_cast<int>(rows), lam,
                       diag, h, hh));
}

// p and y are distinct contiguous (n, batch) float32 panels; cp and piv hold
// the n elimination coefficients and pivots; a = lam * h.  Rows head <= i
// < n - 1 have c' = cp_tail, and rows head <= i < n the pivot piv_tail, bit
// for bit (head = n describes any coefficients).  Unless batch is 1 and p
// and y are 16-byte aligned, work holds batch columns of n rounded up to 4
// floats, 16-byte aligned (else it may be null).  One block per column, of
// T threads: as many warps as chunks of kSR rows need, at most
// kSMaxThreads.  Returns the cudaError_t of the launch.
int repro_thomas_solve(const float* p, const float* cp, const float* piv,
                       float* y, int n, int batch, float a, int head,
                       float piv_tail, float cp_tail, float* work,
                       void* stream) {
  if (n == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool in_place = direct(p, y, batch);
  if (!in_place && (work == nullptr ||
                    reinterpret_cast<size_t>(work) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (n + kSR - 1) / kSR;
  const int warps = (chunks + 31) / 32;
  const int threads =
      warps < kSMaxThreads / 32 ? 32 * warps : kSMaxThreads;
  const int rows = threads * kSR;
  const size_t smem = sizeof(float) * (rows + 4 * (rows / kSR));
  cudaError_t rc = cudaFuncSetAttribute(
      thomas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (in_place) {
    thomas_kernel<<<1, threads, smem, st>>>(p, y, 0, cp, piv, n, a, head,
                                            piv_tail, cp_tail);
    return static_cast<int>(cudaGetLastError());
  }
  const long long ld = (n + 3) / 4 * 4;
  rc = transpose(p, batch, work, ld, n, batch, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  thomas_kernel<<<static_cast<unsigned>(batch), threads, smem, st>>>(
      work, work, ld, cp, piv, n, a, head, piv_tail, cp_tail);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(transpose(work, ld, y, batch, batch, n, st));
}

}  // extern "C"
