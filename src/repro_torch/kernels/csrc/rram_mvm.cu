// Fused tier-1 error-corrected products, both directions, on one image:
//
//   ec_matmul   p = A_tilde @ x + dA @ x_tilde        (forward,    (M, batch))
//   ec_rmatmul  z = A_tilde^T @ y + dA^T @ y_tilde    (transposed, (K, batch))
//
// Replaces src/repro/kernels/rram_mvm.py::ec_matmul (_ec_matmul_kernel), which
// the JAX engine calls as a (batch, Np) x (Np, Mp) product on transposed views
// forward and reads backwards as (batch, Mp) x (Mp, Np) for A.T @ y
// (src/repro/engine.py:613, kernels/ops.py:128).  Here both products are taken
// straight in the engine's layout: A_tilde and dA are row-major (M, K) with
// row stride lda >= K (so one capacity block of a padded image runs as a view,
// without a copy); the input panels have row stride ldx (ldy), the output
// panel row stride ldx (ldz).  No transpose is made.
//
// Bound: at batch <= 8 each is a GEMV over the image.  It must read A_tilde
// and dA once each, 2*M*K*4 bytes, against 4*M*K*batch flops, so device
// memory bounds it (at batch 8 the flops take about a fifth of the byte time
// on an H100).
//
// Forward design: a block owns kRowsPerBlock rows (kRowsPerWarp per warp).  It
// walks K in chunks of kChunk columns; for each chunk it stages x and x_tilde
// into shared memory, transposed to [b][k] so that the 32 lanes of a warp read
// 32 consecutive words.  Lane l of a warp reads columns l, l+32, ... of its
// rows, so each warp-wide load is one coalesced 128-byte line of A_tilde or
// dA; kUnroll column steps of all kRowsPerWarp rows are loaded before they are
// used, which keeps 2*kUnroll*kRowsPerWarp loads in flight per lane.  Sums are
// fp32 FMAs, per lane over its columns, then a butterfly across the warp.
//
// Transposed design: the contraction now runs down the image's rows, so a
// thread owns one column and a warp reads 32 neighbouring columns of one row
// (one coalesced 128-byte line per warp-wide load, as forward).  A block owns
// kRThreads columns and a slab of rows; y and y_tilde for kRRows rows of the
// slab are staged in shared memory as [r][b] and read by every thread as a
// broadcast; kRUnroll rows of both images are loaded before they are used.
// K = 32,768 columns give only 128 column tiles, too few blocks for 132 SMs,
// so the rows are split into slabs (grid.y), as many as give every SM of the
// current device kRBlocksPerSm blocks.  Each slab writes its partial sums to
// a (splits, K, batch) workspace and a second kernel adds them in slab order:
// the result is deterministic, run to run.  With one slab the first kernel
// writes the output directly.  The caller sizes the workspace by
// repro_ec_rmatmul_workspace; the launch layout is decided here alone.
//
// Groups (replaces src/repro/kernels/ops.py::rram_ec_group_mvm / _rmvm, which
// run the same pallas_call once per member under lax.map): both kernels take
// a member axis in the grid (blockIdx.y forward, blockIdx.z transposed), so a
// whole stack of g same-shape images runs in ONE launch.  Member g's image
// starts img_stride floats after member g-1's; its panel columns start
// member_ld columns after member g-1's, in the same panels (forward: x, xt
// and out; transposed: y, yt and out), so a (rows, g * batch) panel holds
// member g's columns at g * batch.  The transposed launcher chooses its slab
// count for the whole grid (g column tiles per image), not for one image.
// A solo product is the group launch with G = 1.
//
// No tensor cores and no TF32 in either direction.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 512;
constexpr int kPad = 4;  // row padding of the staged panel against bank conflicts
constexpr int kSteps = kChunk / 32;
constexpr int kUnroll = 4;

constexpr int kRThreads = 256;  // columns of the image per transposed block
constexpr int kRRows = 64;      // rows of y / y_tilde staged at a time
constexpr int kRUnroll = 8;     // rows of the images loaded ahead of their use
constexpr int kRBlocksPerSm = 8;  // blocks the transposed launch gives each SM

template <int B>
__global__ void __launch_bounds__(kThreads)
ec_matmul_kernel(const float* __restrict__ at, const float* __restrict__ da,
                 const float* __restrict__ x, const float* __restrict__ xt,
                 float* __restrict__ out, int M, int K, int lda, int ldx,
                 long long img_stride, int member_ld) {
  __shared__ float xs[2][B][kChunk + kPad];
  const size_t member = blockIdx.y;
  at += member * img_stride;
  da += member * img_stride;
  x += member * member_ld;
  xt += member * member_ld;
  out += member * member_ld;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  const float* at_row[kRowsPerWarp];
  const float* da_row[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    live[r] = row0 + r < M;
    const size_t row = live[r] ? (size_t)(row0 + r) : 0;
    at_row[r] = at + row * (size_t)lda;
    da_row[r] = da + row * (size_t)lda;
  }

  float acc[kRowsPerWarp][B];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kc = min(kChunk, K - k0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int idx = threadIdx.x; idx < kc * B; idx += kThreads) {
      const int kk = idx / B, b = idx % B;
      const size_t g = (size_t)(k0 + kk) * ldx + b;
      xs[0][b][kk] = x[g];
      xs[1][b][kk] = xt[g];
    }
    __syncthreads();

    for (int s0 = 0; s0 < kSteps; s0 += kUnroll) {
      float av[kUnroll][kRowsPerWarp], dv[kUnroll][kRowsPerWarp];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = (s0 + u) * 32 + lane;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const bool ok = live[r] && kk < kc;
          av[u][r] = ok ? __ldg(at_row[r] + k0 + kk) : 0.f;
          dv[u][r] = ok ? __ldg(da_row[r] + k0 + kk) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = (s0 + u) * 32 + lane;
        if (kk < kc) {
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float xv = xs[0][b][kk];
            const float tv = xs[1][b][kk];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              acc[r][b] = fmaf(av[u][r], xv, acc[r][b]);
              acc[r][b] = fmaf(dv[u][r], tv, acc[r][b]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && live[r]) out[(size_t)(row0 + r) * ldx + b] = v;
    }
  }
}

// Member blockIdx.z, slab blockIdx.y of rows [y0, y0 + rows_per_split)
// against kRThreads columns; writes dst[member * dst_member +
// (blockIdx.y * K + col) * ldd + b].
template <int B>
__global__ void __launch_bounds__(kRThreads)
ec_rmatmul_kernel(const float* __restrict__ at, const float* __restrict__ da,
                  const float* __restrict__ y, const float* __restrict__ yt,
                  float* __restrict__ dst, int M, int K, int lda, int ldy,
                  int rows_per_split, int ldd, long long img_stride,
                  int member_ld, long long dst_member) {
  __shared__ float ys[2][kRRows][B];
  const size_t member = blockIdx.z;
  at += member * img_stride;
  da += member * img_stride;
  y += member * member_ld;
  yt += member * member_ld;
  dst += member * dst_member;
  const int col = blockIdx.x * kRThreads + threadIdx.x;
  const bool live = col < K;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const float* at_col = at + (live ? col : 0);
  const float* da_col = da + (live ? col : 0);

  float acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kRRows) {
    const int rc = min(kRRows, r_end - r0);
    __syncthreads();  // every thread is done with the previous slab of y
    for (int idx = threadIdx.x; idx < rc * B; idx += kRThreads) {
      const int rr = idx / B, b = idx % B;
      const size_t g = (size_t)(r0 + rr) * ldy + b;
      ys[0][rr][b] = y[g];
      ys[1][rr][b] = yt[g];
    }
    __syncthreads();
    if (!live) continue;
    for (int s = 0; s < rc; s += kRUnroll) {
      float av[kRUnroll], dv[kRUnroll];
#pragma unroll
      for (int u = 0; u < kRUnroll; ++u) {
        const size_t off = (size_t)(r0 + s + u) * lda;
        const bool ok = s + u < rc;
        av[u] = ok ? __ldg(at_col + off) : 0.f;
        dv[u] = ok ? __ldg(da_col + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kRUnroll; ++u) {
        if (s + u < rc) {  // staged rows past rc are stale
#pragma unroll
          for (int b = 0; b < B; ++b) {
            acc[b] = fmaf(av[u], ys[0][s + u][b], acc[b]);
            acc[b] = fmaf(dv[u], ys[1][s + u][b], acc[b]);
          }
        }
      }
    }
  }
  if (live) {
    float* d = dst + ((size_t)blockIdx.y * K + col) * ldd;
#pragma unroll
    for (int b = 0; b < B; ++b) d[b] = acc[b];
  }
}

// out[k * ldz + g * member_ld + b] = sum over s of
// ws[((g * splits + s) * K + k) * batch + b], s in order.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 int G, int K, int batch, int splits, int ldz, int member_ld) {
  const long long per = (long long)K * batch;
  const long long total = per * G;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    const long long g = idx / per, rem = idx % per;
    const float* src = ws + g * splits * per + rem;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += src[sp * per];
    const long long k = rem / batch, b = rem % batch;
    out[k * ldz + g * member_ld + b] = s;
  }
}

cudaError_t device_sms(int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return rc;
}

// Row slabs of one transposed launch: enough blocks for kRBlocksPerSm on
// each of `sms` SMs over all G members' column tiles, each slab at least one
// staged step of rows.  (32,768^2 on 132 SMs: 128 column tiles x 9 slabs;
// 32,768 x 16,384: 17 slabs; 8 members of 16,384 x 4,096: 8 x 16 tiles x 9.)
int rmatmul_splits(int G, int M, int K, int sms) {
  const int tiles = (K + kRThreads - 1) / kRThreads * G;
  const int want = (sms * kRBlocksPerSm + tiles - 1) / tiles;
  const int most = (M + kRRows - 1) / kRRows;
  const int splits = want < most ? want : most;
  return splits > 1 ? splits : 1;
}

template <int B>
void launch(const float* at, const float* da, const float* x, const float* xt,
            float* out, int G, long long img_stride, int member_ld, int M,
            int K, int lda, int ldx, cudaStream_t stream) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, G);
  ec_matmul_kernel<B><<<grid, kThreads, 0, stream>>>(
      at, da, x, xt, out, M, K, lda, ldx, img_stride, member_ld);
}

template <int B>
void launch_t(const float* at, const float* da, const float* y,
              const float* yt, float* dst, int G, long long img_stride,
              int member_ld, long long dst_member, int M, int K, int lda,
              int ldy, int splits, int rows_per_split, int ldd,
              cudaStream_t stream) {
  const dim3 grid((K + kRThreads - 1) / kRThreads, splits, G);
  ec_rmatmul_kernel<B><<<grid, kRThreads, 0, stream>>>(
      at, da, y, yt, dst, M, K, lda, ldy, rows_per_split, ldd, img_stride,
      member_ld, dst_member);
}

bool bad_group(int G) { return G < 1 || G > 65535; }

}  // namespace

extern "C" {

// G members: member g's images start g * img_stride floats in, its panel
// columns g * member_ld columns in.  Columns [0, batch) of each member's
// panels starting at x, xt and out; their row stride is ldx, the images'
// row stride lda >= K.  batch must be 1..8 (the wrapper splits wider
// panels).  Returns the cudaError_t of the launch.
int repro_ec_matmul(const float* at, const float* da, const float* x,
                    const float* xt, float* out, int G, long long img_stride,
                    int member_ld, int M, int K, int lda, int batch, int ldx,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_group(G)) return static_cast<int>(cudaErrorInvalidValue);
  switch (batch) {
#define REPRO_CASE(b)                                                   \
  case b:                                                               \
    launch<b>(at, da, x, xt, out, G, img_stride, member_ld, M, K, lda,  \
              ldx, s);                                                  \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of workspace repro_ec_rmatmul needs for G members of M x K at this
// batch on the current device, written to *floats (0: one slab, no
// workspace).  Returns a cudaError_t.
int repro_ec_rmatmul_workspace(int G, int M, int K, int batch,
                               long long* floats) {
  int sms = 0;
  const cudaError_t rc = device_sms(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int splits = rmatmul_splits(G, M, K, sms);
  *floats = splits > 1 ? (long long)G * splits * K * batch : 0;
  return static_cast<int>(cudaSuccess);
}

// z_g = at_g^T y_g + da_g^T yt_g for G members of (M, K) images of row
// stride lda (member g at g * img_stride) and (M, batch) panels y, yt of row
// stride ldy (member g's columns at g * member_ld); z_g is written to
// columns [g * member_ld, g * member_ld + batch) of out, row stride ldz.  ws
// holds ws_floats floats, at least what repro_ec_rmatmul_workspace asks for
// (may be null when that is 0).  batch must be 1..8.  Returns the
// cudaError_t of the launches.
int repro_ec_rmatmul(const float* at, const float* da, const float* y,
                     const float* yt, float* out, float* ws,
                     long long ws_floats, int G, long long img_stride,
                     int member_ld, int M, int K, int lda, int batch, int ldy,
                     int ldz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 8 || bad_group(G))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t rc = device_sms(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int splits = rmatmul_splits(G, M, K, sms);
  if (splits > 1 && (ws == nullptr ||
                     ws_floats < (long long)G * splits * K * batch))
    return static_cast<int>(cudaErrorInvalidValue);
  // Whole staged slabs per split; slabs past M sum nothing and write zeros.
  const int per = (M + splits - 1) / splits;
  const int rows_per_split = (per + kRRows - 1) / kRRows * kRRows;
  float* dst = splits == 1 ? out : ws;
  const int ldd = splits == 1 ? ldz : batch;
  const long long dst_member =
      splits == 1 ? member_ld : (long long)splits * K * batch;
  switch (batch) {
#define REPRO_CASE(b)                                                   \
  case b:                                                               \
    launch_t<b>(at, da, y, yt, dst, G, img_stride, member_ld,          \
                dst_member, M, K, lda, ldy, splits, rows_per_split,    \
                ldd, s);                                                \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  const long long total = (long long)G * K * batch;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  split_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      ws, out, G, K, batch, splits, ldz, member_ld);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
