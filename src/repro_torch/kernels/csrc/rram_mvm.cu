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
                 float* __restrict__ out, int M, int K, int lda, int ldx) {
  __shared__ float xs[2][B][kChunk + kPad];
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

// Slab blockIdx.y of rows [y0, y0 + rows_per_split) against kRThreads
// columns; writes dst[(blockIdx.y * K + col) * ldd + b].
template <int B>
__global__ void __launch_bounds__(kRThreads)
ec_rmatmul_kernel(const float* __restrict__ at, const float* __restrict__ da,
                  const float* __restrict__ y, const float* __restrict__ yt,
                  float* __restrict__ dst, int M, int K, int lda, int ldy,
                  int rows_per_split, int ldd) {
  __shared__ float ys[2][kRRows][B];
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

// out[k * ldz + b] = sum over s of ws[(s * K + k) * batch + b], s in order.
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 int K, int batch, int splits, int ldz) {
  const long long total = (long long)K * batch;
  for (long long idx = blockIdx.x * (long long)kThreads + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * total + idx];
    const long long k = idx / batch, b = idx % batch;
    out[k * ldz + b] = s;
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
// each of `sms` SMs, each slab at least one staged step of rows.  (32,768^2
// on 132 SMs: 128 column tiles x 9 slabs; 32,768 x 16,384: 17 slabs.)
int rmatmul_splits(int M, int K, int sms) {
  const int tiles = (K + kRThreads - 1) / kRThreads;
  const int want = (sms * kRBlocksPerSm + tiles - 1) / tiles;
  const int most = (M + kRRows - 1) / kRRows;
  const int splits = want < most ? want : most;
  return splits > 1 ? splits : 1;
}

template <int B>
void launch(const float* at, const float* da, const float* x, const float* xt,
            float* out, int M, int K, int lda, int ldx, cudaStream_t stream) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  ec_matmul_kernel<B><<<grid, kThreads, 0, stream>>>(at, da, x, xt, out, M, K,
                                                     lda, ldx);
}

template <int B>
void launch_t(const float* at, const float* da, const float* y,
              const float* yt, float* dst, int M, int K, int lda, int ldy,
              int splits, int rows_per_split, int ldd, cudaStream_t stream) {
  const dim3 grid((K + kRThreads - 1) / kRThreads, splits);
  ec_rmatmul_kernel<B><<<grid, kRThreads, 0, stream>>>(
      at, da, y, yt, dst, M, K, lda, ldy, rows_per_split, ldd);
}

}  // namespace

extern "C" {

// Columns [0, batch) of the panels starting at x, xt and out; their row
// stride is ldx >= batch, the images' row stride lda >= K.  batch must be
// 1..8 (the wrapper splits wider panels).  Returns the cudaError_t of the
// launch.
int repro_ec_matmul(const float* at, const float* da, const float* x,
                    const float* xt, float* out, int M, int K, int lda,
                    int batch, int ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (batch) {
    case 1: launch<1>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 2: launch<2>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 3: launch<3>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 4: launch<4>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 5: launch<5>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 6: launch<6>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 7: launch<7>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    case 8: launch<8>(at, da, x, xt, out, M, K, lda, ldx, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Floats of workspace repro_ec_rmatmul needs for these M, K and batch on
// the current device, written to *floats (0: one slab, no workspace).
// Returns a cudaError_t.
int repro_ec_rmatmul_workspace(int M, int K, int batch, long long* floats) {
  int sms = 0;
  const cudaError_t rc = device_sms(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int splits = rmatmul_splits(M, K, sms);
  *floats = splits > 1 ? (long long)splits * K * batch : 0;
  return static_cast<int>(cudaSuccess);
}

// z = at^T y + da^T yt for (M, K) images of row stride lda and (M, batch)
// panels y, yt of row stride ldy; z is written to columns [0, batch) of out,
// row stride ldz.  ws holds ws_floats floats, at least what
// repro_ec_rmatmul_workspace asks for (may be null when that is 0).  batch
// must be 1..8.  Returns the cudaError_t of the launches.
int repro_ec_rmatmul(const float* at, const float* da, const float* y,
                     const float* yt, float* out, float* ws,
                     long long ws_floats, int M, int K, int lda, int batch,
                     int ldy, int ldz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 8) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t rc = device_sms(&sms);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int splits = rmatmul_splits(M, K, sms);
  if (splits > 1 && (ws == nullptr ||
                     ws_floats < (long long)splits * K * batch))
    return static_cast<int>(cudaErrorInvalidValue);
  // Whole staged slabs per split; slabs past M sum nothing and write zeros.
  const int per = (M + splits - 1) / splits;
  const int rows_per_split = (per + kRRows - 1) / kRRows * kRRows;
  float* dst = splits == 1 ? out : ws;
  const int ldd = splits == 1 ? ldz : batch;
  switch (batch) {
#define REPRO_CASE(b)                                                   \
  case b:                                                               \
    launch_t<b>(at, da, y, yt, dst, M, K, lda, ldy, splits,            \
                rows_per_split, ldd, s);                                \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return static_cast<int>(rc);
  const long long total = (long long)K * batch;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
  split_sum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      ws, out, K, batch, splits, ldz);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
