// Fused tier-1 error-corrected product  p = A_tilde @ x + dA @ x_tilde.
//
// Replaces src/repro/kernels/rram_mvm.py::ec_matmul (_ec_matmul_kernel), which
// the JAX engine calls as a (batch, Np) x (Np, Mp) product on transposed
// views.  Here the product is taken straight in the engine's layout: A_tilde
// and dA are row-major (M, K), x and x_tilde are (K, batch) panels with row
// stride ldx, p is (M, batch) with row stride ldx.  No transpose is made.
//
// Bound: at batch <= 8 this is a GEMV.  It must read A_tilde and dA once each,
// 2*M*K*4 bytes, against 4*M*K*batch flops, so it is bound by device memory
// (at batch 8 the flops take about a fifth of the byte time on an H100).
//
// Design: a block owns kRowsPerBlock rows (kRowsPerWarp per warp).  It walks K
// in chunks of kChunk columns; for each chunk it stages x and x_tilde into
// shared memory, transposed to [b][k] so that the 32 lanes of a warp read 32
// consecutive words.  Lane l of a warp reads columns l, l+32, ... of its rows,
// so each warp-wide load is one coalesced 128-byte line of A_tilde or dA;
// kUnroll column steps of all kRowsPerWarp rows are loaded before they are
// used, which keeps 2*kUnroll*kRowsPerWarp loads in flight per lane.  Sums
// are fp32 FMAs, per lane over its columns, then a butterfly across the warp.
// No tensor cores and no TF32.
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

template <int B>
__global__ void __launch_bounds__(kThreads)
ec_matmul_kernel(const float* __restrict__ at, const float* __restrict__ da,
                 const float* __restrict__ x, const float* __restrict__ xt,
                 float* __restrict__ out, int M, int K, int ldx) {
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
    at_row[r] = at + row * (size_t)K;
    da_row[r] = da + row * (size_t)K;
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

template <int B>
void launch(const float* at, const float* da, const float* x, const float* xt,
            float* out, int M, int K, int ldx, cudaStream_t stream) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock);
  ec_matmul_kernel<B><<<grid, kThreads, 0, stream>>>(at, da, x, xt, out, M, K,
                                                     ldx);
}

}  // namespace

extern "C" {

// Columns [0, batch) of the panels starting at x, xt and out; their row
// stride is ldx >= batch.  batch must be 1..8 (the wrapper splits wider
// panels).  Returns the cudaError_t of the launch.
int repro_ec_matmul(const float* at, const float* da, const float* x,
                    const float* xt, float* out, int M, int K, int batch,
                    int ldx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (batch) {
    case 1: launch<1>(at, da, x, xt, out, M, K, ldx, s); break;
    case 2: launch<2>(at, da, x, xt, out, M, K, ldx, s); break;
    case 3: launch<3>(at, da, x, xt, out, M, K, ldx, s); break;
    case 4: launch<4>(at, da, x, xt, out, M, K, ldx, s); break;
    case 5: launch<5>(at, da, x, xt, out, M, K, ldx, s); break;
    case 6: launch<6>(at, da, x, xt, out, M, K, ldx, s); break;
    case 7: launch<7>(at, da, x, xt, out, M, K, ldx, s); break;
    case 8: launch<8>(at, da, x, xt, out, M, K, ldx, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
