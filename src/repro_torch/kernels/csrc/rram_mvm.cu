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
// Transposed design.  The contraction runs down the image's rows, so a
// thread owns columns and sums them over rows.  Device memory bounds it as
// it does the forward product, but the earlier design lost 16 % of its
// bound (3.059 against 2.564 ms at 32,768^2 on an H100 80GB HBM3) to two
// things.  (1) A tail: 32,768 columns make few column tiles, so the rows
// were split into slabs, and a grid of whole slabs per tile overshot the
// card's resident slots (1,152 blocks on 1,056: 8 % of the image read by a
// second wave on a fraction of the SMs).  (2) Loads: 4-byte loads by every
// thread, the bytes in flight tied to registers and occupancy.
//
// (1) The work is cut in units -- (member, column tile of kRCols, chunk of
// kRStageRows rows) -- and a persistent grid of exactly as many blocks P as
// the launched instance keeps resident (its occupancy with its dynamic
// shared memory, asked of the runtime, times the SM count; one an SM here)
// takes them in order: block b takes units [b U / P, (b + 1) U / P), the
// same share to within one unit, in one wave.  Each time a block leaves a
// tile it writes its partial column panel (kRCols x batch) to its own slot
// of a workspace, and a second kernel adds each tile's partials in block
// order (at most 2 at the main path's shapes; a few us).  The cut depends on
// (G, M, K, batch, the SM count, the occupancy) alone: the result is the
// same run to run, and a group of one equals the solo call bit for bit (a
// member of a larger group is cut otherwise than alone: equal to fp32
// rounding).  A unit's rows are summed apart before they join the tile's
// sums, which keeps the rounding error near the parent's.
//
// (2) The images reach shared memory by the TMA engine.  One producer warp
// keeps a ring of kRStages stages full; a stage is kRStageRows rows x kRCols
// columns of both images (kRBoxes boxes each of a 3-D tensor map over (g,
// M, K) with row stride lda, encoded on the host) and the rows' slab of y
// and y_tilde (cp.async), 64 KB in all, and completes on an mbarrier.  Eight
// consumer warps read their columns of a stage as conflict-free rows (lane
// l, the float2 at 2 l), sum batch products of each image per column, and
// release the stage.  The bytes in flight -- up to three 64 KB stages an SM
// -- do not depend on registers, and no thread issues a load of the
// images.  The maps' zero fill covers the ragged edge of K and M: a live (m,
// n) view needs no masks.  A view the TMA engine cannot take (base or row
// stride not a multiple of 16 bytes, or no rows) runs a register-load
// kernel over the same kind of cut and the same sum pass; the choice is
// made by alignment alone.
//
// Groups (replaces src/repro/kernels/ops.py::rram_ec_group_mvm / _rmvm, which
// run the same pallas_call once per member under lax.map): both products take
// a member axis, so a whole stack of g same-shape images runs in ONE launch
// (forward: blockIdx.y; transposed: the member is the outer index of the
// units, and the tensor map's third dimension).  Member g's image starts
// img_stride floats after member g-1's; its panel columns start member_ld
// columns after member g-1's, in the same panels (forward: x, xt and out;
// transposed: y, yt and out), so a (rows, g * batch) panel holds member g's
// columns at g * batch.  A block's units may straddle members.  A solo
// product is the group launch with G = 1.
//
// No tensor cores and no TF32 in either direction.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kChunk = 512;
constexpr int kPad = 4;  // row padding of the staged panel against bank conflicts
constexpr int kSteps = kChunk / 32;
constexpr int kUnroll = 4;

constexpr int kRConsumers = 256;  // consumer threads of the staged kernel
constexpr int kRVec = 2;          // neighbouring columns a consumer owns
                                  // (one float2 of each image a row)
constexpr int kRCols = kRConsumers * kRVec;  // columns of a staged unit
constexpr int kRStageRows = 16;   // its rows
constexpr int kRStages = 3;       // the ring's stages
constexpr int kRBox = 256;        // columns of one TMA box (its most)
constexpr int kRBoxes = kRCols / kRBox;  // boxes an image a stage
constexpr int kRStagedThreads = kRConsumers + 32;  // + a producer warp
constexpr int kRLoadCols = 256;   // columns of a unit, register kernel
constexpr int kRLoadRows = 32;    // rows of a unit of the register kernel
constexpr int kRUnroll = 8;       // rows it loads ahead of their use
constexpr int kImgFloats = kRStageRows * kRCols;  // an image's share a stage
constexpr int kMaxDevices = 64;
static_assert(kRVec == 2 && kRCols % kRBox == 0, "float2 reads, boxes");

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

// The cut of one transposed launch: G members x T column tiles of W
// columns x C row chunks = U units, unit u = (g * T + t) * C + c; P blocks,
// block b takes units [begin(b), begin(b + 1)) and writes at most S partial
// panels.
struct Cut {
  int W, T, C, P, S;
  long long U;
  __host__ __device__ long long begin(int b) const {
    return (long long)b * U / P;
  }
  // The block whose units hold unit u.
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * P - 1) / U);
  }
};

// Dynamic shared memory of the staged kernel: the ring's image boxes, its
// (y, y_tilde) slabs and an mbarrier pair a stage.
__host__ __device__ constexpr size_t staged_smem(int B) {
  return kRStages * (2 * kImgFloats * sizeof(float) +
                     kRStageRows * B * sizeof(float2) +
                     2 * sizeof(unsigned long long));
}

// Where a block leaves a tile: the partial sums of its V columns from col
// on to slot (tile - first tile of the block) of its workspace,
// ws[((block * S + slot) * W + col) * B + b], and the sums restart.
template <int B, int V>
__device__ __forceinline__ void flush(float* __restrict__ ws, const Cut& cut,
                                      long long slot, int col,
                                      float (&acc)[V][B]) {
  float* dst =
      ws + (((long long)blockIdx.x * cut.S + slot) * cut.W + col) * B;
#pragma unroll
  for (int v = 0; v < V; ++v)
#pragma unroll
    for (int b = 0; b < B; ++b) {
      dst[v * B + b] = acc[v][b];
      acc[v][b] = 0.f;
    }
}

// Staged: threads 0..kRConsumers-1 consume (columns kRVec * threadIdx.x ..
// of each unit's tile), the last warp produces.  A stage holds, for each
// image, kRBoxes boxes of kRStageRows x kRBox, box j the tile's columns
// j * kRBox ...
template <int B>
__global__ void __launch_bounds__(kRStagedThreads, 1)
ec_rmatmul_staged_kernel(const __grid_constant__ CUtensorMap at_map,
                         const __grid_constant__ CUtensorMap da_map,
                         const float* __restrict__ y,
                         const float* __restrict__ yt, float* __restrict__ ws,
                         Cut cut, int M, int ldy, int member_ld) {
  extern __shared__ __align__(128) float smem[];
  float2* ys = reinterpret_cast<float2*>(smem + kRStages * 2 * kImgFloats);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ys + kRStages * kRStageRows * B);
  unsigned long long* empty = full + kRStages;
  const long long u0 = cut.begin(blockIdx.x), u1 = cut.begin(blockIdx.x + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRStages; ++s) {
      mbar_init(full + s, 1 + 32);  // the expect_tx arrive + 32 copy arrives
      mbar_init(empty + s, kRConsumers / 32);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kRConsumers) {  // the producer warp
    const int lane = threadIdx.x - kRConsumers;
    const long long tile = u0 / cut.C;
    int c = (int)(u0 % cut.C), t = (int)(tile % cut.T), g = (int)(tile / cut.T);
    for (long long u = u0; u < u1; ++u) {
      const int i = (int)(u - u0), s = i % kRStages;
      if (i >= kRStages) mbar_wait(empty + s, (i / kRStages - 1) & 1);
      float* img = smem + s * 2 * kImgFloats;
      if (lane == 0) {
        mbar_expect(full + s, 2 * kImgFloats * sizeof(float));
#pragma unroll
        for (int j = 0; j < kRBoxes; ++j) {
          const int box = j * kRStageRows * kRBox;
          tensor_copy_3d(img + box, &at_map, t * kRCols + j * kRBox,
                         c * kRStageRows, g, full + s);
          tensor_copy_3d(img + kImgFloats + box, &da_map,
                         t * kRCols + j * kRBox, c * kRStageRows, g,
                         full + s);
        }
      }
      float2* slab = ys + s * kRStageRows * B;
      const int r0 = c * kRStageRows;
      for (int e = lane; e < kRStageRows * B; e += 32) {
        const int r = e / B, b = e % B;
        const bool ok = r0 + r < M;
        const size_t src =
            ok ? (size_t)(r0 + r) * ldy + (size_t)g * member_ld + b : 0;
        copy4(&slab[e].x, y + src, ok);
        copy4(&slab[e].y, yt + src, ok);
      }
      copy_arrive(full + s);
      if (++c == cut.C) {
        c = 0;
        if (++t == cut.T) t = 0, ++g;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // A unit's rows are summed apart and then added to the tile's sums: the
  // rounding error grows with the units, not with the rows.
  const int col = threadIdx.x * kRVec;
  const int at_col = (col / kRBox) * kRStageRows * kRBox + col % kRBox;
  const long long first = u0 / cut.C;
  long long tile = first;
  int c = (int)(u0 % cut.C);
  float acc[kRVec][B];
#pragma unroll
  for (int v = 0; v < kRVec; ++v)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[v][b] = 0.f;
  for (long long u = u0; u < u1; ++u) {
    const int i = (int)(u - u0), s = i % kRStages;
    mbar_wait(full + s, (i / kRStages) & 1);
    const float* a = smem + s * 2 * kImgFloats + at_col;
    const float* d = a + kImgFloats;
    const float2* slab = ys + s * kRStageRows * B;
    float part[kRVec][B];
#pragma unroll
    for (int v = 0; v < kRVec; ++v)
#pragma unroll
      for (int b = 0; b < B; ++b) part[v][b] = 0.f;
#pragma unroll
    for (int r = 0; r < kRStageRows; ++r) {
      const float2 av = *reinterpret_cast<const float2*>(a + r * kRBox);
      const float2 dv = *reinterpret_cast<const float2*>(d + r * kRBox);
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float2 w = slab[r * B + b];
        part[0][b] = fmaf(av.x, w.x, part[0][b]);
        part[0][b] = fmaf(dv.x, w.y, part[0][b]);
        part[1][b] = fmaf(av.y, w.x, part[1][b]);
        part[1][b] = fmaf(dv.y, w.y, part[1][b]);
      }
    }
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + s);
#pragma unroll
    for (int v = 0; v < kRVec; ++v)
#pragma unroll
      for (int b = 0; b < B; ++b) acc[v][b] += part[v][b];
    if (++c == cut.C || u + 1 == u1) {
      flush<B, kRVec>(ws, cut, tile - first, col, acc);
      if (c == cut.C) c = 0, ++tile;
    }
  }
}

// Register loads, for views the TMA engine cannot take: thread col of each
// unit's tile loads kRUnroll rows of both images ahead of their use; y and
// y_tilde of the unit's rows are staged in shared memory.
template <int B>
__global__ void __launch_bounds__(kRLoadCols)
ec_rmatmul_load_kernel(const float* __restrict__ at,
                       const float* __restrict__ da,
                       const float* __restrict__ y,
                       const float* __restrict__ yt, float* __restrict__ ws,
                       Cut cut, int M, int K, int lda, int ldy,
                       long long img_stride, int member_ld) {
  __shared__ float2 ys[kRLoadRows * B];
  const long long u0 = cut.begin(blockIdx.x), u1 = cut.begin(blockIdx.x + 1);
  const int col = threadIdx.x;
  const long long first = u0 / cut.C;
  long long tile = first;
  int c = (int)(u0 % cut.C);
  float acc[1][B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[0][b] = 0.f;
  for (long long u = u0; u < u1; ++u) {
    const int g = (int)(tile / cut.T);
    const int k = (int)(tile % cut.T) * kRLoadCols + col;
    const int r0 = c * kRLoadRows, rows = min(kRLoadRows, M - r0);
    __syncthreads();  // every thread is done with the previous slab of y
    for (int e = col; e < kRLoadRows * B; e += kRLoadCols) {
      const int r = e / B, b = e % B;
      const size_t src = (size_t)(r0 + r) * ldy + (size_t)g * member_ld + b;
      ys[e] = r < rows ? make_float2(y[src], yt[src]) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    const bool live = k < K;
    const size_t off =
        (size_t)g * img_stride + (size_t)r0 * lda + (live ? k : 0);
    for (int r = 0; r < rows; r += kRUnroll) {
      float av[kRUnroll], dv[kRUnroll];
#pragma unroll
      for (int q = 0; q < kRUnroll; ++q) {
        const bool ok = live && r + q < rows;
        av[q] = ok ? __ldg(at + off + (size_t)(r + q) * lda) : 0.f;
        dv[q] = ok ? __ldg(da + off + (size_t)(r + q) * lda) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kRUnroll; ++q) {
        if (r + q < rows) {
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const float2 v = ys[(r + q) * B + b];
            acc[0][b] = fmaf(av[q], v.x, acc[0][b]);
            acc[0][b] = fmaf(dv[q], v.y, acc[0][b]);
          }
        }
      }
    }
    if (++c == cut.C || u + 1 == u1) {
      flush<B, 1>(ws, cut, tile - first, col, acc);
      if (c == cut.C) c = 0, ++tile;
    }
  }
}

// out[k * ldz + g * member_ld + b] for the 256 columns k from 256 *
// blockIdx.x of member blockIdx.y: the sum of the partials of k's tile,
// block by block in order.
__global__ void __launch_bounds__(256)
partial_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                   Cut cut, int K, int batch, int ldz, int member_ld) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= K) return;
  const long long tile = (long long)blockIdx.y * cut.T + k / cut.W;
  const int col = k % cut.W;
  const int first = cut.block_of(tile * cut.C);
  const int last = cut.block_of(tile * cut.C + cut.C - 1);
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int blk = first; blk <= last; ++blk) {
    const long long slot = tile - cut.begin(blk) / cut.C;
    const float* src =
        ws + (((long long)blk * cut.S + slot) * cut.W + col) * batch;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (b < batch) sum[b] += src[b];
  }
  float* dst = out + (size_t)k * ldz + (size_t)blockIdx.y * member_ld;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (b < batch) dst[b] = sum[b];
}

template <int B>
void launch(const float* at, const float* da, const float* x, const float* xt,
            float* out, int G, long long img_stride, int member_ld, int M,
            int K, int lda, int ldx, cudaStream_t stream) {
  const dim3 grid((M + kRowsPerBlock - 1) / kRowsPerBlock, G);
  ec_matmul_kernel<B><<<grid, kThreads, 0, stream>>>(
      at, da, x, xt, out, M, K, lda, ldx, img_stride, member_ld);
}

// What one transposed launch runs: the kernel (staged or register loads),
// its residency, the cut and the workspace it needs.
struct Layout {
  bool staged;
  int per_sm, sms, rows;
  Cut cut;
  long long ws_floats;
};

// The TMA engine takes the images: 16-byte aligned bases and row (and
// member) strides, and at least one row.
bool tma_view(const float* at, const float* da, int G, long long img_stride,
              int M, int lda) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return M > 0 && aligned(at) && aligned(da) && lda % 4 == 0 &&
         (G == 1 || img_stride % 4 == 0);
}

// Blocks of the transposed instance that fit on one SM (its occupancy, with
// its dynamic shared memory) and the SM count of the current device, asked
// once per device.
template <int B>
cudaError_t resident(bool staged, int* per_sm, int* sms) {
  static int known[2][kMaxDevices][2];  // {per_sm, sms}; 0: not asked yet
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* got = known[staged][dev];
  if (got[0] == 0) {
    int n = 0, count = 0;
    rc = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess && staged) {
      rc = cudaFuncSetAttribute(ec_rmatmul_staged_kernel<B>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)staged_smem(B));
      if (rc == cudaSuccess)
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, ec_rmatmul_staged_kernel<B>, kRStagedThreads, staged_smem(B));
    } else if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, ec_rmatmul_load_kernel<B>, kRLoadCols, 0);
    }
    if (rc != cudaSuccess) return rc;
    if (n < 1) return cudaErrorInvalidConfiguration;
    got[1] = count;
    got[0] = n;
  }
  *per_sm = got[0];
  *sms = got[1];
  return cudaSuccess;
}

// The layout of a transposed launch (K >= 1): units of `rows` rows, as many
// blocks as are resident (at most one a unit), at most S partial panels a
// block: a block's U / P (rounded up) units straddle at most
// (most - 1) / C + 2 tiles.
template <int B>
cudaError_t layout(bool staged, int G, int M, int K, Layout* L) {
  L->staged = staged;
  cudaError_t rc = resident<B>(staged, &L->per_sm, &L->sms);
  if (rc != cudaSuccess) return rc;
  L->rows = staged ? kRStageRows : kRLoadRows;
  Cut& cut = L->cut;
  cut.W = staged ? kRCols : kRLoadCols;
  cut.T = (K + cut.W - 1) / cut.W;
  cut.C = M > 0 ? (M + L->rows - 1) / L->rows : 1;
  cut.U = (long long)G * cut.T * cut.C;
  const long long slots = (long long)L->per_sm * L->sms;
  cut.P = (int)(slots < cut.U ? slots : cut.U);
  const long long most = (cut.U + cut.P - 1) / cut.P;
  cut.S = (int)((most - 1) / cut.C + 2);
  L->ws_floats = (long long)cut.P * cut.S * cut.W * B;
  return cudaSuccess;
}

cudaError_t layout_for(const float* at, const float* da, int G,
                       long long img_stride, int M, int K, int lda, int batch,
                       Layout* L) {
  const bool staged = tma_view(at, da, G, img_stride, M, lda);
  switch (batch) {
#define REPRO_CASE(b) \
  case b:             \
    return layout<b>(staged, G, M, K, L);
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  return cudaErrorInvalidValue;
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (so the
// library needs no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (rc != cudaSuccess) return rc;
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return cudaSuccess;
}

// The tensor map of G images (K, M) of row stride lda floats, member g at
// g * img_stride floats, read in boxes of kRStageRows x kRBox; elements
// outside the images read as zeros.
cudaError_t image_map(CUtensorMap* map, const float* img, int G,
                      long long img_stride, int M, int K, int lda) {
  EncodeTiled encode = nullptr;
  const cudaError_t rc = encode_tiled(&encode);
  if (rc != cudaSuccess) return rc;
  const long long member = G > 1 ? img_stride : (long long)lda * M;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)lda * sizeof(float),
                                 (cuuint64_t)member * sizeof(float)};
  const cuuint32_t box[3] = {kRBox, kRStageRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(img), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int B>
cudaError_t launch_t(const Layout& L, const float* at, const float* da,
                     const float* y, const float* yt, float* ws, int G,
                     long long img_stride, int member_ld, int M, int K,
                     int lda, int ldy, cudaStream_t stream) {
  if (L.staged) {
    CUtensorMap at_map, da_map;
    cudaError_t rc = image_map(&at_map, at, G, img_stride, M, K, lda);
    if (rc == cudaSuccess)
      rc = image_map(&da_map, da, G, img_stride, M, K, lda);
    if (rc != cudaSuccess) return rc;
    ec_rmatmul_staged_kernel<B><<<L.cut.P, kRStagedThreads, staged_smem(B),
                                  stream>>>(at_map, da_map, y, yt, ws, L.cut,
                                            M, ldy, member_ld);
  } else {
    ec_rmatmul_load_kernel<B><<<L.cut.P, kRLoadCols, 0, stream>>>(
        at, da, y, yt, ws, L.cut, M, K, lda, ldy, img_stride, member_ld);
  }
  return cudaGetLastError();
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


// The layout repro_ec_rmatmul chooses for these images (their pointers
// matter only through their alignment) at this batch on the current device,
// written to layout[0..8]: the workspace it needs (floats), 1 if the staged
// (TMA) kernel runs and 0 for register loads, blocks, blocks resident an
// SM, SMs, units, rows a unit, columns a unit, partial panels a block.
// Returns a cudaError_t.
int repro_ec_rmatmul_workspace(const float* at, const float* da, int G,
                               long long img_stride, int M, int K, int lda,
                               int batch, long long* layout) {
  if (batch < 1 || batch > 8 || bad_group(G) || K < 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i) layout[i] = 0;
  if (K == 0) return static_cast<int>(cudaSuccess);
  Layout L;
  const cudaError_t rc =
      layout_for(at, da, G, img_stride, M, K, lda, batch, &L);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long report[9] = {L.ws_floats, L.staged, L.cut.P,
                               L.per_sm,    L.sms,    L.cut.U,
                               L.rows,      L.cut.W,  L.cut.S};
  for (int i = 0; i < 9; ++i) layout[i] = report[i];
  return static_cast<int>(cudaSuccess);
}

// z_g = at_g^T y_g + da_g^T yt_g for G members of (M, K) images of row
// stride lda (member g at g * img_stride) and (M, batch) panels y, yt of row
// stride ldy (member g's columns at g * member_ld); z_g is written to
// columns [g * member_ld, g * member_ld + batch) of out, row stride ldz.  ws
// holds ws_floats floats, at least what repro_ec_rmatmul_workspace asks for.
// batch must be 1..8.  Returns the cudaError_t of the launches.
int repro_ec_rmatmul(const float* at, const float* da, const float* y,
                     const float* yt, float* out, float* ws,
                     long long ws_floats, int G, long long img_stride,
                     int member_ld, int M, int K, int lda, int batch, int ldy,
                     int ldz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1 || batch > 8 || bad_group(G) || K < 0 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  Layout L;
  cudaError_t rc = layout_for(at, da, G, img_stride, M, K, lda, batch, &L);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (ws == nullptr || ws_floats < L.ws_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (batch) {
#define REPRO_CASE(b)                                                     \
  case b:                                                                 \
    rc = launch_t<b>(L, at, da, y, yt, ws, G, img_stride, member_ld, M, K, \
                     lda, ldy, s);                                        \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  partial_sum_kernel<<<dim3((K + 255) / 256, G), 256, 0, s>>>(
      ws, out, L.cut, K, batch, ldz, member_ld);
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
