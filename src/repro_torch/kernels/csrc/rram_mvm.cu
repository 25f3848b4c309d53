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
// Forward design.  A warp sums rows; each warp-wide read of an image is one
// coalesced 128-byte line of a row.  The earlier design (a block a 32 rows)
// lost 11-15 % of the bound (1.514 against 1.282 ms at 16,384 x 32,768 on
// an H100 80GB HBM3) to a tail -- 512 blocks on 396 resident slots, a
// second wave on 29 % of the card -- and to loads by every lane, the bytes
// in flight tied to registers and occupancy.
//
// The cut mirrors the Pallas kernel, which sums each output block over K
// one block_k step after another, so that the order is fixed by K and not
// by the grid.  A unit is (member, tile of kFRows rows, piece of kPiece
// columns of K; the last piece ragged).  A persistent grid of exactly the
// resident blocks P (below) takes the units in order, block b the units [b
// U / P, (b + 1) U / P).  Each unit is summed on its own: lane l of the
// warp that owns a row sums columns l, l + 32, ... of the piece in order
// (FMAs of A_tilde x, then dA x_tilde, a column), then one butterfly across
// the warp gives the row's partial.  Where K is one piece the unit writes
// it to out; otherwise to the unit's workspace slot, and a second kernel
// adds each row's partials in piece order.  So every row's sum depends on
// K alone: the result is the same run to run, whatever the grid, and a
// member of any group equals its solo call bit for bit.
//
// The images reach shared memory by the TMA engine, as in the transposed
// product below: one producer thread keeps a ring of FRing<B>::kStages
// stages full, a stage kFRows rows x kFCols columns of both images (a box
// of each of the same tensor maps) and those columns of x and x_tilde, the
// ring sized by batch to fit the SM's shared memory.  A pre-pass packs the
// (x, x_tilde) pairs b by b into the workspace, so that a stage's share is
// B contiguous runs, bulk copies on the stage's mbarrier (one warp copying
// the pairs element by element cannot keep up with the ring at batch 8: it
// ran at half the bound).  Eight consumer
// warps each read their 2 rows of a stage conflict-free and release it
// after a proxy fence.  A view the TMA engine cannot take runs a
// register-load kernel over the same cut, which stages x and x_tilde in
// shared memory and loads kUnroll column steps ahead; the two kernels sum
// in the same order and agree bit for bit, so every view gets the same
// one-wave layout and a row's result does not depend on how its image is
// stored.  That kernel is 6-12 % slower than the earlier grid's on an H100
// 80GB HBM3; no view the engine makes runs it.
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
// release the stage after a proxy fence.  The bytes in flight -- up to
// three 64 KB stages an SM -- do not depend on registers, and no thread
// issues a load of the images.  The maps' zero fill covers the ragged edge
// of K and M: a live (m, n) view needs no masks.  A view the TMA engine
// cannot take (base or row stride not a multiple of 16 bytes, or no rows
// or columns) runs a register-load kernel over the same kind of cut and
// the same sum pass; the choice is made by alignment alone.
//
// Groups (replaces src/repro/kernels/ops.py::rram_ec_group_mvm / _rmvm, which
// run the same pallas_call once per member under lax.map): both products take
// a member axis, so a whole stack of g same-shape images runs in ONE launch
// (the member is the outer index of the units, and the tensor map's third
// dimension).  Member g's image starts img_stride floats after member
// g-1's; its panel columns start member_ld columns after member g-1's, in
// the same panels (forward: x, xt and out; transposed: y, yt and out), so a
// (rows, g * batch) panel holds member g's columns at g * batch.  A block's
// units may straddle members.  A solo product is the group launch with G =
// 1.
//
// No tensor cores and no TF32 in either direction.
#include <cuda_runtime.h>

#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFRows = 16;                       // rows of a forward unit
constexpr int kRowsPerWarp = kFRows / kWarps;    // its rows a warp sums
constexpr int kPiece = 4096;  // columns of a forward unit: a piece of K
constexpr int kChunk = 512;   // columns of x the register kernel stages
constexpr int kPad = 4;  // row padding of the staged panel against bank conflicts
constexpr int kSteps = kChunk / 32;
constexpr int kUnroll = 8;    // column steps it loads ahead of their use
static_assert(kPiece % kChunk == 0 && kSteps % kUnroll == 0, "chunks");

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
constexpr size_t kSmemMax = 232448;  // a block's most shared memory (227 KB)

// The forward ring at batch B.  A stage holds kFRows rows x kFCols columns
// of both images (one box each) and those columns' (x, x_tilde) pairs, b
// by b; as many stages as fit kSmemMax (6 at batch 1 and 2, 4 at 8).
constexpr int kFCols = kRBox;
constexpr int kFImg = kFRows * kFCols;  // an image's floats a stage
static_assert(kFRows == kRStageRows && kFCols == 256,
              "a forward stage is one box of image_map; the pre-pass's "
              "blocks span a stage");
template <int B>
struct FRing {
  static constexpr size_t kStageBytes = 2 * kFImg * sizeof(float) +
                                        B * kFCols * sizeof(float2) +
                                        2 * sizeof(unsigned long long);
  static constexpr int kStages = (int)(kSmemMax / kStageBytes);
  static constexpr size_t kSmem = kStages * kStageBytes;
  static_assert(kPiece % kFCols == 0 && kStages >= 2, "pieces, ring");
};

// U units shared by P blocks: block b takes units [begin(b), begin(b + 1)).
struct Share {
  long long U;
  int P;
  __host__ __device__ long long begin(int b) const {
    return (long long)b * U / P;
  }
  // The block whose units hold unit u.
  __host__ __device__ int block_of(long long u) const {
    return (int)(((u + 1) * P - 1) / U);
  }
};

// The cut of a forward launch: G members x `tiles` tiles of kFRows rows x
// `pieces` pieces of kPiece columns = U units, unit u = (g * tiles + t) *
// pieces + c.
struct FCut : Share {
  int tiles, pieces;
};

// The cut of a transposed launch: G members x T tiles of W columns x C
// chunks of rows = U units, unit u = (g * T + t) * C + c; a block writes at
// most S partial panels.
struct TCut : Share {
  int W, T, C, S;
};

// The end of a forward unit: each lane's sums of the warp's rows, reduced
// across the warp by one butterfly, go to out when K is one piece and else
// to the unit's slot of the workspace, ws[((g * pieces + c) * tiles *
// kFRows + row) * B + b], for the sum pass.  row0 is the warp's first row
// in the member.
template <int B>
__device__ __forceinline__ void store_unit(float (&acc)[kRowsPerWarp][B],
                                           float* __restrict__ out,
                                           float* __restrict__ ws,
                                           const FCut& cut, int M, int ldx,
                                           int member_ld, int g, int c,
                                           int row0, int lane) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int b = 0; b < B; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[r][b] = 0.f;
      if (lane != 0 || row0 + r >= M) continue;
      if (cut.pieces == 1)
        out[(size_t)(row0 + r) * ldx + (size_t)g * member_ld + b] = v;
      else
        ws[(((long long)g * cut.pieces + c) * cut.tiles * kFRows + row0 + r) *
               B +
           b] = v;
    }
  }
}

// Forward, register loads: warp w of the block sums rows 2 w, 2 w + 1 of
// each unit.  For each kChunk columns of the unit's piece the block stages
// x and x_tilde in shared memory, transposed to [b][k] so that the 32 lanes
// of a warp read 32 consecutive words; lane l reads columns l, l + 32, ...
// of its rows, each warp-wide load one coalesced 128-byte line, kUnroll
// column steps of both rows loaded before they are used.
template <int B>
__global__ void __launch_bounds__(kThreads)
ec_matmul_load_kernel(const float* __restrict__ at,
                      const float* __restrict__ da,
                      const float* __restrict__ x,
                      const float* __restrict__ xt, float* __restrict__ out,
                      float* __restrict__ ws, FCut cut, int M, int K, int lda,
                      int ldx, long long img_stride, int member_ld) {
  __shared__ float xs[2][B][kChunk + kPad];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long u0 = cut.begin(blockIdx.x), u1 = cut.begin(blockIdx.x + 1);
  float acc[kRowsPerWarp][B];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.f;

  for (long long u = u0; u < u1; ++u) {
    const long long tile = u / cut.pieces;
    const int c = (int)(u % cut.pieces), g = (int)(tile / cut.tiles);
    const int row0 = (int)(tile % cut.tiles) * kFRows + warp * kRowsPerWarp;
    const float* at_row[kRowsPerWarp];
    const float* da_row[kRowsPerWarp];
    bool live[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      live[r] = row0 + r < M;
      const size_t off = (size_t)g * img_stride +
                         (live[r] ? (size_t)(row0 + r) * lda : 0);
      at_row[r] = at + off;
      da_row[r] = da + off;
    }
    const size_t col0 = (size_t)g * member_ld;
    const int k_end = min(K, (c + 1) * kPiece);
    for (int k0 = c * kPiece; k0 < k_end; k0 += kChunk) {
      const int kc = min(kChunk, k_end - k0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int idx = threadIdx.x; idx < kc * B; idx += kThreads) {
        const int kk = idx / B, b = idx % B;
        const size_t src = (size_t)(k0 + kk) * ldx + col0 + b;
        xs[0][b][kk] = x[src];
        xs[1][b][kk] = xt[src];
      }
      __syncthreads();

      for (int s0 = 0; s0 < kSteps; s0 += kUnroll) {
        float av[kUnroll][kRowsPerWarp], dv[kUnroll][kRowsPerWarp];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int kk = (s0 + q) * 32 + lane;
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const bool ok = live[r] && kk < kc;
            av[q][r] = ok ? __ldg(at_row[r] + k0 + kk) : 0.f;
            dv[q][r] = ok ? __ldg(da_row[r] + k0 + kk) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          const int kk = (s0 + q) * 32 + lane;
          if (kk < kc) {
#pragma unroll
            for (int b = 0; b < B; ++b) {
              const float xv = xs[0][b][kk];
              const float tv = xs[1][b][kk];
#pragma unroll
              for (int r = 0; r < kRowsPerWarp; ++r) {
                acc[r][b] = fmaf(av[q][r], xv, acc[r][b]);
                acc[r][b] = fmaf(dv[q][r], tv, acc[r][b]);
              }
            }
          }
        }
      }
    }
    store_unit<B>(acc, out, ws, cut, M, ldx, member_ld, g, c, row0, lane);
  }
}

// The staged kernel's x: member g's (x, x_tilde) pairs, b by b, zero past
// K, xp[(g * B + b) * Kp + k] for k < Kp (K rounded up to whole stages),
// so that a stage's share of each b is one contiguous run for a bulk copy.
template <int B>
__global__ void __launch_bounds__(256)
pack_x_kernel(const float* __restrict__ x, const float* __restrict__ xt,
              float2* __restrict__ xp, int K, int Kp, int ldx,
              int member_ld) {
  const int k = blockIdx.x * 256 + threadIdx.x;
  if (k >= Kp) return;
  const size_t src = (size_t)k * ldx + (size_t)blockIdx.y * member_ld;
  float2* dst = xp + (size_t)blockIdx.y * B * Kp + k;
#pragma unroll
  for (int b = 0; b < B; ++b)
    dst[(size_t)b * Kp] = k < K ? make_float2(x[src + b], xt[src + b])
                                : make_float2(0.f, 0.f);
}

// Forward, staged: threads 0..kThreads-1 consume (warp w sums rows 2 w, 2 w
// + 1 of each stage, lane l its columns l, l + 32, ... -- the register
// kernel's order), lane 0 of the last warp produces.  The ring holds the
// stages' image boxes (kFRows x kFCols, A_tilde then dA), then their x
// pairs (B runs of kFCols), then an mbarrier pair a stage.
template <int B>
__global__ void __launch_bounds__(kThreads + 32, 1)
ec_matmul_staged_kernel(const __grid_constant__ CUtensorMap at_map,
                        const __grid_constant__ CUtensorMap da_map,
                        const float2* __restrict__ xp, float* __restrict__ out,
                        float* __restrict__ ws, FCut cut, int M, int K, int Kp,
                        int ldx, int member_ld) {
  using R = FRing<B>;
  extern __shared__ __align__(128) float smem[];
  float2* xs = reinterpret_cast<float2*>(smem + R::kStages * 2 * kFImg);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      xs + R::kStages * B * kFCols);
  unsigned long long* empty = full + R::kStages;
  const long long u0 = cut.begin(blockIdx.x), u1 = cut.begin(blockIdx.x + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + s, 1);        // the producer's expect_tx arrive
      mbar_init(empty + s, kWarps);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer
    if (threadIdx.x > kThreads) return;
    int i = 0;
    for (long long u = u0; u < u1; ++u) {
      const long long tile = u / cut.pieces;
      const int c = (int)(u % cut.pieces), g = (int)(tile / cut.tiles);
      const int row0 = (int)(tile % cut.tiles) * kFRows;
      const int k_end = min(K, (c + 1) * kPiece);
      for (int k0 = c * kPiece; k0 < k_end; k0 += kFCols, ++i) {
        const int s = i % R::kStages;
        if (i >= R::kStages) mbar_wait(empty + s, (i / R::kStages - 1) & 1);
        float* img = smem + s * 2 * kFImg;
        mbar_expect(full + s, 2 * kFImg * sizeof(float) +
                                  B * kFCols * sizeof(float2));
        tensor_copy_3d(img, &at_map, k0, row0, g, full + s);
        tensor_copy_3d(img + kFImg, &da_map, k0, row0, g, full + s);
#pragma unroll
        for (int b = 0; b < B; ++b)
          bulk_copy_tx(xs + (s * B + b) * kFCols,
                       xp + ((size_t)g * B + b) * Kp + k0,
                       kFCols * sizeof(float2), full + s);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  float acc[kRowsPerWarp][B];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int b = 0; b < B; ++b) acc[r][b] = 0.f;
  int i = 0;
  for (long long u = u0; u < u1; ++u) {
    const long long tile = u / cut.pieces;
    const int c = (int)(u % cut.pieces), g = (int)(tile / cut.tiles);
    const int row0 = (int)(tile % cut.tiles) * kFRows + warp * kRowsPerWarp;
    const int k_end = min(K, (c + 1) * kPiece);
    for (int k0 = c * kPiece; k0 < k_end; k0 += kFCols, ++i) {
      const int s = i % R::kStages;
      mbar_wait(full + s, (i / R::kStages) & 1);
      const float* a =
          smem + s * 2 * kFImg + warp * kRowsPerWarp * kFCols + lane;
      const float* d = a + kFImg;
      const float2* xv = xs + s * B * kFCols + lane;
#pragma unroll
      for (int j = 0; j < kFCols / 32; ++j) {
        float av[kRowsPerWarp], dv[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          av[r] = a[j * 32 + r * kFCols];
          dv[r] = d[j * 32 + r * kFCols];
        }
#pragma unroll
        for (int b = 0; b < B; ++b) {
          const float2 w = xv[b * kFCols + j * 32];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            acc[r][b] = fmaf(av[r], w.x, acc[r][b]);
            acc[r][b] = fmaf(dv[r], w.y, acc[r][b]);
          }
        }
      }
      proxy_fence();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    store_unit<B>(acc, out, ws, cut, M, ldx, member_ld, g, c, row0, lane);
  }
}

// out[row * ldx + g * member_ld + b] for the 256 rows from 256 * blockIdx.x
// of member g = blockIdx.y: the sum of the row's partials of the C pieces,
// in piece order.
__global__ void __launch_bounds__(256)
piece_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                 FCut cut, int M, int batch, int ldx, int member_ld) {
  const int row = blockIdx.x * 256 + threadIdx.x;
  if (row >= M) return;
  const long long piece = (long long)cut.tiles * kFRows * batch;
  const float* src =
      ws + ((long long)blockIdx.y * cut.pieces * cut.tiles * kFRows + row) *
               batch;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < cut.pieces; ++c, src += piece)
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (b < batch) sum[b] += src[b];
  float* dst = out + (size_t)row * ldx + (size_t)blockIdx.y * member_ld;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (b < batch) dst[b] = sum[b];
}

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
__device__ __forceinline__ void flush(float* __restrict__ ws, const TCut& cut,
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
                         TCut cut, int M, int ldy, int member_ld) {
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
    proxy_fence();
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
                       TCut cut, int M, int K, int lda, int ldy,
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
                   TCut cut, int K, int batch, int ldz, int member_ld) {
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

// What one launch runs: the kernel (staged or register loads), its
// residency, the cut (FCut forward, TCut transposed) and the workspace it
// needs.
template <class Cut>
struct Layout {
  bool staged;
  int per_sm, sms;
  Cut cut;
  long long ws_floats;
};

// The TMA engine takes the images: 16-byte aligned bases and row (and
// member) strides, and at least one row and one column.
bool tma_view(const float* at, const float* da, int G, long long img_stride,
              int M, int K, int lda) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  return M > 0 && K > 0 && aligned(at) && aligned(da) && lda % 4 == 0 &&
         (G == 1 || img_stride % 4 == 0);
}

// Blocks of `kernel` that fit on one SM (its occupancy with `smem` bytes of
// dynamic shared memory, which the kernel is allowed first) and the SM count
// of the current device, asked once per device: known[dev] = {per_sm, sms},
// 0 until asked.
cudaError_t residency(const void* kernel, int threads, size_t smem,
                      int (*known)[2], int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int* got = known[dev];
  if (got[0] == 0) {
    int n = 0, count = 0;
    rc = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess && smem > 0)
      rc = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                         smem);
    if (rc != cudaSuccess) return rc;
    if (n < 1) return cudaErrorInvalidConfiguration;
    got[1] = count;
    got[0] = n;
  }
  *per_sm = got[0];
  *sms = got[1];
  return cudaSuccess;
}

// The residency of the instance a launch runs at batch B.
template <int B>
cudaError_t resident(bool forward, bool staged, int* per_sm, int* sms) {
  static int known[2][2][kMaxDevices][2];
  if (forward && staged)
    return residency((const void*)ec_matmul_staged_kernel<B>, kThreads + 32,
                     FRing<B>::kSmem, known[1][1], per_sm, sms);
  if (forward)
    return residency((const void*)ec_matmul_load_kernel<B>, kThreads, 0,
                     known[1][0], per_sm, sms);
  if (staged)
    return residency((const void*)ec_rmatmul_staged_kernel<B>,
                     kRStagedThreads, staged_smem(B), known[0][1], per_sm,
                     sms);
  return residency((const void*)ec_rmatmul_load_kernel<B>, kRLoadCols, 0,
                   known[0][0], per_sm, sms);
}

// K rounded up to whole forward stages.
int padded_k(int K) { return (K + kFCols - 1) / kFCols * kFCols; }

// Blocks for U units: as many as are resident, at most one a unit.
template <class Cut>
int blocks(const Layout<Cut>& L, long long U) {
  const long long slots = (long long)L.per_sm * L.sms;
  return (int)(slots < U ? slots : U);
}

// The forward layout: a workspace slot a unit when K is more than one
// piece, and then, staged, the packed x pairs.
template <int B>
cudaError_t layout(bool staged, int G, int M, int K, Layout<FCut>* L) {
  L->staged = staged;
  const cudaError_t rc = resident<B>(true, staged, &L->per_sm, &L->sms);
  if (rc != cudaSuccess) return rc;
  FCut& cut = L->cut;
  cut.tiles = (M + kFRows - 1) / kFRows;
  cut.pieces = K > kPiece ? (K + kPiece - 1) / kPiece : 1;
  cut.U = (long long)G * cut.tiles * cut.pieces;
  cut.P = blocks(*L, cut.U);
  L->ws_floats = (cut.pieces > 1 ? cut.U * kFRows * B : 0) +
                 (staged ? 2LL * G * B * padded_k(K) : 0);
  return cudaSuccess;
}

// The transposed layout (K >= 1): at most S partial panels a block, since a
// block's U / P (rounded up) units straddle at most (most - 1) / C + 2
// tiles.
template <int B>
cudaError_t layout(bool staged, int G, int M, int K, Layout<TCut>* L) {
  L->staged = staged;
  const cudaError_t rc = resident<B>(false, staged, &L->per_sm, &L->sms);
  if (rc != cudaSuccess) return rc;
  TCut& cut = L->cut;
  const int rows = staged ? kRStageRows : kRLoadRows;
  cut.W = staged ? kRCols : kRLoadCols;
  cut.T = (K + cut.W - 1) / cut.W;
  cut.C = M > 0 ? (M + rows - 1) / rows : 1;
  cut.U = (long long)G * cut.T * cut.C;
  cut.P = blocks(*L, cut.U);
  const long long most = (cut.U + cut.P - 1) / cut.P;
  cut.S = (int)((most - 1) / cut.C + 2);
  L->ws_floats = (long long)cut.P * cut.S * cut.W * B;
  return cudaSuccess;
}

// The layout of a launch in the direction of L's cut at this batch, staged
// where the TMA engine takes the images.
template <class Cut>
cudaError_t layout_for(const float* at, const float* da, int G,
                       long long img_stride, int M, int K, int lda, int batch,
                       Layout<Cut>* L) {
  const bool staged = tma_view(at, da, G, img_stride, M, K, lda);
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
cudaError_t launch_f(const Layout<FCut>& L, const float* at, const float* da,
                     const float* x, const float* xt, float* out, float* ws,
                     int G, long long img_stride, int member_ld, int M, int K,
                     int lda, int ldx, cudaStream_t stream) {
  if (L.cut.U == 0) return cudaSuccess;
  cudaError_t rc = cudaSuccess;
  if (L.staged) {
    CUtensorMap at_map, da_map;
    rc = image_map(&at_map, at, G, img_stride, M, K, lda);
    if (rc == cudaSuccess)
      rc = image_map(&da_map, da, G, img_stride, M, K, lda);
    if (rc != cudaSuccess) return rc;
    const int Kp = padded_k(K);
    float2* xp = reinterpret_cast<float2*>(
        ws + (L.cut.pieces > 1 ? L.cut.U * kFRows * B : 0));
    pack_x_kernel<B><<<dim3(Kp / 256, G), 256, 0, stream>>>(
        x, xt, xp, K, Kp, ldx, member_ld);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    ec_matmul_staged_kernel<B><<<L.cut.P, kThreads + 32, FRing<B>::kSmem,
                                 stream>>>(at_map, da_map, xp, out, ws, L.cut,
                                           M, K, Kp, ldx, member_ld);
  } else {
    ec_matmul_load_kernel<B><<<L.cut.P, kThreads, 0, stream>>>(
        at, da, x, xt, out, ws, L.cut, M, K, lda, ldx, img_stride,
        member_ld);
  }
  rc = cudaGetLastError();
  if (rc != cudaSuccess || L.cut.pieces == 1) return rc;
  piece_sum_kernel<<<dim3((M + 255) / 256, G), 256, 0, stream>>>(
      ws, out, L.cut, M, B, ldx, member_ld);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_t(const Layout<TCut>& L, const float* at, const float* da,
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

bool bad_call(int G, int M, int K, int batch) {
  return batch < 1 || batch > 8 || bad_group(G) || K < 0 || M < 0;
}

// layout[0..8]: the workspace a launch needs (floats), 1 if the staged (TMA)
// kernel runs and 0 for register loads, blocks, blocks resident an SM, SMs,
// units, rows a unit, columns a unit, and last, forward: pieces of K;
// transposed: partial panels a block.
void report(const Layout<FCut>& L, long long* layout) {
  const long long got[9] = {L.ws_floats, L.staged, L.cut.P, L.per_sm,
                            L.sms,       L.cut.U,  kFRows,  kPiece,
                            L.cut.pieces};
  for (int i = 0; i < 9; ++i) layout[i] = got[i];
}

void report(const Layout<TCut>& L, long long* layout) {
  const long long got[9] = {L.ws_floats,
                            L.staged,
                            L.cut.P,
                            L.per_sm,
                            L.sms,
                            L.cut.U,
                            L.staged ? kRStageRows : kRLoadRows,
                            L.cut.W,
                            L.cut.S};
  for (int i = 0; i < 9; ++i) layout[i] = got[i];
}

}  // namespace

extern "C" {

// The layout repro_ec_matmul chooses for these images (their pointers
// matter only through their alignment) at this batch on the current device,
// written to layout[0..8] (see report).  Returns a cudaError_t.
int repro_ec_matmul_workspace(const float* at, const float* da, int G,
                              long long img_stride, int M, int K, int lda,
                              int batch, long long* layout) {
  if (bad_call(G, M, K, batch)) return static_cast<int>(cudaErrorInvalidValue);
  Layout<FCut> L;
  const cudaError_t rc =
      layout_for(at, da, G, img_stride, M, K, lda, batch, &L);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  report(L, layout);
  return static_cast<int>(cudaSuccess);
}

// p_g = at_g x_g + da_g xt_g for G members of (M, K) images of row stride
// lda >= K (member g at g * img_stride) and (K, batch) panels x, xt (member
// g's columns at g * member_ld); p_g is written to columns [g * member_ld,
// g * member_ld + batch) of out.  x, xt and out have row stride ldx.  ws
// holds ws_floats floats, at least what repro_ec_matmul_workspace asks for
// (none, and ws may be null, when K is one piece).  batch must be 1..8 (the
// wrapper splits wider panels).  Returns the cudaError_t of the launches.
int repro_ec_matmul(const float* at, const float* da, const float* x,
                    const float* xt, float* out, float* ws,
                    long long ws_floats, int G, long long img_stride,
                    int member_ld, int M, int K, int lda, int batch, int ldx,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_call(G, M, K, batch)) return static_cast<int>(cudaErrorInvalidValue);
  Layout<FCut> L;
  cudaError_t rc = layout_for(at, da, G, img_stride, M, K, lda, batch, &L);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (L.ws_floats > 0 && (ws == nullptr || ws_floats < L.ws_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (batch) {
#define REPRO_CASE(b)                                                       \
  case b:                                                                   \
    rc = launch_f<b>(L, at, da, x, xt, out, ws, G, img_stride, member_ld, M, \
                     K, lda, ldx, s);                                       \
    break;
    REPRO_CASE(1) REPRO_CASE(2) REPRO_CASE(3) REPRO_CASE(4)
    REPRO_CASE(5) REPRO_CASE(6) REPRO_CASE(7) REPRO_CASE(8)
#undef REPRO_CASE
  }
  return static_cast<int>(rc);
}

// The layout repro_ec_rmatmul chooses for these images, as
// repro_ec_matmul_workspace reports the forward one.
int repro_ec_rmatmul_workspace(const float* at, const float* da, int G,
                               long long img_stride, int M, int K, int lda,
                               int batch, long long* layout) {
  if (bad_call(G, M, K, batch)) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 9; ++i) layout[i] = 0;
  if (K == 0) return static_cast<int>(cudaSuccess);
  Layout<TCut> L;
  const cudaError_t rc =
      layout_for(at, da, G, img_stride, M, K, lda, batch, &L);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  report(L, layout);
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
  if (bad_call(G, M, K, batch)) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return static_cast<int>(cudaSuccess);
  Layout<TCut> L;
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
