// Fused gated matcher for Hopper (sm_90a): for each query row, the gated
// (best, second, argmin) of the L1 descriptor distance over all target
// slots, with no (N1, N2) array stored.
//
// Replaces libviso_tpu/ops/pallas_fused_match.py::fused_gated_two_min
// (_make_kernel + _tile_pass).  It takes a leading problem axis of B
// problems, each with its own fundamental matrix F and Sampson switch
// use_epi (radius and Sampson threshold are shared), so a frame's 3 match
// problems, or a serving timestep's 3 S, are one launch.
//
// The gate of pair (q, t) is: |qx - tx| + |qy - ty| < radius, both slots
// valid, and when use_epi the Sampson distance of (q, t) under F at most
// the threshold with a denominator above 1e-30.  The Sampson terms are
// written expression by expression as _tile_pass writes them, with
// __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc contracts nothing into an
// FMA: every gate decision is the plain PyTorch version's, bit for bit.
// Per row the result is the lexicographic minimum of (distance, column)
// over the admitted columns -- a tie goes to the lowest column -- and the
// smallest remaining distance; a row with no candidate gives
// (inf, inf, -1).  The ratio test and final validity stay with the caller.
//
// What bounds it: the L1 sums, as in l1_distance.cu -- at (3, 1280, 1280,
// 128) 0.63 G |a - b| accumulations of two FP32 instructions each, plus at
// least one instruction a pair to fold it into its row.  Fused, no
// (B, N1, N2) distance array is written or read back.
//
// What the design does about it:
// - The card is filled by splitting the target axis inside one launch: a
//   thread-block cluster of kSplit CTAs shares 64 query rows of one
//   problem, and each CTA sweeps a contiguous 1/kSplit of the target tiles.
//   The CTAs' partial (best, second, idx) meet in distributed shared
//   memory, merged in (value, column) order, which is exact, so the split
//   changes no bit.  At (3, 1280, 128) that is 120 CTAs of 8 warps, one an
//   SM, where CTAs of 32 rows sweeping all targets gave 120 CTAs of 4
//   warps.  Splits of 4, 5 and 8 (more, smaller CTAs) measured slower at
//   both shapes, and no split twice as slow at (3, 1280, 128).
// - The CTA's 64 x D query descriptors stay resident in shared memory; the
//   target tiles (128 slots) stream through a ring of kStages slices of 32
//   values filled by cp.async, one barrier a slice (l1_tile.cuh).  The gate
//   data of the CTA's target columns is computed once, up front.
// - Each thread keeps a 4 x 8 micro-tile of sums read by float4 loads
//   (12 shared loads per 256 FADDs); the compiled loop over a slice is
//   83 % FADD.  The query slices go unpadded (their loads are broadcasts),
//   so two CTAs fit an SM (81 KB of shared memory each at D = 128, 128
//   registers a thread): 16 warps.
// - Gates cost only where they can matter: a pair whose sum is not below
//   its row's running second cannot change the row's two smallest, so it is
//   dropped before any gate is evaluated; then position (an invalid slot
//   has x = NaN, which fails it), and only then Sampson and its division.
// Each thread folds its 8 columns in ascending order, and the 16 threads of
// a row (consecutive lanes) merge by warp shuffles in (value, column)
// order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "l1_tile.cuh"
#include "two_min.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMR = 4;                   // query rows per thread
constexpr int kRows = 64;                // query rows per CTA
constexpr int kCols = 128;               // target slots per tile
constexpr int kSplit = 2;                // CTAs per cluster, along targets
constexpr int kStages = 2;               // slices in flight
constexpr int kMinCTAs = 2;              // per SM: at most 128 registers
constexpr int kTX = kCols / 8;           // threads along a row
constexpr int kThreads = (kRows / kMR) * kTX;
constexpr int kSliceF4 = kCols * l1tile::kPitch;
using two_min::kBig;
using two_min::kTiny;
using two_min::merge;
using two_min::TwoMin;

__global__ void __launch_bounds__(kThreads, kMinCTAs)
fused_gated_kernel(const float* __restrict__ q_xy,
                   const uint8_t* __restrict__ q_valid,
                   const float* __restrict__ q_d,
                   const float* __restrict__ t_xy,
                   const uint8_t* __restrict__ t_valid,
                   const float* __restrict__ t_d,
                   const float* __restrict__ F,
                   const uint8_t* __restrict__ use_epi,
                   float* __restrict__ best_out,
                   float* __restrict__ second_out,
                   int* __restrict__ idx_out, int N1, int N2, int D,
                   float radius, float sampson_thresh) {
  // dynamic: the resident query slices, kStages ring slots of target
  // slices, and the gate data of the CTA's target columns
  extern __shared__ float4 smem[];
  static_assert(kTX >= 8, "unpadded query slices need broadcast loads");
  __shared__ float4 qg[kRows];   // qx (NaN: no candidate), qy, a1, a2
  __shared__ float2 qh[kRows];   // a3, a1 a1 + a2 a2
  __shared__ TwoMin part[kRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the CTA's rank in its cluster
  const int row0 = blockIdx.y * kRows;
  const int p = blockIdx.z;
  q_xy += static_cast<size_t>(p) * N1 * 2;
  q_valid += static_cast<size_t>(p) * N1;
  q_d += static_cast<size_t>(p) * N1 * D;
  t_xy += static_cast<size_t>(p) * N2 * 2;
  t_valid += static_cast<size_t>(p) * N2;
  t_d += static_cast<size_t>(p) * N2 * D;
  float f[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) f[k] = F[p * 9 + k];
  const bool epi = use_epi[p] != 0;
  const float nan = __int_as_float(0x7fc00000);

  const int n_slices = (D + l1tile::kSlice - 1) / l1tile::kSlice;
  const int n_tiles = (N2 + kCols - 1) / kCols;
  const int tile0 = split * n_tiles / kSplit;
  const int n_mine = (split + 1) * n_tiles / kSplit - tile0;
  const int n_steps = n_mine * n_slices;
  float4* qd = smem;   // unpadded: pitch kChunks
  float4* ring = qd + n_slices * kRows * l1tile::kChunks;
  float4* cols = ring + kStages * kSliceF4;

  // step k: slice k % n_slices of tile tile0 + k / n_slices
  auto issue = [&](int k) {
    l1tile::stage<kCols, kThreads>(t_d, N2, D, (tile0 + k / n_slices) * kCols,
                                   (k % n_slices) * l1tile::kSlice,
                                   ring + (k % kStages) * kSliceF4);
  };

  // the query descriptors (in the first copy group) and the first stages
  for (int s = 0; s < n_slices; ++s)
    l1tile::stage<kRows, kThreads, l1tile::kChunks>(
        q_d, N1, D, row0, s * l1tile::kSlice,
        qd + s * kRows * l1tile::kChunks);
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_steps) issue(k);
    l1tile::cp_async_commit();
  }
  // while they land: the CTA's target columns, position (x NaN when
  // invalid) and the column halves of Sampson (F' x2 at t: b1, b2,
  // squared); the query rows, position and the row halves (F x1 at q: a1,
  // a2, a3; a1 a1 + a2 a2)
  for (int c = threadIdx.x; c < n_mine * kCols; c += kThreads) {
    const int j = tile0 * kCols + c;
    const float x = j < N2 ? t_xy[2 * j] : 0.f;
    const float y = j < N2 ? t_xy[2 * j + 1] : 0.f;
    const float b1 = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x),
                                         __fmul_rn(f[3], y)), f[6]);
    const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(f[1], x),
                                         __fmul_rn(f[4], y)), f[7]);
    cols[c] = make_float4(j < N2 && t_valid[j] ? x : nan, y,
                          __fmul_rn(b1, b1), __fmul_rn(b2, b2));
  }
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int q = row0 + r;
    const float x = q < N1 ? q_xy[2 * q] : 0.f;
    const float y = q < N1 ? q_xy[2 * q + 1] : 0.f;
    const float a1 = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x),
                                         __fmul_rn(f[1], y)), f[2]);
    const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(f[3], x),
                                         __fmul_rn(f[4], y)), f[5]);
    const float a3 = __fadd_rn(__fadd_rn(__fmul_rn(f[6], x),
                                         __fmul_rn(f[7], y)), f[8]);
    qg[r] = make_float4(q < N1 && q_valid[q] ? x : nan, y, a1, a2);
    qh[r] = make_float2(a3, __fadd_rn(__fmul_rn(a1, a1), __fmul_rn(a2, a2)));
  }

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  float acc[kMR][8] = {};
  TwoMin run[kMR];
#pragma unroll
  for (int i = 0; i < kMR; ++i) run[i] = TwoMin{kBig, kBig, -1};

  for (int k = 0; k < n_steps; ++k) {
    l1tile::cp_async_wait<kStages - 2>();  // step k has landed ...
    __syncthreads();  // ... for every thread, and step k - 1 is consumed
    if (k + kStages - 1 < n_steps) issue(k + kStages - 1);
    l1tile::cp_async_commit();
    const int s = k % n_slices;
    l1tile::accumulate<kMR, kCols, l1tile::kChunks>(
        qd + s * kRows * l1tile::kChunks, ring + (k % kStages) * kSliceF4,
        ty, tx, acc);
    if (s != n_slices - 1) continue;
    // the tile is summed: fold its columns, in ascending order, into the
    // running two smallest of each row
    const int col0 = (tile0 + k / n_slices) * kCols;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = l1tile::micro_col<kCols>(tx, j);
      const float4 t = cols[col0 - tile0 * kCols + c];
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const float v = acc[i][j];
        acc[i][j] = 0.f;
        if (!(v < run[i].second)) continue;  // changes neither of the two
        const float4 q = qg[kMR * ty + i];
        const float pos = __fadd_rn(fabsf(__fsub_rn(q.x, t.x)),
                                    fabsf(__fsub_rn(q.y, t.y)));
        if (!(pos < radius)) continue;
        if (epi) {
          const float2 h = qh[kMR * ty + i];
          const float e = __fadd_rn(__fadd_rn(__fmul_rn(t.x, q.z),
                                              __fmul_rn(t.y, q.w)), h.x);
          const float num = __fmul_rn(e, e);
          const float den = __fadd_rn(__fadd_rn(h.y, t.z), t.w);
          const float sd = __fdiv_rn(num, fmaxf(den, kTiny));
          if (!(sd <= sampson_thresh && den > kTiny)) continue;
        }
        if (v < run[i].best) {
          run[i].second = run[i].best;
          run[i].best = v;
          run[i].idx = col0 + c;
        } else {
          run[i].second = v;
        }
      }
    }
  }

  // merge the kTX threads (consecutive lanes) that share each row, then
  // the cluster's kSplit partials of each row through distributed shared
  // memory; CTA `split` writes the rows r with r % kSplit == split
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    TwoMin m = run[i];
#pragma unroll
    for (int off = kTX / 2; off > 0; off /= 2) {
      const TwoMin o{__shfl_xor_sync(0xffffffffu, m.best, off),
                     __shfl_xor_sync(0xffffffffu, m.second, off),
                     __shfl_xor_sync(0xffffffffu, m.idx, off)};
      m = merge(m, o);
    }
    if (tx == 0) part[kMR * ty + i] = m;
  }
  cluster.sync();  // every CTA's partials are written
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int q = row0 + r;
    if (r % kSplit != split || q >= N1) continue;
    TwoMin m = *cluster.map_shared_rank(&part[r], 0);
#pragma unroll
    for (int k = 1; k < kSplit; ++k)
      m = merge(m, *cluster.map_shared_rank(&part[r], k));
    const size_t o = static_cast<size_t>(p) * N1 + q;
    const bool none = m.best >= kBig;
    best_out[o] = none ? __int_as_float(0x7f800000) : m.best;
    second_out[o] = m.second >= kBig ? __int_as_float(0x7f800000) : m.second;
    idx_out[o] = none ? -1 : m.idx;
  }
  cluster.sync();  // no CTA exits while a peer still reads its partials
}

}  // namespace

// q_xy (B, N1, 2), q_valid (B, N1) bool, q_d (B, N1, D); t_* likewise with
// N2; F (B, 3, 3); use_epi (B,) bool; outputs best, second (B, N1) f32 and
// idx (B, N1) int32.  All contiguous on the device; descriptors 16-byte
// aligned, D a multiple of 4.  Launches a grid of clusters on `stream` and
// returns the cudaError_t of the launch (0 on success), a refused cluster
// or shared-memory size included; does not synchronise.
extern "C" int fused_gated_two_min_launch(
    const float* q_xy, const uint8_t* q_valid, const float* q_d,
    const float* t_xy, const uint8_t* t_valid, const float* t_d,
    const float* F, const uint8_t* use_epi, float* best, float* second,
    int* idx, int B, int N1, int N2, int D, float radius,
    float sampson_thresh, void* stream) {
  const int n_slices = (D + l1tile::kSlice - 1) / l1tile::kSlice;
  const int n_tiles = (N2 + kCols - 1) / kCols;
  const size_t smem =
      (static_cast<size_t>(n_slices) * kRows * l1tile::kChunks +
       kStages * kSliceF4) * sizeof(float4) +
      static_cast<size_t>((n_tiles + kSplit - 1) / kSplit) * kCols *
          sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gated_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here; clear it for later launches
    return static_cast<int>(err);
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = kSplit;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, (N1 + kRows - 1) / kRows, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_gated_kernel, q_xy, q_valid, q_d,
                           t_xy, t_valid, t_d, F, use_epi, best, second, idx,
                           N1, N2, D, radius, sampson_thresh);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}
