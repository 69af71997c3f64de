// Fused gated matcher on x-sorted slots, for Hopper (sm_90a): for each
// query row, the gated (best, second, argmin) of the L1 descriptor distance
// over the target tiles that can hold a candidate, with no (N1, N2) array
// stored.
//
// Replaces libviso_tpu/ops/pallas_fused_match.py::fused_sweep_two_min
// (_make_sweep_kernel).  It takes a leading problem axis of B problems,
// each with its own fundamental matrix F and Sampson switch use_epi, so a
// frame's 3 match problems, or a serving timestep's 3 S, are one launch.
// The gate and the result are those of fused_two_min.cu (same expressions,
// rounded alike; a tie goes to the lowest column; a row with no candidate
// gives (inf, inf, -1)).
//
// Before a tile, a block tests the L1 gap between its query box and the
// tile's target box (both [x_min, x_max, y_min, y_max] of their valid
// slots, computed by the wrapper; empty is [inf, -inf, inf, -inf]) and
// skips the tile when the gap is >= radius.  Rounded subtraction is
// monotone, so a skipped tile holds no pair that the gate admits: the skip
// is exact.  At KITTI shapes it skips about 82 % of the (block, tile)
// pairs, so what bounds it is the L1 work of the live tiles.
//
// Design: a block owns 32 query rows of one problem and loops over the
// target slots in tiles of 64.  Each tile's L1 sums come from slices of 32
// descriptor values of both sides, staged transposed in shared memory;
// each of the 128 threads keeps 4 x 4 sums, gates its 16 pairs and folds
// its 4 columns into a running (best, second, idx) per row in ascending
// column order.  At the end the 16 threads of a row merge by warp shuffles,
// ordering candidates by (value, column).  This is the first port's
// design, kept as it was when the gated kernel was redesigned.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "two_min.cuh"

namespace {

constexpr int kSlice = 32;               // descriptor values per slice
constexpr int kTY = 8;                   // thread rows
constexpr int kTX = 16;                  // thread columns (one half warp)
constexpr int kThreads = kTY * kTX;
constexpr int kRows = 4 * kTY;           // query rows per block
constexpr int kCols = 4 * kTX;           // target slots per tile
using two_min::kBig;
using two_min::kTiny;
using two_min::merge;
using two_min::TwoMin;

// Copy rows [row0, row0 + ROWS) x values [d0, d0 + 32) of a (rows, D)
// matrix into dst[value][row], zero outside the matrix.  The pitch
// ROWS + 1 keeps the transposed stores free of bank conflicts.
template <int ROWS>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, int D, int row0, int d0,
                                      float (*dst)[ROWS + 1]) {
  for (int k = threadIdx.x; k < ROWS * kSlice / 4; k += kThreads) {
    const int r = k / (kSlice / 4);
    const int c = (k % (kSlice / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows && d0 + c < D) {
      v = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D + d0 + c);
    }
    dst[c + 0][r] = v.x;
    dst[c + 1][r] = v.y;
    dst[c + 2][r] = v.z;
    dst[c + 3][r] = v.w;
  }
}

// acc[i][j] += sum_d |a[row0 + ty + kTY i, d] - b[col0 + tx + kTX j, d]|,
// over d in ascending order.  Every thread must call it (it synchronises).
__device__ __forceinline__ void accumulate(
    const float* __restrict__ a, int N1, const float* __restrict__ b, int N2,
    int D, int row0, int col0, float (*as)[kRows + 1],
    float (*bs)[kCols + 1], float acc[4][4]) {
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  for (int d0 = 0; d0 < D; d0 += kSlice) {
    stage<kRows>(a, N1, D, row0, d0, as);
    stage<kCols>(b, N2, D, col0, d0, bs);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kSlice; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[d][ty + kTY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[d][tx + kTX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(av[i] - bv[j]);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fused_sweep_kernel(const float* __restrict__ q_xy,
                   const uint8_t* __restrict__ q_valid,
                   const float* __restrict__ q_d,
                   const float* __restrict__ t_xy,
                   const uint8_t* __restrict__ t_valid,
                   const float* __restrict__ t_d,
                   const float* __restrict__ F,
                   const uint8_t* __restrict__ use_epi,
                   const float* __restrict__ qbox,
                   const float* __restrict__ tbox,
                   float* __restrict__ best_out,
                   float* __restrict__ second_out,
                   int* __restrict__ idx_out, int N1, int N2, int D,
                   float radius, float sampson_thresh) {
  __shared__ float as[kSlice][kRows + 1];
  __shared__ float bs[kSlice][kCols + 1];
  __shared__ float txs[kCols], tys[kCols], b1sq[kCols], b2sq[kCols];
  __shared__ bool tvs[kCols];

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int n_tiles = (N2 + kCols - 1) / kCols;
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
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;

  // the thread's rows: position, validity and the row halves of Sampson
  // (F x1 at q: a1, a2, a3; a1 a1 + a2 a2)
  float qx[4], qy[4], a1[4], a2[4], a3[4], aa[4];
  bool qv[4];
  TwoMin run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + kTY * i;
    qv[i] = r < N1 && q_valid[r];
    qx[i] = r < N1 ? q_xy[2 * r] : 0.f;
    qy[i] = r < N1 ? q_xy[2 * r + 1] : 0.f;
    a1[i] = __fadd_rn(__fadd_rn(__fmul_rn(f[0], qx[i]),
                                __fmul_rn(f[1], qy[i])), f[2]);
    a2[i] = __fadd_rn(__fadd_rn(__fmul_rn(f[3], qx[i]),
                                __fmul_rn(f[4], qy[i])), f[5]);
    a3[i] = __fadd_rn(__fadd_rn(__fmul_rn(f[6], qx[i]),
                                __fmul_rn(f[7], qy[i])), f[8]);
    aa[i] = __fadd_rn(__fmul_rn(a1[i], a1[i]), __fmul_rn(a2[i], a2[i]));
    run[i] = TwoMin{kBig, kBig, -1};
  }

  float qb[4];  // the block's box
  const int n_qblocks = gridDim.x;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    qb[k] = qbox[(static_cast<size_t>(p) * 4 + k) * n_qblocks + blockIdx.x];

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int col0 = tile * kCols;
    const float* tb = tbox + static_cast<size_t>(p) * 4 * n_tiles + tile;
    const float dx = fmaxf(tb[0] - qb[1], qb[0] - tb[n_tiles]);
    const float dy = fmaxf(tb[2 * n_tiles] - qb[3], qb[2] - tb[3 * n_tiles]);
    // block-uniform: every thread skips, or none does
    if (!(fmaxf(dx, 0.f) + fmaxf(dy, 0.f) < radius)) continue;
    // the tile's columns: position, validity and the column halves of
    // Sampson (F' x2 at t: b1, b2, squared)
    for (int c = threadIdx.x; c < kCols; c += kThreads) {
      const int j = col0 + c;
      const float x = j < N2 ? t_xy[2 * j] : 0.f;
      const float y = j < N2 ? t_xy[2 * j + 1] : 0.f;
      const float b1 = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x),
                                           __fmul_rn(f[3], y)), f[6]);
      const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(f[1], x),
                                           __fmul_rn(f[4], y)), f[7]);
      txs[c] = x;
      tys[c] = y;
      tvs[c] = j < N2 && t_valid[j];
      b1sq[c] = __fmul_rn(b1, b1);
      b2sq[c] = __fmul_rn(b2, b2);
    }
    // (accumulate synchronises before the column data is read)
    float acc[4][4] = {};
    accumulate(q_d, N1, t_d, N2, D, row0, col0, as, bs, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + kTX * j;
      const float cx = txs[c], cy = tys[c];
      const bool cv = tvs[c];
      const float bb1 = b1sq[c], bb2 = b2sq[c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pos = __fadd_rn(fabsf(__fsub_rn(qx[i], cx)),
                                    fabsf(__fsub_rn(qy[i], cy)));
        bool ok = pos < radius && qv[i] && cv;
        if (epi) {
          const float t = __fadd_rn(__fadd_rn(__fmul_rn(cx, a1[i]),
                                              __fmul_rn(cy, a2[i])), a3[i]);
          const float num = __fmul_rn(t, t);
          const float den = __fadd_rn(__fadd_rn(aa[i], bb1), bb2);
          const float s = __fdiv_rn(num, fmaxf(den, kTiny));
          ok = ok && s <= sampson_thresh && den > kTiny;
        }
        const float v = ok ? acc[i][j] : kBig;
        if (v < run[i].best) {
          run[i].second = run[i].best;
          run[i].best = v;
          run[i].idx = col0 + c;
        } else if (v < run[i].second) {
          run[i].second = v;
        }
      }
    }
    __syncthreads();  // the next tile overwrites the column data
  }

  // merge the 16 threads (one half warp) that share each row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    TwoMin m = run[i];
#pragma unroll
    for (int off = kTX / 2; off > 0; off /= 2) {
      const TwoMin o{__shfl_xor_sync(0xffffffffu, m.best, off),
                     __shfl_xor_sync(0xffffffffu, m.second, off),
                     __shfl_xor_sync(0xffffffffu, m.idx, off)};
      m = merge(m, o);
    }
    const int r = row0 + ty + kTY * i;
    if (tx == 0 && r < N1) {
      const size_t o = static_cast<size_t>(p) * N1 + r;
      const bool none = m.best >= kBig;
      best_out[o] = none ? __int_as_float(0x7f800000) : m.best;
      second_out[o] = m.second >= kBig ? __int_as_float(0x7f800000)
                                       : m.second;
      idx_out[o] = none ? -1 : m.idx;
    }
  }
}

}  // namespace

// The block shape the wrapper builds its boxes for: query rows per block
// and target slots per tile.
extern "C" void fused_sweep_tiling(int* rows, int* cols) {
  *rows = kRows;
  *cols = kCols;
}

// q_xy (B, N1, 2), q_valid (B, N1) bool, q_d (B, N1, D); t_* likewise with
// N2, both sides sorted by x; F (B, 3, 3); use_epi (B,) bool; qbox
// (B, 4, ceil(N1 / rows)) and tbox (B, 4, ceil(N2 / cols)): rows [x_min,
// x_max, y_min, y_max] of the valid slots of each query block and target
// tile; outputs best, second (B, N1) f32 and idx (B, N1) int32.  All
// contiguous on the device; descriptors 16-byte aligned, D a multiple of 4.
// Launches on `stream` and returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int fused_sweep_two_min_launch(
    const float* q_xy, const uint8_t* q_valid, const float* q_d,
    const float* t_xy, const uint8_t* t_valid, const float* t_d,
    const float* F, const uint8_t* use_epi, const float* qbox,
    const float* tbox, float* best, float* second, int* idx, int B, int N1,
    int N2, int D, float radius, float sampson_thresh, void* stream) {
  const dim3 grid((N1 + kRows - 1) / kRows, B);
  fused_sweep_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi, qbox, tbox, best,
      second, idx, N1, N2, D, radius, sampson_thresh);
  return static_cast<int>(cudaGetLastError());
}
