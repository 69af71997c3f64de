// Fused gated matcher for Hopper (sm_90a): for each query row, the gated
// (best, second, argmin) of the L1 descriptor distance over all target
// slots, with no (N1, N2) array stored.
//
// Replaces two Pallas kernels of libviso_tpu/ops/pallas_fused_match.py:
//   fused_gated_two_min  (_make_kernel + _tile_pass)   -> kSweep = false
//   fused_sweep_two_min  (_make_sweep_kernel)          -> kSweep = true
// Both take a leading problem axis of B problems, each with its own
// fundamental matrix F and Sampson switch use_epi (radius and Sampson
// threshold are shared), so a frame's 3 match problems, or a serving
// timestep's 3 S, are one launch.
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
// 128) 0.63 G |a - b| accumulations on the FP32 pipes, with the gates about
// a tenth more.  Fused, no (B, N1, N2) distance array is written or read
// back (20 MB a frame on the dense route, 79 MB for a 4-stream serving
// step), and the row reduction happens in registers.
//
// What the design does about it: a block owns 32 query rows of one
// problem and loops over the target slots in tiles of 64 (the TPU's
// sequential grid axis becomes this loop).  Each tile's L1 sums come from
// the register-tiled l1tile::accumulate (128 threads, 4 x 4 sums each);
// each thread then gates its 16 pairs and folds its 4 columns into a
// running (best, second, idx) per row, in ascending column order.  At the
// end the 16 threads of a row merge by warp shuffles, ordering candidates
// by (value, column).  32-row blocks give 40 blocks a problem, 120 at
// B = 3, to spread over the 132 SMs.
// The sweep variant is meant for x-sorted slots: before a tile it tests the
// L1 gap between the block's query box and the tile's target box (both
// [x_min, x_max, y_min, y_max] of their valid slots, computed by the
// wrapper; empty is [inf, -inf, inf, -inf]) and skips the tile when the
// gap is >= radius.  Rounded subtraction is monotone, so a
// skipped tile holds no pair that the gate admits: the skip is exact.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "l1_tile.cuh"

namespace {

constexpr int kTY = 8;                   // thread rows
constexpr int kTX = 16;                  // thread columns (one half warp)
constexpr int kThreads = kTY * kTX;
constexpr int kRows = 4 * kTY;           // query rows per block
constexpr int kCols = 4 * kTX;           // target slots per tile
constexpr float kBig = 3.0e38f;          // "no candidate", as in Pallas
constexpr float kTiny = 1e-30f;          // Sampson denominator floor

struct TwoMin {
  float best, second;
  int idx;
};

// (value, column) order: a tie goes to the lower column.
__device__ __forceinline__ TwoMin merge(TwoMin a, TwoMin b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.idx < b.idx);
  const TwoMin& w = a_wins ? a : b;
  const TwoMin& l = a_wins ? b : a;
  return TwoMin{w.best, fminf(l.best, fminf(a.second, b.second)), w.idx};
}

template <bool kSweep>
__global__ void __launch_bounds__(kThreads)
fused_two_min_kernel(const float* __restrict__ q_xy,
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
  __shared__ float as[l1tile::kSlice][kRows + 1];
  __shared__ float bs[l1tile::kSlice][kCols + 1];
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

  float qb[4] = {0.f, 0.f, 0.f, 0.f};  // the block's box (sweep only)
  if (kSweep) {
    const int n_qblocks = gridDim.x;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      qb[k] = qbox[(static_cast<size_t>(p) * 4 + k) * n_qblocks + blockIdx.x];
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int col0 = tile * kCols;
    if (kSweep) {
      const float* tb = tbox + static_cast<size_t>(p) * 4 * n_tiles + tile;
      const float dx = fmaxf(tb[0] - qb[1], qb[0] - tb[n_tiles]);
      const float dy = fmaxf(tb[2 * n_tiles] - qb[3],
                             qb[2] - tb[3 * n_tiles]);
      // block-uniform: every thread skips, or none does
      if (!(fmaxf(dx, 0.f) + fmaxf(dy, 0.f) < radius)) continue;
    }
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
    l1tile::accumulate<kTY, kTX>(q_d, N1, t_d, N2, D, row0, col0, as, bs,
                                 acc);
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

template <bool kSweep>
int launch(const float* q_xy, const uint8_t* q_valid, const float* q_d,
           const float* t_xy, const uint8_t* t_valid, const float* t_d,
           const float* F, const uint8_t* use_epi, const float* qbox,
           const float* tbox, float* best, float* second, int* idx, int B, int N1, int N2, int D, float radius,
           float sampson_thresh, void* stream) {
  const dim3 grid((N1 + kRows - 1) / kRows, B);
  fused_two_min_kernel<kSweep><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi, qbox, tbox, best,
      second, idx, N1, N2, D, radius, sampson_thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block shape the wrapper builds its sweep boxes for: query rows per
// block and target slots per tile.
extern "C" void fused_two_min_tiling(int* rows, int* cols) {
  *rows = kRows;
  *cols = kCols;
}

// q_xy (B, N1, 2), q_valid (B, N1) bool, q_d (B, N1, D); t_* likewise with
// N2; F (B, 3, 3); use_epi (B,) bool; outputs best, second (B, N1) f32 and
// idx (B, N1) int32.  All contiguous on the device; descriptors 16-byte
// aligned, D a multiple of 4.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int fused_gated_two_min_launch(
    const float* q_xy, const uint8_t* q_valid, const float* q_d,
    const float* t_xy, const uint8_t* t_valid, const float* t_d,
    const float* F, const uint8_t* use_epi, float* best, float* second,
    int* idx, int B, int N1, int N2, int D, float radius,
    float sampson_thresh, void* stream) {
  return launch<false>(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                       nullptr, nullptr, best, second, idx, B, N1, N2, D,
                       radius, sampson_thresh, stream);
}

// As fused_gated_two_min_launch, on slots the caller sorted by x, with
// qbox (B, 4, ceil(N1 / rows)) and tbox (B, 4, ceil(N2 / cols)): rows
// [x_min, x_max, y_min, y_max] of the valid slots of each query block and
// target tile.
extern "C" int fused_sweep_two_min_launch(
    const float* q_xy, const uint8_t* q_valid, const float* q_d,
    const float* t_xy, const uint8_t* t_valid, const float* t_d,
    const float* F, const uint8_t* use_epi, const float* qbox,
    const float* tbox, float* best, float* second, int* idx, int B, int N1,
    int N2, int D, float radius, float sampson_thresh, void* stream) {
  return launch<true>(q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
                      qbox, tbox, best, second, idx, B, N1, N2, D, radius,
                      sampson_thresh, stream);
}
