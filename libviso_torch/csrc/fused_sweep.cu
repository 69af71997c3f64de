// Fused gated matcher on x-sorted slots, for Hopper (sm_90a): for each
// query row, the gated (best, second, argmin) of the L1 descriptor distance
// over the target columns that can hold a candidate, with no (N1, N2)
// array stored.
//
// Replaces libviso_tpu/ops/pallas_fused_match.py::fused_sweep_two_min
// (_make_sweep_kernel) and, with sweep_order.cu, the gathers and the
// unsort of its wrapper sorted_fused_two_min.  It takes a leading problem
// axis of B problems, each with its own fundamental matrix F and Sampson
// switch use_epi, so a frame's 3 match problems, or a serving timestep's
// 3 S, are one launch.  The gate, its rounding and the result are those of
// fused_two_min.cu; a row with no candidate gives (inf, inf, -1).
//
// The slots stay where they are: the kernel reads them through the
// permutations of sweep_order.cu.  Sorted query row r is slot qperm[r],
// sorted target column c is slot tperm[c], and a descriptor row is still
// 512 contiguous bytes, so the copies stay 16 bytes a thread.  Every tie is
// broken by the sorted column c -- in each thread's fold, in the shuffle
// merge and in the merge across CTAs -- and c becomes tperm[c] only in the
// final store, at query slot qperm[r]: among equal distances the lowest
// x-sorted target wins, as in the Pallas wrapper.
//
// First a CTA tests the L1 gap between its query block's box and the box
// of each run of kBox sorted target slots (both [x_min, x_max, y_min,
// y_max] of their valid slots, from sweep_order.cu; empty is [inf, -inf,
// inf, -inf]).  Rounded subtraction is monotone, so a run whose gap is at
// least the radius holds no pair that the gate admits.  The block computes
// the sorted columns [c0, c1) from the first run whose gap is below the
// radius to the end of the last, in windows of kCols columns from c0 --
// not tiles aligned to multiples of kCols, which would add most of a tile
// at each end.  Any column outside is skipped exactly; a column inside
// that the box test alone would drop is computed and gated out.  On
// x-sorted slots [c0, c1) is a short run (about 2 windows a block at KITTI
// shapes), so what bounds the kernel is the L1 work of a few windows per
// query block, and its problem is filling the card with that little work.
//
// Design:
// - A cluster of `split` CTAs shares a block of ROWS query rows of one
//   problem and splits the block's windows in `split` contiguous parts;
//   the CTAs' partial (best, second, idx) meet in distributed shared
//   memory, merged in (value, sorted column) order, which is exact.  The
//   launcher picks ROWS and `split` from the grid (fused_sweep_plan):
//   blocks of 32 rows while they fit in kCTAsPerSM CTAs an SM, else of 64
//   (a window's target slices then serve twice the rows), and `split`, a
//   power of two up to kMaxSplit, as large as keeps the grid within that:
//   the 120 blocks of (3, 1280) take 240 CTAs of 4 warps, the 240 blocks
//   of 64 rows of (12, 1280) one CTA of 8 warps each.  The order kernel
//   boxes runs of 32 sorted queries; a 64-row block takes the union of two.
// - fused_two_min.cu's engine (l1_tile.cuh): the CTA's query descriptors
//   resident in shared memory, the windows' target rows streamed through
//   a ring of kStages slices of 32 values filled by cp.async (rows
//   gathered through the permutation), one barrier a slice, 4 x 8
//   micro-tiles read as float4.
// - The slots and gate data of a batch of kBatch windows are staged
//   while its first slices land (shared memory for a batch, not for every
//   window a block could have, keeps three CTAs of 32 rows an SM; F waits
//   in shared memory, not in registers), and the gates run
//   only for pairs whose sum is below the row's running second: then
//   position (an invalid slot has x = NaN, which fails it), and only then
//   Sampson.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "l1_tile.cuh"
#include "two_min.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMR = 4;                   // query rows per thread
constexpr int kQueryBox = 32;            // sorted query rows per box
constexpr int kCols = 128;               // target columns per window
constexpr int kBox = 16;                 // target slots per box
constexpr int kMaxSplit = 4;             // CTAs per cluster, along windows
constexpr int kCTAsPerSM = 2;            // the grid the split aims to fill
constexpr int kStages = 2;               // slices in flight
constexpr int kBatch = 4;                // windows staged at once
constexpr int kTX = kCols / 8;           // threads along a row
constexpr int kSliceF4 = kCols * l1tile::kPitch;
using two_min::kBig;
using two_min::kTiny;
using two_min::merge;
using two_min::TwoMin;

// Shared memory past the static arrays: the resident query slices, the
// ring, and per column of a batch of windows its gate data (float4) and
// slot (int).
size_t dynamic_smem(int rows, int D) {
  const int n_slices = (D + l1tile::kSlice - 1) / l1tile::kSlice;
  return (static_cast<size_t>(n_slices) * rows * l1tile::kChunks +
          kStages * kSliceF4) * sizeof(float4) +
         static_cast<size_t>(kBatch) * kCols * (sizeof(float4) + sizeof(int));
}

// ROWS query rows a block, (ROWS / kMR) x kTX threads; MIN_CTAS a SM.
template <int ROWS, int MIN_CTAS, int THREADS = ROWS / kMR * kTX>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
fused_sweep_kernel(const float* __restrict__ q_xy,
                   const uint8_t* __restrict__ q_valid,
                   const float* __restrict__ q_d,
                   const float* __restrict__ t_xy,
                   const uint8_t* __restrict__ t_valid,
                   const float* __restrict__ t_d,
                   const float* __restrict__ F,
                   const uint8_t* __restrict__ use_epi,
                   const int* __restrict__ qperm,
                   const int* __restrict__ tperm,
                   const float* __restrict__ qbox,
                   const float* __restrict__ tbox,
                   float* __restrict__ best_out,
                   float* __restrict__ second_out,
                   int* __restrict__ idx_out, int N1, int N2, int D,
                   float radius, float sampson_thresh) {
  extern __shared__ float4 smem[];
  static_assert(kTX >= 8, "unpadded query slices need broadcast loads");
  static_assert(ROWS % kQueryBox == 0, "a block is whole query boxes");
  __shared__ float4 qg[ROWS];    // qx (NaN: no candidate), qy, a1, a2
  __shared__ float2 qh[ROWS];    // a3, a1 a1 + a2 a2
  __shared__ TwoMin part[ROWS];
  __shared__ int qrow[ROWS];     // the block's query slots (-1 past N1)
  __shared__ int live_lo, live_hi;  // the first and last live box
  __shared__ float f[9];         // the problem's F

  // launched as a programmatic dependent of the order kernel: wait for it
  // to end (and its results to be visible) before reading them
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;     // the CTA's rank in its cluster
  const int n_split = gridDim.x;  // the cluster's size
  const int row0 = blockIdx.y * ROWS;
  const int p = blockIdx.z;
  q_xy += static_cast<size_t>(p) * N1 * 2;
  q_valid += static_cast<size_t>(p) * N1;
  q_d += static_cast<size_t>(p) * N1 * D;
  qperm += static_cast<size_t>(p) * N1;
  t_xy += static_cast<size_t>(p) * N2 * 2;
  t_valid += static_cast<size_t>(p) * N2;
  t_d += static_cast<size_t>(p) * N2 * D;
  tperm += static_cast<size_t>(p) * N2;
  const bool epi = use_epi[p] != 0;
  const float nan = __int_as_float(0x7fc00000);
  const int n_boxes = (N2 + kBox - 1) / kBox;

  for (int r = threadIdx.x; r < ROWS; r += THREADS)
    qrow[r] = row0 + r < N1 ? qperm[row0 + r] : -1;
  if (threadIdx.x < 9) f[threadIdx.x] = F[p * 9 + threadIdx.x];
  if (threadIdx.x == 0) {
    live_lo = n_boxes;
    live_hi = -1;
  }
  __syncthreads();

  // the live boxes: those that lie less than a radius (L1) from the query
  // block's box, the union of its query boxes
  const int n_qboxes = (N1 + kQueryBox - 1) / kQueryBox;
  const float* qb = qbox + static_cast<size_t>(p) * 4 * n_qboxes;
  const float inf = __int_as_float(0x7f800000);
  float qx0 = inf, qx1 = -inf, qy0 = inf, qy1 = -inf;
#pragma unroll
  for (int k = 0; k < ROWS / kQueryBox; ++k) {
    const int b = row0 / kQueryBox + k;
    if (b >= n_qboxes) break;
    qx0 = fminf(qx0, qb[b]);
    qx1 = fmaxf(qx1, qb[n_qboxes + b]);
    qy0 = fminf(qy0, qb[2 * n_qboxes + b]);
    qy1 = fmaxf(qy1, qb[3 * n_qboxes + b]);
  }
  const float* tb = tbox + static_cast<size_t>(p) * 4 * n_boxes;
  for (int t = threadIdx.x; t < n_boxes; t += THREADS) {
    const float dx = fmaxf(tb[t] - qx1, qx0 - tb[n_boxes + t]);
    const float dy = fmaxf(tb[2 * n_boxes + t] - qy1,
                           qy0 - tb[3 * n_boxes + t]);
    if (fmaxf(dx, 0.f) + fmaxf(dy, 0.f) < radius) {
      atomicMin(&live_lo, t);
      atomicMax(&live_hi, t);
    }
  }
  __syncthreads();

  // the block's columns [c0, c1) in windows of kCols; the CTA's share:
  // windows [first, first + n_mine)
  const int c0 = live_lo * kBox;
  const int c1 = live_hi < 0 ? c0 : min(N2, (live_hi + 1) * kBox);
  const int n_windows = (c1 - c0 + kCols - 1) / kCols;
  const int first = rank * n_windows / n_split;
  const int n_mine = (rank + 1) * n_windows / n_split - first;
  const int n_slices = (D + l1tile::kSlice - 1) / l1tile::kSlice;
  float4* qd = smem;   // unpadded: pitch kChunks
  float4* ring = qd + n_slices * ROWS * l1tile::kChunks;
  float4* cols = ring + kStages * kSliceF4;
  int* trow = reinterpret_cast<int*>(cols + kBatch * kCols);

  // the query rows, position (x NaN when invalid) and the row halves of
  // Sampson (F x1 at q: a1, a2, a3; a1 a1 + a2 a2)
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    const int q = qrow[r];
    const float x = q >= 0 ? q_xy[2 * q] : 0.f;
    const float y = q >= 0 ? q_xy[2 * q + 1] : 0.f;
    const float a1 = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x),
                                         __fmul_rn(f[1], y)), f[2]);
    const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(f[3], x),
                                         __fmul_rn(f[4], y)), f[5]);
    const float a3 = __fadd_rn(__fadd_rn(__fmul_rn(f[6], x),
                                         __fmul_rn(f[7], y)), f[8]);
    qg[r] = make_float4(q >= 0 && q_valid[q] ? x : nan, y, a1, a2);
    qh[r] = make_float2(a3, __fadd_rn(__fmul_rn(a1, a1), __fmul_rn(a2, a2)));
  }

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  float acc[kMR][8] = {};
  TwoMin run[kMR];
#pragma unroll
  for (int i = 0; i < kMR; ++i) run[i] = TwoMin{kBig, kBig, -1};

  // the CTA's windows, kBatch at a time: their columns' slots and gate
  // data staged, then their slices streamed
  for (int w0 = 0; w0 < n_mine; w0 += kBatch) {
    const int n_steps = min(kBatch, n_mine - w0) * n_slices;
    const int colb = c0 + (first + w0) * kCols;  // the batch's first column
    if (w0 > 0) __syncthreads();  // the last batch's columns are folded
    // the slot of each column (-1 from c1 on)
    for (int c = threadIdx.x; c < n_steps / n_slices * kCols; c += THREADS)
      trow[c] = colb + c < c1 ? tperm[colb + c] : -1;
    __syncthreads();

    // step k: slice k % n_slices of the batch's window k / n_slices
    auto issue = [&](int k) {
      l1tile::stage_rows<kCols, THREADS>(
          t_d, trow + (k / n_slices) * kCols, D,
          (k % n_slices) * l1tile::kSlice, ring + (k % kStages) * kSliceF4);
    };

    // the query descriptors (with the first batch's first copy group) and
    // the first stages
    if (w0 == 0) {
      for (int s = 0; s < n_slices; ++s)
        l1tile::stage_rows<ROWS, THREADS, l1tile::kChunks>(
            q_d, qrow, D, s * l1tile::kSlice,
            qd + s * ROWS * l1tile::kChunks);
    }
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_steps) issue(k);
      l1tile::cp_async_commit();
    }
    // while they land: the columns' position (x NaN when invalid) and the
    // column halves of Sampson (F' x2 at t: b1, b2, squared)
    for (int c = threadIdx.x; c < n_steps / n_slices * kCols;
         c += THREADS) {
      const int j = trow[c];
      const float x = j >= 0 ? t_xy[2 * j] : 0.f;
      const float y = j >= 0 ? t_xy[2 * j + 1] : 0.f;
      const float b1 = __fadd_rn(__fadd_rn(__fmul_rn(f[0], x),
                                           __fmul_rn(f[3], y)), f[6]);
      const float b2 = __fadd_rn(__fadd_rn(__fmul_rn(f[1], x),
                                           __fmul_rn(f[4], y)), f[7]);
      cols[c] = make_float4(j >= 0 && t_valid[j] ? x : nan, y,
                            __fmul_rn(b1, b1), __fmul_rn(b2, b2));
    }

    for (int k = 0; k < n_steps; ++k) {
      l1tile::cp_async_wait<kStages - 2>();  // step k has landed ...
      __syncthreads();  // ... for every thread, and step k - 1 is consumed
      if (k + kStages - 1 < n_steps) issue(k + kStages - 1);
      l1tile::cp_async_commit();
      const int s = k % n_slices;
      l1tile::accumulate<kMR, kCols, l1tile::kChunks>(
          qd + s * ROWS * l1tile::kChunks, ring + (k % kStages) * kSliceF4,
          ty, tx, acc);
      if (s != n_slices - 1) continue;
      // the window is summed: fold its columns, in ascending sorted order,
      // into the running two smallest of each row
      const int m = k / n_slices;
      const int col0 = colb + m * kCols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = l1tile::micro_col<kCols>(tx, j);
        const float4 t = cols[m * kCols + c];
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
    l1tile::cp_async_wait<0>();
  }

  // merge the kTX threads (consecutive lanes) that share each row, then
  // the cluster's n_split partials of each row through distributed shared
  // memory; CTA `rank` writes the rows r with r % n_split == rank
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
  for (int r = threadIdx.x; r < ROWS; r += THREADS) {
    if (r % n_split != rank || row0 + r >= N1) continue;
    TwoMin m = *cluster.map_shared_rank(&part[r], 0);
    for (int k = 1; k < n_split; ++k)
      m = merge(m, *cluster.map_shared_rank(&part[r], k));
    const size_t o = static_cast<size_t>(p) * N1 + qrow[r];
    const bool none = m.best >= kBig;
    best_out[o] = none ? __int_as_float(0x7f800000) : m.best;
    second_out[o] = m.second >= kBig ? __int_as_float(0x7f800000) : m.second;
    idx_out[o] = none ? -1 : tperm[m.idx];
  }
  cluster.sync();  // no CTA exits while a peer still reads its partials
}

// The plan of a launch on B problems of N1 queries: query rows per block
// and CTAs per cluster (see Design).
void plan(int B, int N1, int sms, int* rows, int* split) {
  *rows = (N1 + kQueryBox - 1) / kQueryBox * B <= kCTAsPerSM * sms
              ? kQueryBox : 2 * kQueryBox;
  const int blocks = (N1 + *rows - 1) / *rows * B;
  *split = 1;
  while (*split < kMaxSplit && blocks * *split * 2 <= kCTAsPerSM * sms)
    *split *= 2;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return err;
}

template <int ROWS, int MIN_CTAS>
cudaError_t launch(int split, const float* q_xy, const uint8_t* q_valid,
                   const float* q_d, const float* t_xy,
                   const uint8_t* t_valid, const float* t_d, const float* F,
                   const uint8_t* use_epi, const int* qperm,
                   const int* tperm, const float* qbox, const float* tbox,
                   float* best, float* second, int* idx, int B, int N1,
                   int N2, int D, float radius, float sampson_thresh,
                   cudaStream_t stream) {
  const auto kernel = fused_sweep_kernel<ROWS, MIN_CTAS>;
  const size_t smem = dynamic_smem(ROWS, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // a cluster of `split` CTAs; a programmatic dependent launch, so the
  // grid's launch overlaps the end of the order kernel before it
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N1 + ROWS - 1) / ROWS, B);
  cfg.blockDim = dim3(ROWS / kMR * kTX);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, q_xy, q_valid, q_d, t_xy, t_valid,
                            t_d, F, use_epi, qperm, tperm, qbox, tbox, best,
                            second, idx, N1, N2, D, radius, sampson_thresh);
}

}  // namespace

// The runs the order kernel boxes (sorted query rows, target slots) and
// the target columns per window.
extern "C" void fused_sweep_tiling(int* rows, int* box, int* cols) {
  *rows = kQueryBox;
  *box = kBox;
  *cols = kCols;
}

// The query rows per block and CTAs per cluster of a launch on B problems
// of N1 queries on the current device; returns its cudaError_t.
extern "C" int fused_sweep_plan(int B, int N1, int* rows, int* split) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  plan(B, N1, sms, rows, split);
  return 0;
}

// q_xy (B, N1, 2), q_valid (B, N1) bool, q_d (B, N1, D); t_* likewise with
// N2, in slot order; F (B, 3, 3); use_epi (B,) bool; qperm (B, N1) and
// tperm (B, N2) int32, the x order of each side, with qbox
// (B, 4, ceil(N1 / 32)) and tbox (B, 4, ceil(N2 / box)) the boxes of the
// sorted runs (sweep_order.cu); outputs best, second (B, N1) f32 and idx
// (B, N1) int32 at the query slots, idx a target slot.  All contiguous on
// the device; descriptors 16-byte aligned, D a multiple of 4; N1 and N2
// any size (above sweep_order.cu's limit the order comes from another
// sort).  Launches a grid of clusters on `stream` and returns the
// cudaError_t of the launch (0 on success), a refused cluster or
// shared-memory size included; does not synchronise.
extern "C" int fused_sweep_two_min_launch(
    const float* q_xy, const uint8_t* q_valid, const float* q_d,
    const float* t_xy, const uint8_t* t_valid, const float* t_d,
    const float* F, const uint8_t* use_epi, const int* qperm,
    const int* tperm, const float* qbox, const float* tbox, float* best,
    float* second, int* idx, int B, int N1, int N2, int D, float radius,
    float sampson_thresh, void* stream) {
  int sms = 0, rows = 0, split = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    plan(B, N1, sms, &rows, &split);
    const auto run = rows == kQueryBox ? launch<kQueryBox, 3>
                                       : launch<2 * kQueryBox, 2>;
    err = run(split, q_xy, q_valid, q_d, t_xy, t_valid, t_d, F, use_epi,
              qperm, tperm, qbox, tbox, best, second, idx, B, N1, N2, D,
              radius, sampson_thresh, static_cast<cudaStream_t>(stream));
  }
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(err != cudaSuccess ? err : last);
}
