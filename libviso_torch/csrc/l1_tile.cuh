// The L1 tile engine shared by l1_distance.cu, fused_two_min.cu and
// fused_sweep.cu.
//
// A CTA computes sums sum_d |a[row, d] - b[col, d]| for a tile of rows and
// columns.  Descriptors reach shared memory in slices of 32 values by
// cp.async 16-byte copies (zero-filled past a matrix edge or past D), so
// the next slices load while the current one computes.  A staged slice
// keeps the global layout, one row of 8 chunks of 4 values, padded to a
// pitch of 9 chunks.
//
// Thread (ty, tx) keeps an MR x 8 register micro-tile: rows MR ty + i and
// columns tx + TX j (TX = TC / 8 threads along a row of the tile), each
// chunk read from shared memory as one float4.  A float4 of a feeds 8
// columns and one of b feeds MR rows, so one 16-byte load serves 4 MR to
// 32 accumulations, and every shared address is a per-slice base plus a
// constant.  Bank pattern of a quarter warp (8 lanes, one 16-byte phase):
// chunk c of row r sits in bank group (9 r + c) mod 8 = (r + c) mod 8.
// With TX >= 8 the lanes share ty, so their a loads are one broadcast, and
// their b loads read 8 consecutive columns, 8 distinct groups.  With
// TX = 4 a phase holds two ty, whose rows differ by MR >= 4: distinct too.
//
// Integer-valued descriptors give integer sums below 2^24, exact in float32
// in any order, so the sums equal a plain PyTorch version's bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace l1tile {

constexpr int kSlice = 32;             // descriptor values per staged slice
constexpr int kChunks = kSlice / 4;    // 16-byte chunks per row and slice
constexpr int kPitch = kChunks + 1;    // float4 per staged row

// 16-byte asynchronous copy global -> shared; zero-fills when !in (then
// no byte of src is read).
__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of rows [row0, row0 + ROWS) x values [d0, d0 + 32) of a
// (rows, D) matrix into the staged slice dst (ROWS * PITCH float4): thread
// t copies chunk t % 8 of rows t / 8, t / 8 + THREADS / 8, ...  Rows past
// `rows` and values past D are zero, which adds |0 - 0| = 0.  D is a
// multiple of 4, so a chunk never straddles a row end.
template <int ROWS, int THREADS, int PITCH = kPitch>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, int D, int row0, int d0,
                                      float4* dst) {
  static_assert(THREADS % kChunks == 0 && ROWS % (THREADS / kChunks) == 0,
                "a slice must split evenly over the threads");
  constexpr int kStep = THREADS / kChunks;   // rows per pass
  const int c = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const bool c_in = d0 + 4 * c < D;
  const float* p = src + static_cast<size_t>(row0 + r0) * D + d0 + 4 * c;
#pragma unroll
  for (int r = 0; r < ROWS; r += kStep) {
    const bool in = c_in && row0 + r0 + r < rows;
    cp_async16(dst + (r0 + r) * PITCH + c, in ? p : src, in);
    p += static_cast<size_t>(kStep) * D;
  }
}

// stage() for rows gathered through an index: staged row r is row
// row_of[r] of src (row_of in shared memory; a negative entry stages a
// zero row).  The copies are those of stage(), 16 bytes a thread.
template <int ROWS, int THREADS, int PITCH = kPitch>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src,
                                           const int* row_of, int D, int d0,
                                           float4* dst) {
  static_assert(THREADS % kChunks == 0 && ROWS % (THREADS / kChunks) == 0,
                "a slice must split evenly over the threads");
  constexpr int kStep = THREADS / kChunks;   // rows per pass
  const int c = threadIdx.x % kChunks;
  const int r0 = threadIdx.x / kChunks;
  const bool c_in = d0 + 4 * c < D;
#pragma unroll
  for (int r = 0; r < ROWS; r += kStep) {
    const int row = row_of[r0 + r];
    const bool in = c_in && row >= 0;
    cp_async16(dst + (r0 + r) * PITCH + c,
               in ? src + static_cast<size_t>(row) * D + d0 + 4 * c : src,
               in);
  }
}

// The micro-tile's column j (< 8) within a tile of TC columns.
template <int TC>
__device__ __forceinline__ int micro_col(int tx, int j) {
  return tx + (TC / 8) * j;
}

// acc[i][j] += sum over one staged slice of |a[MR ty + i] - b[col j]|, the
// values in ascending order.  as and bs are staged slices (a rows of the
// CTA at pitch APITCH, b columns of the tile).  With TX >= 8 the a loads
// are broadcasts, free of bank conflicts at any pitch: the unpadded
// APITCH = kChunks saves shared memory.
template <int MR, int TC, int APITCH = kPitch>
__device__ __forceinline__ void accumulate(const float4* __restrict__ as,
                                           const float4* __restrict__ bs,
                                           int ty, int tx,
                                           float acc[MR][8]) {
  as += MR * ty * APITCH;
  bs += tx * kPitch;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 bv[8];    // the chunk of the 8 columns, then one row at a time
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = bs[(TC / 8) * j * kPitch + c];
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      const float4 a = as[i * APITCH + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float s = acc[i][j];
        s += fabsf(a.x - bv[j].x);
        s += fabsf(a.y - bv[j].y);
        s += fabsf(a.z - bv[j].z);
        s += fabsf(a.w - bv[j].w);
        acc[i][j] = s;
      }
    }
  }
}

}  // namespace l1tile
