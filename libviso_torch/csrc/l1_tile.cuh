// The register-tiled L1 sum shared by l1_distance.cu and fused_two_min.cu.
//
// A block of TY x TX threads computes one (4 TY) x (4 TX) tile of
// sum_d |a[row, d] - b[col, d]|: slices of 32 descriptor values of both
// sides are staged in shared memory, transposed, and thread (ty, tx) keeps
// the 4 x 4 sums of rows ty + TY i and columns tx + TX j in registers, so
// each value read from shared memory feeds 4 accumulations.  Every sum runs
// over d in ascending order.  Rows past the edge of a matrix, and a D tail
// shorter than a slice, load as zero (|0 - 0| adds nothing).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace l1tile {

constexpr int kSlice = 32;  // descriptor values staged per step

// Copy rows [row0, row0 + ROWS) x values [d0, d0 + 32) of a (rows, D)
// matrix into dst[value][row], zero outside the matrix.  D is a multiple of
// 4, so a float4 never straddles a row end; the pitch ROWS + 1 keeps the
// transposed stores free of bank conflicts.
template <int ROWS, int THREADS>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      int rows, int D, int row0, int d0,
                                      float (*dst)[ROWS + 1]) {
  for (int k = threadIdx.x; k < ROWS * kSlice / 4; k += THREADS) {
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

// acc[i][j] += sum_d |a[row0 + ty + TY i, d] - b[col0 + tx + TX j, d]| for
// thread (ty, tx) = (threadIdx.x / TX, threadIdx.x % TX).  a is (N1, D),
// b is (N2, D).  Every thread of the block must call it (it synchronises);
// the shared buffers are free again when it returns.
template <int TY, int TX>
__device__ __forceinline__ void accumulate(
    const float* __restrict__ a, int N1, const float* __restrict__ b, int N2,
    int D, int row0, int col0, float (*as)[4 * TY + 1],
    float (*bs)[4 * TX + 1], float acc[4][4]) {
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  for (int d0 = 0; d0 < D; d0 += kSlice) {
    stage<4 * TY, TY * TX>(a, N1, D, row0, d0, as);
    stage<4 * TX, TY * TX>(b, N2, D, col0, d0, bs);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kSlice; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[d][ty + TY * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[d][tx + TX * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += fabsf(av[i] - bv[j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace l1tile
