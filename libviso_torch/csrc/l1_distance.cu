// All-pairs L1 descriptor distance for Hopper (sm_90a).
//
// Replaces libviso_tpu/ops/pallas_matching.py::l1_distance_matrix (the
// Pallas kernel _l1_kernel): out[p, i, j] = sum_d |a[p, i, d] - b[p, j, d]|
// for a batch of P match problems in one launch, so a frame's three match
// problems (LR stereo, left temporal, right temporal) are one launch.
//
// What bounds it: at the main path's shape (P, N1, N2, D) =
// (3, 1280, 1280, 128) a frame needs 3 * 1280 * 1280 * 128 = 0.63 G
// |a - b| accumulations (a subtract, an absolute value and an add each) on
// the FP32 CUDA cores -- L1 has no bilinear form, so the tensor cores cannot
// take it -- against about 20 MB of output and 2 MB of input.  The kernel
// is compute-bound.
//
// What the tiling does about it (l1_tile.cuh, shared with the fused
// matcher): each block owns one 64x64 output tile of
// one problem and stages 64x32 slices of both descriptor tiles in shared
// memory, so each descriptor value read from device memory feeds 64
// accumulations.  Each of the 256 threads keeps a 4x4 register micro-tile,
// so each value read from shared memory feeds 4 accumulations and the inner
// loop is arithmetic, not memory traffic.  Every output sums d in ascending
// order.  Ragged N1/N2 edges are masked (rows past the edge load as zero and
// are never stored), and a D tail shorter than the 32-wide slice loads as
// zero, which adds |0 - 0| = 0 to every sum.

#include <cuda_runtime.h>

#include <cstddef>

#include "l1_tile.cuh"

namespace {

constexpr int kTile = 64;            // output tile edge (rows and columns)
constexpr int kThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
l1_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int N1, int N2, int D) {
  __shared__ float as[l1tile::kSlice][kTile + 1];
  __shared__ float bs[l1tile::kSlice][kTile + 1];

  const int p = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const float* ap = a + static_cast<size_t>(p) * N1 * D;
  const float* bp = b + static_cast<size_t>(p) * N2 * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of the tile
  float acc[4][4] = {};
  l1tile::accumulate<16, 16>(ap, N1, bp, N2, D, row0, col0, as, bs, acc);

  float* op = out + static_cast<size_t>(p) * N1 * N2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= N1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N2) op[static_cast<size_t>(r) * N2 + c] = acc[i][j];
    }
  }
}

}  // namespace

// a: (P, N1, D), b: (P, N2, D), out: (P, N1, N2), all contiguous f32 on the
// device, 16-byte aligned, D a multiple of 4.  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int l1_distance_launch(const float* a, const float* b, float* out,
                                  int P, int N1, int N2, int D,
                                  void* stream) {
  const dim3 grid((N2 + kTile - 1) / kTile, (N1 + kTile - 1) / kTile, P);
  l1_distance_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, out, N1,
                                                            N2, D);
  return static_cast<int>(cudaGetLastError());
}
