// All-pairs L1 descriptor distance for Hopper (sm_90a).
//
// Replaces libviso_tpu/ops/pallas_matching.py::l1_distance_matrix (the
// Pallas kernel _l1_kernel): out[p, i, j] = sum_d |a[p, i, d] - b[p, j, d]|
// for a batch of P match problems in one launch, so a frame's three match
// problems (LR stereo, left temporal, right temporal) are one launch.
//
// What bounds it: at the main path's shape (P, N1, N2, D) =
// (3, 1280, 1280, 128) a frame needs 0.63 G |a - b| accumulations, each two
// FP32 instructions (FADD r, a, -b; FADD acc, |r|, acc -- no FMA can merge
// them, and L1 has no bilinear form for the tensor cores), against 19.7 MB
// of output and 3.9 MB of input: issue-bound on the FP32 pipes.
//
// What the design does about it (l1_tile.cuh, shared with the fused
// matcher): a CTA of 128 threads owns a 64 x 64 output tile of one problem,
// and each thread a 4 x 8 register micro-tile read by float4 loads, so one
// shared-memory load feeds 16 to 32 accumulations (12 loads per 256
// FADDs).  The 32-value descriptor slices stream through a ring of kStages
// stages filled by cp.async, one barrier a slice, so the next slice loads
// while this one computes.  At 122 registers and 37 KB of shared memory
// four CTAs fit an SM, 16 warps; the grid is 1200 CTAs at (3, 1280, 128),
// 2.27 rounds of the 528 that run at once (8 x 8 micro-tiles in 128 x 128
// tiles measured slower: they need 170 or more registers, so fewer warps,
// and 300 CTAs leave a third of the last round's slots idle).  The output
// is stored from the registers: the 8 threads of a row write 32
// consecutive bytes per column step, whole sectors.  Ragged N1 / N2 edges
// and a D tail short of a slice load as zero and are never stored.

#include <cuda_runtime.h>

#include <cstddef>

#include "l1_tile.cuh"

namespace {

constexpr int kMR = 4;                      // rows per thread
constexpr int kTM = 64;                     // output tile rows
constexpr int kTN = 64;                     // output tile columns
constexpr int kTX = kTN / 8;                // threads along a row
constexpr int kThreads = (kTM / kMR) * kTX;
constexpr int kStages = 2;                  // slices in flight
constexpr int kMinCTAs = 4;                 // per SM: at most 128 registers
constexpr int kStageF4 = (kTM + kTN) * l1tile::kPitch;
constexpr int kSmemBytes = kStages * kStageF4 * sizeof(float4);

__global__ void __launch_bounds__(kThreads, kMinCTAs)
l1_distance_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out, int N1, int N2, int D) {
  extern __shared__ float4 smem[];
  const int p = blockIdx.z;
  const int row0 = blockIdx.y * kTM;
  const int col0 = blockIdx.x * kTN;
  const float* ap = a + static_cast<size_t>(p) * N1 * D;
  const float* bp = b + static_cast<size_t>(p) * N2 * D;
  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int n_slices = (D + l1tile::kSlice - 1) / l1tile::kSlice;

  auto issue = [&](int s) {
    float4* st = smem + (s % kStages) * kStageF4;
    l1tile::stage<kTM, kThreads>(ap, N1, D, row0, s * l1tile::kSlice, st);
    l1tile::stage<kTN, kThreads>(bp, N2, D, col0, s * l1tile::kSlice,
                                 st + kTM * l1tile::kPitch);
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_slices) issue(s);
    l1tile::cp_async_commit();
  }
  float acc[kMR][8] = {};
  for (int s = 0; s < n_slices; ++s) {
    l1tile::cp_async_wait<kStages - 2>();  // slice s has landed ...
    __syncthreads();  // ... for every thread, and slice s - 1 is consumed
    if (s + kStages - 1 < n_slices) issue(s + kStages - 1);
    l1tile::cp_async_commit();
    const float4* st = smem + (s % kStages) * kStageF4;
    l1tile::accumulate<kMR, kTN>(st, st + kTM * l1tile::kPitch, ty, tx,
                                 acc);
  }

  // the 8 threads of a row group write 8 consecutive floats per column
  // step: whole 32-byte sectors
  float* op = out + static_cast<size_t>(p) * N1 * N2;
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int r = row0 + kMR * ty + i;
    if (r >= N1) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + l1tile::micro_col<kTN>(tx, j);
      if (c < N2) op[static_cast<size_t>(r) * N2 + c] = acc[i][j];
    }
  }
}

}  // namespace

// a: (P, N1, D), b: (P, N2, D), out: (P, N1, N2), all contiguous f32 on the
// device, 16-byte aligned, D a multiple of 4.  Launches on `stream` and
// returns the cudaError_t of the launch (0 on success), including a refused
// shared-memory size; does not synchronise.
extern "C" int l1_distance_launch(const float* a, const float* b, float* out,
                                  int P, int N1, int N2, int D,
                                  void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      l1_distance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) {
    cudaGetLastError();  // reported here; clear it for later launches
    return static_cast<int>(attr);
  }
  const dim3 grid((N2 + kTN - 1) / kTN, (N1 + kTM - 1) / kTM, P);
  l1_distance_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(a, b, out, N1,
                                                            N2, D);
  return static_cast<int>(cudaGetLastError());
}
