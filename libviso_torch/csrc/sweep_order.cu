// The sweep matcher's order, for Hopper (sm_90a): both sides of each match
// problem sorted stably by x, and the boxes of runs of sorted slots that
// the sweep kernel tests.
//
// Replaces the XLA part of libviso_tpu/ops/pallas_fused_match.py::
// sorted_fused_two_min (the argsorts of its keys) and of fused_sweep_two_min
// (the per-block boxes), which the first port ran as some 30 small PyTorch
// launches around the sweep kernel: this kernel and fused_sweep.cu make the
// route two launches.
//
// One CTA per (problem, side).  The key of slot i is its x when valid, else
// +1e6 for a query and -1e6 for a target.  Slots are ordered by (key, i):
// that is torch.argsort(stable=True) and jnp.argsort for every key, since
// -0.0 is keyed as 0.0 and every NaN after +inf.  Each (key, i) pair is one
// 64-bit integer, the key's bits mapped to an unsigned order above the
// slot index, so no two are equal; padding to a power of two P appends
// integers above them all, which stay in place.  A merge sort by rank
// sorts the n keys in shared memory: at width w each finds its place in
// the merged run of 2w as its index in its own run plus the count of
// smaller keys in the other run (a binary search), one barrier a level,
// log2 P levels (a warp barrier while the runs fit in a warp's keys).
//
// Then the warps reduce the boxes [x_min, x_max, y_min, y_max] of the
// valid slots of each run of `block` sorted slots (32 queries, 16 targets
// for the sweep kernel).  Invalid slots and NaN coordinates are left out
// (fminf / fmaxf skip the NaN they are staged as); a run without a valid
// slot gets [inf, -inf, inf, -inf].
//
// What bounds it: latency.  At (12, 1280) it is 24 CTAs on 24 SMs, each
// through 11 levels of one or two dependent binary searches a thread and a
// barrier; the bytes (about 0.3 MB) take 0.1 us.  The sort is about 60 %
// of its time on the card, the rest launch, key staging and boxes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSlots = 8192;  // slots a side one CTA sorts
// where the sweep kernel, launched after this one as a programmatic
// dependent, may start its launch (it waits for this grid's end to read
// its results): 0 at the start, 1 after the sort, 2 at the end (measured
// fastest: launched earlier, its CTAs wait on the SMs the order's occupy)
constexpr int kLaunchDependents = 2;

// The order of float keys as unsigned integers: -0.0 as 0.0, NaN above
// +inf.
__device__ __forceinline__ unsigned key_order(float x) {
  if (x != x) return 0xfffffffeu;
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
sweep_order_kernel(const float* __restrict__ q_xy,
                   const uint8_t* __restrict__ q_valid,
                   const float* __restrict__ t_xy,
                   const uint8_t* __restrict__ t_valid,
                   int* __restrict__ qperm, int* __restrict__ tperm,
                   float* __restrict__ qbox, float* __restrict__ tbox,
                   int N1, int N2, int rows, int cols, int sort, int P) {
  // dynamic: two buffers of P keys, then the n staged positions
  extern __shared__ unsigned long long keys[];
  const bool targets = blockIdx.x == 1;
  const int p = blockIdx.y;
  const int n = targets ? N2 : N1;
  const int block = targets ? cols : rows;
  const int n_blocks = (n + block - 1) / block;
  const float invalid_key = targets ? -1e6f : 1e6f;
  const float* xy = (targets ? t_xy : q_xy) + static_cast<size_t>(p) * n * 2;
  const uint8_t* valid = (targets ? t_valid : q_valid) +
                         static_cast<size_t>(p) * n;
  int* perm = (targets ? tperm : qperm) + static_cast<size_t>(p) * n;
  float* box = (targets ? tbox : qbox) + static_cast<size_t>(p) * 4 * n_blocks;
  unsigned long long* a = keys;
  unsigned long long* b = keys + P;
  float2* pos = reinterpret_cast<float2*>(keys + 2 * P);
  const float nan = __int_as_float(0x7fc00000);
  if (kLaunchDependents == 0)
    asm volatile("griddepcontrol.launch_dependents;\n" ::);

  for (int i = threadIdx.x; i < P; i += kThreads) {
    unsigned long long k = (0xffffffffull << 32) | static_cast<unsigned>(i);
    if (i < n) {
      const float2 v = make_float2(xy[2 * i], xy[2 * i + 1]);
      const bool ok = valid[i] != 0;
      k = (static_cast<unsigned long long>(key_order(ok ? v.x : invalid_key))
           << 32) | static_cast<unsigned>(i);
      pos[i] = ok ? v : make_float2(nan, nan);
    }
    a[i] = k;
    b[i] = k;
  }
  __syncthreads();

  // Only the n keys move: the padding sorts above them, in place in both
  // buffers.  Lane l of warp g holds keys 32 g + l, 32 g + l + kThreads,
  // ..., so while merged runs stay within 32 keys a level reads and
  // writes its own warp's keys only, and a warp barrier is enough.
  for (int w = 1; sort && w < P; w *= 2) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const unsigned long long k = a[i];
      const int run = i & ~(w - 1);
      const unsigned long long* other = a + (run ^ w);
      int below = 0;  // elements of the other run smaller than k
      for (int s = w >> 1; s > 0; s >>= 1)
        if (other[below + s - 1] < k) below += s;
      if (other[below] < k) ++below;
      b[(run & ~(2 * w - 1)) + (i - run) + below] = k;
    }
    if (4 * w <= 32) {
      __syncwarp();
    } else {
      __syncthreads();
    }
    unsigned long long* t = a;
    a = b;
    b = t;
  }
  __syncthreads();
  if (kLaunchDependents == 1)
    asm volatile("griddepcontrol.launch_dependents;\n" ::);

  for (int i = threadIdx.x; i < n; i += kThreads)
    perm[i] = static_cast<int>(a[i] & 0xffffffffu);

  // the boxes: a warp reduces 32 / block of them at a time (block <= 32,
  // a power of two), `width` lanes each, or one of a larger block
  const int width = min(block, 32);
  const int lane = threadIdx.x % 32;
  const int per_pass = 32 / width * (kThreads / 32);
  for (int blk = threadIdx.x / width; blk - lane / width < n_blocks;
       blk += per_pass) {
    const float inf = __int_as_float(0x7f800000);
    float x0 = inf, x1 = -inf, y0 = inf, y1 = -inf;
    const int end = min(n, (blk + 1) * block);
    for (int i = blk * block + lane % width; i < end; i += width) {
      const float2 v = pos[a[i] & 0xffffffffu];
      x0 = fminf(x0, v.x);
      x1 = fmaxf(x1, v.x);
      y0 = fminf(y0, v.y);
      y1 = fmaxf(y1, v.y);
    }
    for (int off = width / 2; off > 0; off /= 2) {
      x0 = fminf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
      y0 = fminf(y0, __shfl_xor_sync(0xffffffffu, y0, off));
      y1 = fmaxf(y1, __shfl_xor_sync(0xffffffffu, y1, off));
    }
    if (lane % width == 0 && blk < n_blocks) {
      box[blk] = x0;
      box[n_blocks + blk] = x1;
      box[2 * n_blocks + blk] = y0;
      box[3 * n_blocks + blk] = y1;
    }
  }
}

}  // namespace

// The most slots a side that one CTA sorts.
extern "C" int sweep_order_max_slots() { return kMaxSlots; }

// q_xy (B, N1, 2), q_valid (B, N1) bool; t_* likewise with N2; outputs
// qperm (B, N1) and tperm (B, N2) int32 (sorted position -> slot; the
// identity when sort is 0), qbox (B, 4, ceil(N1 / rows)) and tbox
// (B, 4, ceil(N2 / cols)) float32.  All contiguous on the device, N1 and
// N2 at most kMaxSlots.  Launches on `stream` and returns the cudaError_t
// of the launch (0 on success); does not synchronise.
extern "C" int sweep_order_launch(const float* q_xy, const uint8_t* q_valid,
                                  const float* t_xy, const uint8_t* t_valid,
                                  int* qperm, int* tperm, float* qbox,
                                  float* tbox, int B, int N1, int N2,
                                  int rows, int cols, int sort,
                                  void* stream) {
  // a block of at most 32 slots is reduced within a warp: a power of two
  const auto bad = [](int block) {
    return block < 1 || (block < 32 && (block & (block - 1)) != 0);
  };
  if (bad(rows) || bad(cols) || N1 > kMaxSlots || N2 > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  int P = 1;
  while (P < N1 || P < N2) P *= 2;
  const size_t smem = static_cast<size_t>(P) * 2 * sizeof(unsigned long long) +
                      static_cast<size_t>(N1 > N2 ? N1 : N2) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here; clear it for later launches
    return static_cast<int>(err);
  }
  sweep_order_kernel<<<dim3(2, B), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      q_xy, q_valid, t_xy, t_valid, qperm, tperm, qbox, tbox, N1, N2, rows,
      cols, sort, P);
  return static_cast<int>(cudaGetLastError());
}
