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
//
// Above kMaxSlots slots a side the order takes three launches instead of
// one.  sweep_chunk_sort_kernel sorts each chunk of kMaxSlots slots in one
// CTA, as above, into a global buffer; sweep_merge_rank_kernel places each
// key at its index in its own chunk plus its rank in every other chunk (a
// binary search each), which is the merge of all chunks, and writes the
// permutation; sweep_box_kernel reduces the boxes through it, a thread a
// box.  The keys are the same 64-bit integers, so the order is the same.

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

// The (key, slot) integer of a slot: the order of its key above the slot
// index.
__device__ __forceinline__ unsigned long long slot_key(float x, bool ok,
                                                       float invalid_key,
                                                       int i) {
  return (static_cast<unsigned long long>(key_order(ok ? x : invalid_key))
          << 32) | static_cast<unsigned>(i);
}

// Sorts the first n of the P keys in a (P a power of two, the keys from n
// on above them all) with b as the second buffer, when sort is set;
// returns the buffer that holds the result, after a CTA barrier.  Only the
// n keys move: the padding sorts above them, in place in both buffers.
// Lane l of warp g holds keys 32 g + l, 32 g + l + kThreads, ..., so while
// merged runs stay within 32 keys a level reads and writes its own warp's
// keys only, and a warp barrier is enough.
__device__ unsigned long long* merge_sort(unsigned long long* a,
                                          unsigned long long* b, int n,
                                          int P, int sort) {
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
  return a;
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
      k = slot_key(v.x, ok, invalid_key, i);
      pos[i] = ok ? v : make_float2(nan, nan);
    }
    a[i] = k;
    b[i] = k;
  }
  __syncthreads();

  a = merge_sort(a, b, n, P, sort);
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

// The sides of problem blockIdx.z in the multi-CTA path: side
// blockIdx.y (1 = targets), its n slots, xy, validity, permutation and
// keys (a stride of `stride` keys a side).
struct Side {
  int n;
  float invalid_key;
  const float* xy;
  const uint8_t* valid;
  int* perm;
  unsigned long long* keys;
};

__device__ __forceinline__ Side side_of(const float* q_xy,
                                        const uint8_t* q_valid,
                                        const float* t_xy,
                                        const uint8_t* t_valid, int* qperm,
                                        int* tperm, unsigned long long* keys,
                                        int N1, int N2, int stride) {
  const bool targets = blockIdx.y == 1;
  const int p = blockIdx.z;
  Side s;
  s.n = targets ? N2 : N1;
  s.invalid_key = targets ? -1e6f : 1e6f;
  s.xy = (targets ? t_xy : q_xy) + static_cast<size_t>(p) * s.n * 2;
  s.valid = (targets ? t_valid : q_valid) + static_cast<size_t>(p) * s.n;
  int* perm = targets ? tperm : qperm;
  s.perm = perm ? perm + static_cast<size_t>(p) * s.n : nullptr;
  s.keys = keys ? keys + (static_cast<size_t>(p) * 2 + blockIdx.y) * stride
                : nullptr;
  return s;
}

// Chunk blockIdx.x of kMaxSlots slots, sorted (when sort is set) into
// keys[chunk start ...]; 2 kMaxSlots keys of dynamic shared memory.
__global__ void __launch_bounds__(kThreads)
sweep_chunk_sort_kernel(const float* __restrict__ q_xy,
                        const uint8_t* __restrict__ q_valid,
                        const float* __restrict__ t_xy,
                        const uint8_t* __restrict__ t_valid,
                        unsigned long long* __restrict__ keys, int N1,
                        int N2, int stride, int sort) {
  extern __shared__ unsigned long long buf[];
  const Side side = side_of(q_xy, q_valid, t_xy, t_valid, nullptr, nullptr,
                            keys, N1, N2, stride);
  const int start = blockIdx.x * kMaxSlots;
  if (start >= side.n) return;
  const int n = min(kMaxSlots, side.n - start);
  int P = 1;
  while (P < n) P *= 2;
  unsigned long long* a = buf;
  unsigned long long* b = buf + kMaxSlots;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    unsigned long long k = (0xffffffffull << 32) | static_cast<unsigned>(i);
    if (i < n) {
      const int slot = start + i;
      k = slot_key(side.xy[2 * slot], side.valid[slot] != 0,
                   side.invalid_key, slot);
    }
    a[i] = k;
    b[i] = k;
  }
  __syncthreads();
  a = merge_sort(a, b, n, P, sort);
  for (int i = threadIdx.x; i < n; i += kThreads) side.keys[start + i] = a[i];
}

// Each key's place in the merge of all sorted chunks: its index in its
// chunk plus, for every other chunk, the count of its keys below it (no
// two keys are equal); writes the slot at that place of the permutation.
// Unsorted (sort 0), each slot stays in its place.
__global__ void sweep_merge_rank_kernel(const float* __restrict__ q_xy,
                                        const uint8_t* __restrict__ q_valid,
                                        const float* __restrict__ t_xy,
                                        const uint8_t* __restrict__ t_valid,
                                        int* __restrict__ qperm,
                                        int* __restrict__ tperm,
                                        const unsigned long long* keys,
                                        int N1, int N2, int stride,
                                        int sort) {
  const Side side = side_of(q_xy, q_valid, t_xy, t_valid, qperm, tperm,
                            const_cast<unsigned long long*>(keys), N1, N2,
                            stride);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= side.n) return;
  const unsigned long long k = side.keys[i];
  const int own = i / kMaxSlots;
  int place = i;
  if (sort) {
    place = i - own * kMaxSlots;
    const int chunks = (side.n + kMaxSlots - 1) / kMaxSlots;
    for (int c = 0; c < chunks; ++c) {
      if (c == own) continue;
      const unsigned long long* run = side.keys + c * kMaxSlots;
      int lo = 0, hi = min(kMaxSlots, side.n - c * kMaxSlots);
      while (lo < hi) {  // the first key of the run not below k
        const int mid = (lo + hi) / 2;
        if (run[mid] < k) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      place += lo;
    }
  }
  side.perm[place] = static_cast<int>(k & 0xffffffffu);
}

// Box blockIdx.x * blockDim.x + threadIdx.x of each side: [x_min, x_max,
// y_min, y_max] of the valid slots of its run of sorted slots, NaN
// coordinates left out, [inf, -inf, inf, -inf] for a run without one.
__global__ void sweep_box_kernel(const float* __restrict__ q_xy,
                                 const uint8_t* __restrict__ q_valid,
                                 const float* __restrict__ t_xy,
                                 const uint8_t* __restrict__ t_valid,
                                 int* qperm, int* tperm,
                                 float* __restrict__ qbox,
                                 float* __restrict__ tbox, int N1, int N2,
                                 int rows, int cols) {
  const Side side = side_of(q_xy, q_valid, t_xy, t_valid, qperm, tperm,
                            nullptr, N1, N2, 0);
  const int block = blockIdx.y == 1 ? cols : rows;
  const int n_blocks = (side.n + block - 1) / block;
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= n_blocks) return;
  float* box = (blockIdx.y == 1 ? tbox : qbox) +
               static_cast<size_t>(blockIdx.z) * 4 * n_blocks;
  const float inf = __int_as_float(0x7f800000);
  float x0 = inf, x1 = -inf, y0 = inf, y1 = -inf;
  const int end = min(side.n, (blk + 1) * block);
  for (int j = blk * block; j < end; ++j) {
    const int slot = side.perm[j];
    if (!side.valid[slot]) continue;
    const float x = side.xy[2 * slot], y = side.xy[2 * slot + 1];
    x0 = fminf(x0, x);
    x1 = fmaxf(x1, x);
    y0 = fminf(y0, y);
    y1 = fmaxf(y1, y);
  }
  box[blk] = x0;
  box[n_blocks + blk] = x1;
  box[2 * n_blocks + blk] = y0;
  box[3 * n_blocks + blk] = y1;
}

}  // namespace

// The most slots a side that one CTA sorts.
extern "C" int sweep_order_max_slots() { return kMaxSlots; }

// q_xy (B, N1, 2), q_valid (B, N1) bool; t_* likewise with N2; outputs
// qperm (B, N1) and tperm (B, N2) int32 (sorted position -> slot; the
// identity when sort is 0), qbox (B, 4, ceil(N1 / rows)) and tbox
// (B, 4, ceil(N2 / cols)) float32.  All contiguous on the device.  Up to
// kMaxSlots slots a side one launch does it; above that `scratch` holds
// B * 2 * max(N1, N2) 64-bit keys and three launches do it.  Launches on
// `stream` and returns the cudaError_t of the launch (0 on success); does
// not synchronise.
extern "C" int sweep_order_launch(const float* q_xy, const uint8_t* q_valid,
                                  const float* t_xy, const uint8_t* t_valid,
                                  int* qperm, int* tperm, float* qbox,
                                  float* tbox, void* scratch, int B, int N1,
                                  int N2, int rows, int cols, int sort,
                                  void* stream) {
  // a block of at most 32 slots is reduced within a warp: a power of two
  const auto bad = [](int block) {
    return block < 1 || (block < 32 && (block & (block - 1)) != 0);
  };
  const int n_max = N1 > N2 ? N1 : N2;
  if (bad(rows) || bad(cols) || B > 65535 ||
      (n_max > kMaxSlots && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_max > kMaxSlots) {
    auto* keys = static_cast<unsigned long long*>(scratch);
    const int chunks = (n_max + kMaxSlots - 1) / kMaxSlots;
    const int smem = 2 * kMaxSlots * sizeof(unsigned long long);
    cudaError_t err = cudaFuncSetAttribute(
        sweep_chunk_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    sweep_chunk_sort_kernel<<<dim3(chunks, 2, B), kThreads, smem, s>>>(
        q_xy, q_valid, t_xy, t_valid, keys, N1, N2, n_max, sort);
    sweep_merge_rank_kernel<<<dim3((n_max + 255) / 256, 2, B), 256, 0, s>>>(
        q_xy, q_valid, t_xy, t_valid, qperm, tperm, keys, N1, N2, n_max,
        sort);
    const int most = (n_max + (rows < cols ? rows : cols) - 1) /
                     (rows < cols ? rows : cols);
    sweep_box_kernel<<<dim3((most + 127) / 128, 2, B), 128, 0, s>>>(
        q_xy, q_valid, t_xy, t_valid, qperm, tperm, qbox, tbox, N1, N2, rows,
        cols);
    return static_cast<int>(cudaGetLastError());
  }
  int P = 1;
  while (P < N1 || P < N2) P *= 2;
  const size_t smem = static_cast<size_t>(P) * 2 * sizeof(unsigned long long) +
                      static_cast<size_t>(n_max) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here; clear it for later launches
    return static_cast<int>(err);
  }
  sweep_order_kernel<<<dim3(2, B), kThreads, smem, s>>>(
      q_xy, q_valid, t_xy, t_valid, qperm, tperm, qbox, tbox, N1, N2, rows,
      cols, sort, P);
  return static_cast<int>(cudaGetLastError());
}
