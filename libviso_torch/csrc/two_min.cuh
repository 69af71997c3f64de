// The row reduction shared by fused_two_min.cu and fused_sweep.cu: a
// running (best, second, idx) and its merge in (value, column) order.

#pragma once

#include <cuda_runtime.h>

namespace two_min {

constexpr float kBig = 3.0e38f;          // "no candidate", as in Pallas
constexpr float kTiny = 1e-30f;          // Sampson denominator floor

struct TwoMin {
  float best, second;
  int idx;
};

// (value, column) order: a tie goes to the lower column.  Exact, and the
// same in any order of merges.
__device__ __forceinline__ TwoMin merge(TwoMin a, TwoMin b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.idx < b.idx);
  const TwoMin& w = a_wins ? a : b;
  const TwoMin& l = a_wins ? b : a;
  return TwoMin{w.best, fminf(l.best, fminf(a.second, b.second)), w.idx};
}

}  // namespace two_min
