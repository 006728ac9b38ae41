// Shared wedge probe for the support (K1) and peel (K2) kernels.
//
// Replaces the jnp search that both Pallas kernels of the JAX package call,
// src/repro/kernels/wedge_common.py: ranged_searchsorted and probe.  One
// table row asks whether w = N[cand] lies in the sorted adjacency range
// N[lo:hi).  The search runs at most `iters` halvings, the same bound the
// JAX package passes, and stops early once the range is empty: the reference
// masks the remaining steps, so the index it returns is the same.
//
// On the card the probe is a chain of dependent 4-byte gathers into N.  At
// the main path's size (Graph500 scale 17) N and Eid are 15 MB each and sit
// in the 50 MB L2 together, so the chain is bound by L2 latency, not by
// device-memory bandwidth; the kernels keep many rows in flight per SM to
// hide it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wedge {

// Lower bound of w in N[lo:hi): the first index whose value is >= w, or hi.
__device__ __forceinline__ int ranged_lower_bound(const int* __restrict__ N,
                                                  int w, int lo, int hi,
                                                  int iters) {
  for (int t = 0; t < iters && lo < hi; ++t) {
    // (lo + hi) >> 1 as the reference computes it, without int overflow
    const int mid = static_cast<int>(
        (static_cast<unsigned>(lo) + static_cast<unsigned>(hi)) >> 1);
    if (__ldg(N + mid) < w) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The fused membership test.  Returns true on a hit and sets *safe to the
// matching slot (the reference's clamped index; only read on a hit).
// Rows with an empty range (padding: lo == hi == 0) never hit and read
// nothing.
__device__ __forceinline__ bool probe(const int* __restrict__ N, int two_m,
                                      int cand, int lo, int hi, int iters,
                                      int* safe) {
  if (lo >= hi) return false;
  const int w = __ldg(N + cand);
  const int idx = ranged_lower_bound(N, w, lo, hi, iters);
  const int s = idx < two_m - 1 ? idx : two_m - 1;
  *safe = s;
  return idx < hi && __ldg(N + s) == w;
}

}  // namespace wedge
