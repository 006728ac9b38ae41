// Shared wedge intersection for the support (K1) and peel (K2) kernels.
//
// Replaces the jnp search that both Pallas kernels of the JAX package call,
// src/repro/kernels/wedge_common.py: ranged_searchsorted and probe.  A wedge
// asks whether a candidate id w lies in a sorted adjacency list.  The JAX
// package runs an `iters`-bounded lower-bound search of w in N[lo:hi); its
// bound is at least log2 of the longest list, so the index it returns is the
// exact lower bound.  Here the search runs to the end, over a list in shared
// memory (K1 stages it) or in device memory (K2, and K1's long lists).  CSR
// adjacency lists are sorted, so the slot found and the hit are the
// reference's.
//
// Both kernels read their wedges from the CSR (no wedge table): an edge's
// candidates are consecutive slots of one adjacency list, so the lanes of a
// warp read them coalesced, and the list they probe is the same for every
// candidate of the edge.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wedge {

constexpr unsigned kFullMask = 0xffffffffu;

// Exact lower bounds of two ids wa, wb in the sorted list p[0:n): for each
// the first index whose value is >= w, or n.  p is a shared- or
// device-memory address.  The search is branch-free and takes the same
// ceil(log2(n)) halvings for any value, so the lanes of a warp stay in step,
// and the two searches are interleaved: two independent loads in flight per
// halving.  (The probe in csrc/intersect.cu is an all-pairs compare.)
__device__ __forceinline__ void lower_bound2(const int* p, int n, int wa,
                                             int wb, int* ia, int* ib) {
  if (n <= 0) {
    *ia = 0;
    *ib = 0;
    return;
  }
  int a = 0;
  int b = 0;
  while (n > 1) {
    const int half = n >> 1;
    const int va = p[a + half];
    const int vb = p[b + half];
    a = va < wa ? a + half : a;
    b = vb < wb ? b + half : b;
    n -= half;
  }
  *ia = a + (p[a] < wa ? 1 : 0);
  *ib = b + (p[b] < wb ? 1 : 0);
}

// The membership test of two candidates: the slot of each in p[0:n), or -1
// on a miss.
__device__ __forceinline__ void find2(const int* p, int n, int wa, int wb,
                                      int* sa, int* sb) {
  int ia = 0;
  int ib = 0;
  lower_bound2(p, n, wa, wb, &ia, &ib);
  *sa = (ia < n && p[ia] == wa) ? ia : -1;
  *sb = (ib < n && p[ib] == wb) ? ib : -1;
}

// The fixed grid of the persistent kernels: the number of SMs of the
// current device times the blocks of `kernel` each can hold at `threads`
// threads and `smem` bytes of dynamic shared memory.  The answer is kept in
// `cache` (one per launch site), so a launch pays the driver queries once.
struct GridCache {
  int device = -1;
  size_t smem = 0;
  int blocks = 0;
};

template <typename Kernel>
inline int resident_grid(GridCache& cache, Kernel kernel, int threads,
                         size_t smem) {
  int device = 0;
  cudaGetDevice(&device);
  if (cache.blocks > 0 && cache.device == device && cache.smem == smem) {
    return cache.blocks;
  }
  int sms = 0;
  int per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  cache.device = device;
  cache.smem = smem;
  cache.blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return cache.blocks;
}

}  // namespace wedge
