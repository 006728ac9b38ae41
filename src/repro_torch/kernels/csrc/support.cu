// K1: the AM4 support phase over the oriented wedge table, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/support.py: support_accumulate (body
// _support_chunk_kernel).  For each table row: w = N[cand], a ranged
// lower-bound search of w in N[lo:hi); on a hit (one triangle, found once
// under the orientation) +1 to the support of the anchor edge e1, of
// Eid[cand] and of Eid[safe].  Also one triangle count per table chunk.
//
// Design, against what the TPU kernel assumed:
//  * The TPU grid is sequential and carries one (m+1,) accumulator in VMEM
//    from step to step.  Hopper's blocks run in no order, so the wrapper
//    zeroes S in device memory and every hit folds in with an integer
//    atomicAdd, which is exact in any order.  One thread per row, in a
//    grid-stride loop.
//  * On the TPU misses and padding rows scatter to the sentinel slot m.
//    Most rows of a real table miss; on the GPU they would all hit one
//    address and serialise the card.  A miss here writes nothing, so slot m
//    of S stays 0 and lies outside the contract: callers read S[:m].
//  * The per-chunk triangle count is reduced in the warp first: lanes whose
//    rows share a chunk are found with __match_any_sync and their hits
//    counted with one ballot, and one lane per (warp, chunk) adds the
//    count to tri[chunk].  This works for any chunk size, pow2 or not.
//
// What bounds it: streaming the table once.  At Graph500 scale 17 the table
// has 380,487,108 real rows of 16 bytes, 6.1 GB, about 1.8 ms at the H100's
// 3.35 TB/s; N and Eid (15 MB each) stay in L2, where the probe's dependent
// gathers wait on L2 latency.  Making that the limit (TMA-fed row tiles, or
// building rows in the kernel from the CSR so the table never exists) is
// later work.
#include "wedge_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
support_kernel(const int* __restrict__ e1, const int* __restrict__ cand,
               const int* __restrict__ lo, const int* __restrict__ hi,
               const int* __restrict__ N, const int* __restrict__ Eid,
               int* __restrict__ S, int* __restrict__ tri, long long rows,
               int chunk, int iters, int two_m) {
  const unsigned lane = threadIdx.x & 31u;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop test is on the warp's first row, so all 32 lanes run the same
  // number of iterations and the warp-wide intrinsics below see every lane
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r - lane < rows; r += stride) {
    bool hit = false;
    if (r < rows) {
      int safe = 0;
      const int c = __ldg(cand + r);
      hit = wedge::probe(N, two_m, c, __ldg(lo + r), __ldg(hi + r), iters,
                         &safe);
      if (hit) {
        atomicAdd(S + __ldg(e1 + r), 1);
        atomicAdd(S + __ldg(Eid + c), 1);
        atomicAdd(S + __ldg(Eid + safe), 1);
      }
    }
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (hits == 0u) continue;
    // rows past the end get the chunk id -1 and never join a real chunk
    const long long my_chunk = r < rows ? r / chunk : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, my_chunk);
    if (my_chunk >= 0 && lane == static_cast<unsigned>(__ffs(peers) - 1)) {
      const int count = __popc(hits & peers);
      if (count > 0) atomicAdd(tri + my_chunk, count);
    }
  }
}

}  // namespace

extern "C" int support_accumulate_launch(
    const int* e1, const int* cand, const int* lo, const int* hi,
    const int* N, const int* Eid, int* S, int* tri, long long rows, int chunk,
    int iters, int two_m, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  int sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long need = (rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) * 32;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  support_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e1, cand, lo, hi, N, Eid, S, tri, rows, chunk, iters, two_m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* support_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
