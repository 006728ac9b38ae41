// K1: the AM4 support phase, fed by the CSR, for sm_90a.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/support.py: support_accumulate (body
// _support_chunk_kernel).  The JAX kernel streams an oriented wedge table,
// one row per (edge (u, v), candidate w in N+(v)), and searches each w in
// N+(u); every hit (a triangle, found once under the orientation) adds 1 to
// the support of the edge, of Eid[cand] and of Eid[slot of w in N+(u)], and
// one triangle to the count of the row's table chunk.
//
// Design, against what the TPU kernel assumed:
//  * No table.  The rows of edge e are the slots N+(v) = N[Eo[v]:Es[v+1]),
//    read straight from the CSR; row j of e is table row off[e] + j, where
//    off is the prefix of |N+(v)| that the table build computes.  The 16
//    bytes per row that the table held (6.1 GB at Graph500 scale 17, built
//    in 8 GiB before the scan) are never written or read.
//  * One warp takes a group of kGroup consecutive edges.  Edges are sorted
//    by u, so consecutive edges share N+(u): the warp copies it into its own
//    slice of shared memory once (up to kStage ids; longer lists are
//    searched in device memory) and searches it there for every candidate
//    of the group.  Lanes read consecutive candidates, so the N[cand] loads
//    are coalesced.  Small groups spread the edges of a high-degree u over
//    more warps; 4 edges a warp timed faster than 16 at scale 17.
//  * Hopper's blocks run in no order, so hits fold into S in device memory
//    with integer atomicAdd, exact in any order: the edge's own hits as one
//    add per warp step, the two other edges' one add per hit.  A miss writes
//    nothing, so slot m of S stays 0 (outside the contract).
//  * Each lane searches two candidates at a time with a branch-free search
//    that takes the same number of halvings for every value, so the warp
//    stays in step and two loads are in flight per halving.
//  * Per-chunk triangle counts are reduced in the warp first: a warp step's
//    32 rows span at most two chunks of the usual >= 32 rows, counted with
//    one ballot each (smaller chunks group the lanes with __match_any_sync);
//    one lane per (warp, chunk) adds the count.
//
//  * An edge range [e_begin, e_end) restricts the grid to those edges' rows
//    (the whole graph is [0, m)); distributed PKT gives each rank the range
//    whose rows are its share of the table.  Only the grid's start and end
//    move.
//
// What bounds it: it must read the adjacency lists the edges scan and probe
// (N, 4 bytes a slot), Eid of the hit slots, the CSR offsets and the edge
// endpoints, and write S and the triangle partials; chip_smoke.py counts
// those bytes and the compares of the searches from the run's own graph.
#include "wedge_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// consecutive edges per warp task: they share u, so one staging serves all
constexpr int kGroup = 4;
// ids of N+(u) one warp stages (4 KB; 32 KB a block, static shared memory)
constexpr int kStage = 1024;
// the id a lane past the end of the list searches for (never stored)
constexpr int kNoId = -1;

// Adds the warp's hits on the 32 consecutive table rows row0 + lane to the
// triangle counts of their chunks; returns the warp's hit count (the same in
// every lane).  Rows of one warp step span at most two chunks when
// chunk >= 32: one ballot per chunk then.  Smaller chunks group the lanes
// with __match_any_sync.
__device__ __forceinline__ int count_triangles(int* __restrict__ tri,
                                               bool hit, int row0, int lane,
                                               int chunk) {
  const unsigned hits = __ballot_sync(wedge::kFullMask, hit);
  if (hits == 0u) return 0;
  const int my_chunk = (row0 + lane) / chunk;
  if (chunk >= 32) {
    const int first = row0 / chunk;
    const unsigned in_first =
        __ballot_sync(wedge::kFullMask, my_chunk == first);
    if (lane == 0) {
      const int n0 = __popc(hits & in_first);
      const int n1 = __popc(hits & ~in_first);
      if (n0 > 0) atomicAdd(tri + first, n0);
      if (n1 > 0) atomicAdd(tri + first + 1, n1);
    }
  } else {
    const unsigned peers = __match_any_sync(wedge::kFullMask, my_chunk);
    const int count = __popc(hits & peers);
    if (lane == __ffs(peers) - 1 && count > 0) atomicAdd(tri + my_chunk, count);
  }
  return __popc(hits);
}

__global__ void __launch_bounds__(kThreads)
support_kernel(const int* __restrict__ u, const int* __restrict__ v,
               const int* __restrict__ Es, const int* __restrict__ Eo,
               const int* __restrict__ off, const int* __restrict__ N,
               const int* __restrict__ Eid, int* __restrict__ S,
               int* __restrict__ tri, int e_first, int e_last,
               int chunk) {
  __shared__ int staged[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* list = staged[warp];
  const long long groups =
      (static_cast<long long>(e_last - e_first) + kGroup - 1) / kGroup;
  const long long all_warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long grp = static_cast<long long>(blockIdx.x) * kWarps + warp;
       grp < groups; grp += all_warps) {
    int staged_u = -1;  // the vertex whose N+ sits in `list`
    const int e_begin = e_first + static_cast<int>(grp * kGroup);
    const int e_end = min(e_last, e_begin + kGroup);
    for (int e = e_begin; e < e_end; ++e) {
      const int a = __ldg(u + e);
      const int b = __ldg(v + e);
      const int c0 = __ldg(Eo + b);
      const int n_cand = __ldg(Es + b + 1) - c0;
      const int lo = __ldg(Eo + a);
      const int plen = __ldg(Es + a + 1) - lo;
      if (n_cand <= 0 || plen <= 0) continue;  // warp-uniform
      const bool stage = plen <= kStage;
      if (stage && staged_u != a) {
        __syncwarp();  // every lane is done searching the old list
        for (int i = lane; i < plen; i += 32) list[i] = __ldg(N + lo + i);
        __syncwarp();
        staged_u = a;
      }
      const int* plist = stage ? list : N + lo;
      const int row0 = __ldg(off + e);
      // each lane takes two candidates a step, j and j + 32
      for (int base = 0; base < n_cand; base += 64) {  // warp-uniform
        const int ja = base + lane;
        const int jb = ja + 32;
        const int wa = ja < n_cand ? __ldg(N + c0 + ja) : kNoId;
        const int wb = jb < n_cand ? __ldg(N + c0 + jb) : kNoId;
        int sa = -1;
        int sb = -1;
        wedge::find2(plist, plen, wa, wb, &sa, &sb);
        const bool hit_a = ja < n_cand && sa >= 0;
        const bool hit_b = jb < n_cand && sb >= 0;
        if (hit_a) {
          atomicAdd(S + __ldg(Eid + c0 + ja), 1);
          atomicAdd(S + __ldg(Eid + lo + sa), 1);
        }
        if (hit_b) {
          atomicAdd(S + __ldg(Eid + c0 + jb), 1);
          atomicAdd(S + __ldg(Eid + lo + sb), 1);
        }
        const int n_hits = count_triangles(tri, hit_a, row0 + base, lane,
                                           chunk) +
                           count_triangles(tri, hit_b, row0 + base + 32, lane,
                                           chunk);
        if (lane == 0 && n_hits > 0) atomicAdd(S + e, n_hits);
      }
    }
  }
}

}  // namespace

extern "C" int support_accumulate_launch(
    const int* u, const int* v, const int* Es, const int* Eo, const int* off,
    const int* N, const int* Eid, int* S, int* tri, int e_begin, int e_end,
    int chunk, void* stream) {
  if (e_end <= e_begin) return static_cast<int>(cudaSuccess);
  const long long groups =
      (static_cast<long long>(e_end - e_begin) + kGroup - 1) / kGroup;
  const long long need = (groups + kWarps - 1) / kWarps;
  static wedge::GridCache grid;
  const long long cap = wedge::resident_grid(grid, support_kernel, kThreads,
                                             0);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  support_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, Es, Eo, off, N, Eid, S, tri, e_begin, e_end, chunk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* support_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
