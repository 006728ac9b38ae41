// K2: one ProcessSubLevel decrement fold, frontier-driven and fed by the
// CSR, and the sub-level state updates that make its next frontier; sm_90a.
//
// peel_kernel replaces the Pallas kernel of the JAX package,
// src/repro/kernels/peel.py: peel_decrement_fold (body _peel_chunk_kernel).
// At level l a wedge of a frontier edge e1 = (a, b) is a candidate slot c of
// the smaller-degree endpoint's adjacency, probed in the other endpoint's
// adjacency (the degree rule of the peel-table build).  It counts if the
// probe hits and neither e2 = Eid[c] nor e3 = Eid[hit slot] is processed.
// Then dec[e2] += 1 if S[e2] > l, e2 is not pinned and (e3 is off the
// frontier or e1 < e3) — the paper's lowest-id tie-break — and the same for
// e3.
//
// Design, against what the TPU kernel assumed:
//  * No table and no chunk mask.  The JAX kernel streams a padded wedge table
//    (2^29 rows at Graph500 scale 17) over a static grid and skips the chunks
//    that no frontier edge touches.  Here the wedges follow from the CSR and
//    the kernel walks a list of work items built for the frontier alone.
//  * Work items split the heavy edges.  An item is (frontier edge, slice j):
//    the candidates [j*slice, (j+1)*slice) of its scan side.  The scan side
//    runs from 1 to thousands of ids (7,247 at scale 17), so one item per
//    edge would leave a hub's edges on a few SMs.  The items are made by a
//    per-sub-level prefix over the frontier's ceil(deg_scan / slice): the
//    update kernels below append each new frontier edge's items with one
//    64-bit atomic per warp that returns both the edge and the item offset,
//    so the list needs no separate scan pass and no host sync.
//  * A fixed grid (the blocks the SMs can hold at once) walks the items up
//    to the count it reads on the device.  The launch never changes shape,
//    so the sub-level loop (this launch and the update) can be captured in
//    a CUDA graph.
//  * One warp takes one item of at most 64 candidates (the slice the
//    wrapper passes): each lane searches two of them at once with the
//    branch-free search of wedge_common.cuh, the N[c] loads are coalesced,
//    and the anchor e1 is the item's, never read per row.  At the first
//    sub-level of scale 17 the frontier holds 172,131 edges of 12
//    candidates on average, so a block per item would leave most of its
//    threads idle behind the item's chain of dependent loads; small slices
//    spread the dense core's long scan sides over many warps.
//  * The probe list N[lo:hi) is searched where it lies, in device memory:
//    the L1 cache holds the hot top of a list that a warp's 64 searches
//    share.  Copying lists of up to 256 or 1,024 ids into shared memory per
//    warp first, or up to 16,384 ids per block in dynamic shared memory
//    above 48 KB, was no faster over a scale-17 decomposition.
//  * Integer atomicAdd folds replace the TPU's sequential accumulator, exact
//    in any order.  Misses write nothing, so dec[m] stays 0.
//  * The fold lists the edges it touches: an add that finds dec[e] == 0 is
//    e's first decrement of the sub-level (dec is all zero when the fold
//    starts), so it appends e to the touched list.  Each warp stages its
//    ids in shared memory and copies them out 129 to 256 at a time with
//    one counter add: a scale-17 decomposition touches tens of millions of
//    edges, and one add per group of appending lanes (a coalesced group)
//    serialized K2 on the single counter.  The list is not free: an add
//    that returns the old value waits for it, where an add whose value is
//    unused does not, so K2 takes about a quarter longer than without the
//    list (PERF.md).  Each lane issues its up to four adds of a step
//    together.
//
// The two update kernels replace the jnp body of one sub-level of the JAX
// package's peel loop (src/repro/core/pkt.py, `sublevel`): S <- max(S - dec,
// l) off the frontier, mark the frontier processed, form the next frontier
// S == l with its id list and work items, zero dec, count the processed
// slots.
//  * sparse_update_kernel runs after every fold.  Within a level only an
//    edge the fold decremented can join the next frontier: the level's
//    first frontier holds every live edge with S == l, and the clamp keeps
//    every other live edge at S > l.  So it visits the old frontier (marks
//    it processed) and the touched list (applies dec, forms the next
//    frontier), never the m + 1 slots.  The two lists are disjoint: the
//    fold decrements only unprocessed, unpinned edges with S > l, and a
//    frontier edge has S == l.  The processed count is the old count plus
//    the old frontier's size, read on the device.  When the touched list
//    holds more than m / kDenseShare edges the launch walks all slots
//    instead (the same result): random accesses to a sixth of the slots
//    cost more than one coalesced pass (16.2 against 13.3 us at a
//    scale-17 middle level).  The choice reads the count on the device, so
//    the launch keeps its shape.
//  * dense_update_kernel passes over all m + 1 slots.  It starts a level
//    (run with dec = 0 and an empty frontier it forms the level's first
//    frontier and counts the processed slots), and takes any state the
//    sparse one takes.  Its processed count is one add per block: one add
//    per warp (8,448 at scale 17) to one address serialized the launch.
//
// peel_loop_kernel runs a whole peel segment in one launch: what the host
// loop drives one launch at a time (kernels/peel.py: host_loop), separated
// by grid-wide barriers.  It replaces no TPU kernel: the JAX package runs
// the same loop as a lax.while_loop on the device.
//  * A level starts with l = min(live S), folded into a device word with one
//    atomicMin per block, and the processed count beside it; then the dense
//    walk forms the level's first frontier.  A sub-level is the fold, then
//    the sparse update.  The level ends when the new frontier is empty, and
//    the segment at a level boundary once (m + 1) - n_done <= stop_live.
//  * One launch, one host read per segment: the host launched three kernels
//    and read [#frontier, #processed] back once per sub-level, and the card
//    idled between them (PERF.md).
//  * The bodies are the standalone kernels' (__device__ functions shared
//    with them).  State that a later phase of the same launch rewrites is
//    read with plain loads, never through the read-only cache (__ldg or a
//    const __restrict__ kernel parameter), which is not kept coherent
//    within a launch; the barrier (cooperative_groups grid sync) orders the
//    phases.
//  * Every block reads the same counts after a barrier, so every block
//    takes the same branch.  A counter that a phase writes is reset before
//    the barrier that opens that phase, by a row that no block reads across
//    that barrier: the level words alternate by level, the count rows by
//    sub-level as the frontier lists do.
//  * The grid is the blocks the SMs hold at once (a cooperative launch
//    needs every block resident), at most one block per 256 slots: a small
//    union gets a few blocks and cheap barriers.
//  * Each sub-level retires at least one edge, so a segment has at most m
//    sub-levels; past that the kernel stops and reports it (status 1), and
//    the wrapper raises.
//  * No index here sums or doubles the peel table's rows, which no kernel
//    holds: the largest is a work item, under m + rows / slice + 1 (2.1e7
//    at Graph500 scale 18, whose rows reach 1.07e9), and
//    core/pkt.py: prepare_peel_csr refuses a work list past 2^31 - 1.
//    Adjacency slots stay under 2m; slot walks and the frontier rows'
//    offsets take 64 bits.
//
// What bounds them: per sub-level, the adjacency lists the frontier's edges
// scan and probe, Eid of the hit slots and the state of the touched edges
// (K2); the old frontier's and the touched edges' state, the touched list
// and the next frontier (sparse update); one pass over the (m + 1,) state
// (dense update, once per level; the fused loop's level start adds one
// more).  chip_smoke.py counts those bytes and the search compares from the
// run's own states.
#include <climits>

#include <cooperative_groups.h>

#include "wedge_common.cuh"


namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the id a lane past the end of the slice searches for (never stored)
constexpr int kNoId = -1;
// the support of a processed slot in the level minimum (core/pkt.py:
// _SENTINEL_S, kernels/peel.py: SENTINEL_S)
constexpr int kSentinelS = 1 << 30;

// One wedge hit of frontier edge e1: candidate slot c, probe slot p.  The
// edges it decrements come back in *d2 / *d3 (-1 when none); the caller
// issues the adds, so that a lane has all of its adds in flight at once.
// S, proc and curr are read with plain loads: the fused loop rewrites them
// between its folds.
__device__ __forceinline__ void fold_hit(
    int e1, int c, int p, int l, const int* __restrict__ Eid, const int* S,
    const uint8_t* proc, const uint8_t* curr,
    const uint8_t* __restrict__ pin, int* d2, int* d3) {
  const int e2 = __ldg(Eid + c);
  const int e3 = __ldg(Eid + p);
  if (proc[e2] || proc[e3]) return;
  const bool in2 = curr[e2] != 0;
  const bool in3 = curr[e3] != 0;
  const bool pin2 = pin != nullptr && __ldg(pin + e2) != 0;
  const bool pin3 = pin != nullptr && __ldg(pin + e3) != 0;
  if (S[e2] > l && (!in3 || e1 < e3) && !pin2) *d2 = e2;
  if (S[e3] > l && (!in2 || e1 < e2) && !pin3) *d3 = e3;
}

// A warp's staging area for the touched list in shared memory: a step
// stages at most 4 ids a lane, and the warp copies its stage out with one
// counter add once it holds more than kStage - 128 ids.
constexpr int kStage = 256;

// Copy the warp's n staged ids to the touched list; all 32 lanes call it.
__device__ __forceinline__ void flush_stage(const int* stage, int n,
                                            int* __restrict__ touched,
                                            int* __restrict__ n_touched) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(n_touched, n);
  base = __shfl_sync(wedge::kFullMask, base, 0);
  for (int j = lane; j < n; j += 32) touched[base + j] = stage[j];
  __syncwarp();
}

// The fold over n_items work items at level l (K2's body); adds its
// touched edges to *n_touched.  All threads of the grid call it.
__device__ __forceinline__ void fold(
    int n_items, const int* work_e, const int* work_j, int* n_touched, int l,
    const int* __restrict__ u, const int* __restrict__ v,
    const int* __restrict__ Es, const int* __restrict__ N,
    const int* __restrict__ Eid, const int* S, const uint8_t* proc,
    const uint8_t* curr, const uint8_t* __restrict__ pin, int* dec,
    int* touched, int slice) {
  __shared__ int stages[kWarps][kStage];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* stage = stages[warp];
  int staged = 0;
  const int all_warps = gridDim.x * kWarps;
  for (int t = blockIdx.x * kWarps + warp; t < n_items; t += all_warps) {
    const int e1 = work_e[t];
    const int j = work_j[t];
    const int a = __ldg(u + e1);
    const int b = __ldg(v + e1);
    const int a0 = __ldg(Es + a);
    const int a1 = __ldg(Es + a + 1);
    const int b0 = __ldg(Es + b);
    const int b1 = __ldg(Es + b + 1);
    // scan the smaller-degree side, probe the other (ties scan a)
    const bool swap = (a1 - a0) > (b1 - b0);
    const int c0 = (swap ? b0 : a0) + j * slice;
    const int c1 = min(c0 + slice, swap ? b1 : a1);
    const int lo = swap ? a0 : b0;
    const int plen = (swap ? a1 : b1) - lo;
    const int* plist = N + lo;
    // each lane takes two candidates a step, c and c + 32; the loop test
    // is on the warp's first candidate, so the lanes stage in step
    for (int c = c0 + lane; c - lane < c1; c += 64) {
      // the edges this step decrements; after the adds, only those it
      // decrements for the first time in the sub-level
      int first[4] = {-1, -1, -1, -1};
      if (c < c1) {
        const int cb = c + 32;
        const int wb = cb < c1 ? __ldg(N + cb) : kNoId;
        int sa = -1;
        int sb = -1;
        wedge::find2(plist, plen, __ldg(N + c), wb, &sa, &sb);
        if (sa >= 0) {
          fold_hit(e1, c, lo + sa, l, Eid, S, proc, curr, pin, &first[0],
                   &first[1]);
        }
        if (cb < c1 && sb >= 0) {
          fold_hit(e1, cb, lo + sb, l, Eid, S, proc, curr, pin, &first[2],
                   &first[3]);
        }
      }
      // the adds; one that finds dec == 0 is the edge's first decrement
      int old[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        old[k] = first[k] >= 0 ? atomicAdd(dec + first[k], 1) : 1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (old[k] != 0) first[k] = -1;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned ballot = __ballot_sync(wedge::kFullMask,
                                              first[k] >= 0);
        if (first[k] >= 0) {
          stage[staged + __popc(ballot & ((1u << lane) - 1u))] = first[k];
        }
        staged += __popc(ballot);
      }
      if (staged > kStage - 128) {
        flush_stage(stage, staged, touched, n_touched);
        staged = 0;
      }
    }
  }
  if (staged > 0) flush_stage(stage, staged, touched, n_touched);
}

// counts: int32 [n_items, n_front, n_done, n_touched]; the fold reads
// n_items and adds its touched edges to n_touched (0 at the launch).
__global__ void __launch_bounds__(kThreads)
peel_kernel(const int* __restrict__ work_e, const int* __restrict__ work_j,
            int* __restrict__ counts, const int* __restrict__ level,
            const int* __restrict__ u, const int* __restrict__ v,
            const int* __restrict__ Es, const int* __restrict__ N,
            const int* __restrict__ Eid, const int* __restrict__ S,
            const uint8_t* __restrict__ proc,
            const uint8_t* __restrict__ curr,
            const uint8_t* __restrict__ pin, int* __restrict__ dec,
            int* __restrict__ touched, int slice) {
  fold(counts[0], work_e, work_j, counts + 3, __ldg(level), u, v, Es, N, Eid,
       S, proc, curr, pin, dec, touched, slice);
}

// The next frontier's bookkeeping for one warp step: lanes with `next` set
// append edge e, its id to front and its `items` work items, with one
// 64-bit atomic on out[0:2] (n_front high, n_items low) for the warp.  All
// 32 lanes must call it.
__device__ __forceinline__ void append_next(bool next, int e, int items,
                                            int* __restrict__ front,
                                            int* __restrict__ work_e,
                                            int* __restrict__ work_j,
                                            int* __restrict__ out) {
  const unsigned ballot = __ballot_sync(wedge::kFullMask, next);
  if (ballot == 0u) return;
  const int lane = threadIdx.x & 31;
  // inclusive prefix of the lanes' item counts
  int incl = items;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(wedge::kFullMask, incl, o);
    if (lane >= o) incl += t;
  }
  const int total = __shfl_sync(wedge::kFullMask, incl, 31);
  unsigned long long base = 0;
  if (lane == 0) {
    const unsigned long long add =
        (static_cast<unsigned long long>(__popc(ballot)) << 32) |
        static_cast<unsigned>(total);
    base = atomicAdd(reinterpret_cast<unsigned long long*>(out), add);
  }
  base = __shfl_sync(wedge::kFullMask, base, 0);
  if (next) {
    const unsigned below = ballot & ((1u << lane) - 1u);
    front[static_cast<int>(base >> 32) + __popc(below)] = e;
    const int first = static_cast<int>(base & 0xffffffffULL) + incl - items;
    for (int k = 0; k < items; ++k) {
      work_e[first + k] = e;
      work_j[first + k] = k;
    }
  }
}

// Work items of edge e: ceil(scan side / slice).
__device__ __forceinline__ int edge_items(int e, const int* __restrict__ u,
                                          const int* __restrict__ v,
                                          const int* __restrict__ Es,
                                          int slice) {
  const int a = __ldg(u + e);
  const int b = __ldg(v + e);
  const int da = __ldg(Es + a + 1) - __ldg(Es + a);
  const int db = __ldg(Es + b + 1) - __ldg(Es + b);
  return (min(da, db) + slice - 1) / slice;
}

// One pass over all m + 1 slots: S <- max(S - dec, l) off the frontier,
// the frontier marked processed, the next frontier formed and appended,
// dec zeroed.  Returns the lane's processed slots.  All threads of the grid
// call it.
__device__ __forceinline__ unsigned dense_walk(
    int* __restrict__ dec, int* __restrict__ S, uint8_t* __restrict__ proc,
    uint8_t* __restrict__ curr, int l, const int* __restrict__ u,
    const int* __restrict__ v, const int* __restrict__ Es,
    int* __restrict__ front, int* __restrict__ work_e,
    int* __restrict__ work_j, int* __restrict__ out, int m, int slice) {
  const int lane = threadIdx.x & 31;
  const long long slots = static_cast<long long>(m) + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned done = 0;
  // the loop test is on the warp's first slot, so all 32 lanes run the same
  // number of iterations and append_next sees every lane
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i - lane < slots; i += stride) {
    bool next = false;
    int items = 0;
    if (i < slots) {
      const bool p = proc[i] != 0;
      const bool c = curr[i] != 0;
      const int d = dec[i];
      int s = S[i];
      if (!p && !c && d > 0) {
        s = max(s - d, l);
        S[i] = s;
      }
      if (c) proc[i] = 1;
      next = !(p || c) && s == l && i < m;
      if (next != c) curr[i] = next ? 1 : 0;
      if (d != 0) dec[i] = 0;
      done += (p || c) ? 1u : 0u;
      if (next) items = edge_items(static_cast<int>(i), u, v, Es, slice);
    }
    append_next(next, static_cast<int>(i), items, front, work_e, work_j,
                out);
  }
  return done;
}

// The sparse kernel walks all slots instead when the touched list holds
// more than m / kDenseShare edges.
constexpr int kDenseShare = 8;

// The sparse update's body: in / out as for sparse_update_kernel.  All
// threads of the grid call it.
__device__ __forceinline__ void sparse_update(
    int* dec, int* S, uint8_t* proc, uint8_t* curr, int l,
    const int* __restrict__ u, const int* __restrict__ v,
    const int* __restrict__ Es, const int* touched, const int* front_in,
    const int* in, int* front_out, int* work_e, int* work_j, int* out, int m,
    int slice) {
  const int lane = threadIdx.x & 31;
  const int n_front = in[1];
  const int n_touched = in[3];
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  if (tid == 0) out[2] = in[2] + n_front;
  if (n_touched > m / kDenseShare) {
    dense_walk(dec, S, proc, curr, l, u, v, Es, front_out, work_e, work_j,
               out, m, slice);
    return;
  }
  for (int i = tid; i < n_front; i += stride) {
    const int e = front_in[i];
    proc[e] = 1;
    curr[e] = 0;
  }
  // the loop test is on the warp's first item, so all 32 lanes run the
  // same number of iterations and append_next sees every lane
  for (int t = tid; t - lane < n_touched; t += stride) {
    bool next = false;
    int e = 0;
    int items = 0;
    if (t < n_touched) {
      e = touched[t];
      const int s = max(S[e] - dec[e], l);
      S[e] = s;
      dec[e] = 0;
      next = s == l;
      if (next) {
        curr[e] = 1;
        items = edge_items(e, u, v, Es, slice);
      }
    }
    append_next(next, e, items, front_out, work_e, work_j, out);
  }
}

// in / out: int32 [n_items, n_front, n_done, n_touched] of this sub-level
// (read) and of the next (zeroed before the launch, written).
__global__ void __launch_bounds__(kThreads)
sparse_update_kernel(int* __restrict__ dec, int* __restrict__ S,
                     uint8_t* __restrict__ proc, uint8_t* __restrict__ curr,
                     const int* __restrict__ level, const int* __restrict__ u,
                     const int* __restrict__ v, const int* __restrict__ Es,
                     const int* __restrict__ touched,
                     const int* __restrict__ front_in,
                     const int* __restrict__ in, int* __restrict__ front_out,
                     int* __restrict__ work_e, int* __restrict__ work_j,
                     int* __restrict__ out, int m, int slice) {
  sparse_update(dec, S, proc, curr, __ldg(level), u, v, Es, touched,
                front_in, in, front_out, work_e, work_j, out, m, slice);
}

// out: as for the sparse kernel, zeroed before the launch.
__global__ void __launch_bounds__(kThreads)
dense_update_kernel(int* __restrict__ dec, int* __restrict__ S,
                    uint8_t* __restrict__ proc, uint8_t* __restrict__ curr,
                    const int* __restrict__ level, const int* __restrict__ u,
                    const int* __restrict__ v, const int* __restrict__ Es,
                    int* __restrict__ front, int* __restrict__ work_e,
                    int* __restrict__ work_j, int* __restrict__ out, int m,
                    int slice) {
  __shared__ unsigned block_done;
  if (threadIdx.x == 0) block_done = 0u;
  __syncthreads();
  unsigned done = dense_walk(dec, S, proc, curr, __ldg(level), u, v, Es,
                             front, work_e, work_j, out, m, slice);
  done = __reduce_add_sync(wedge::kFullMask, done);
  if ((threadIdx.x & 31) == 0 && done != 0u) atomicAdd(&block_done, done);
  __syncthreads();
  if (threadIdx.x == 0 && block_done != 0u) {
    atomicAdd(out + 2, static_cast<int>(block_done));
  }
}

// A level's start in the fused loop: min over the m + 1 slots of S (a
// processed slot counts as kSentinelS) into *lmin, and the processed slots
// into *done, one atomic of each per block.  All threads of the grid call
// it.
__device__ __forceinline__ void level_min(const int* S, const uint8_t* proc,
                                          int* lmin, int* done, int m) {
  __shared__ int block_min;
  __shared__ unsigned block_done;
  if (threadIdx.x == 0) {
    block_min = INT_MAX;
    block_done = 0u;
  }
  __syncthreads();
  const long long slots = static_cast<long long>(m) + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  int low = INT_MAX;
  unsigned n = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < slots; i += stride) {
    const bool p = proc[i] != 0;
    low = min(low, p ? kSentinelS : S[i]);
    n += p ? 1u : 0u;
  }
  low = __reduce_min_sync(wedge::kFullMask, low);
  n = __reduce_add_sync(wedge::kFullMask, n);
  if ((threadIdx.x & 31) == 0) {
    atomicMin(&block_min, low);
    if (n != 0u) atomicAdd(&block_done, n);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicMin(lmin, block_min);
    if (block_done != 0u) atomicAdd(done, static_cast<int>(block_done));
  }
}

// ctl: int32 [lmin[2], done[2], levels, sublevels, n_done, status, blocks];
// the level words alternate by level, the last five are the segment's
// result (blocks: the launch's grid).
constexpr int kLevelMin = 0;
constexpr int kLevelDone = 2;
constexpr int kResult = 4;
// status: the segment passed m sub-levels (each retires at least one edge)
constexpr int kOverrun = 1;

// One peel segment (see the top of this file).  counts: int32 (2, 4), the
// rows of the two frontier lists front (2, m + 1); the other operands as
// for the standalone kernels.  Launched cooperatively.
__global__ void __launch_bounds__(kThreads)
peel_loop_kernel(int* dec, int* S, uint8_t* proc, uint8_t* curr,
                 const int* __restrict__ u, const int* __restrict__ v,
                 const int* __restrict__ Es, const int* __restrict__ N,
                 const int* __restrict__ Eid,
                 const uint8_t* __restrict__ pin, int* touched, int* front,
                 int* work_e, int* work_j, int* counts, int* ctl, int m,
                 int slice, int stop_live) {
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const long long slots = static_cast<long long>(m) + 1;
  if (lead) {
    ctl[kLevelMin] = INT_MAX;
    ctl[kLevelDone] = 0;
  }
  grid.sync();
  int levels = 0;
  int subs = 0;
  int n_done = 0;
  int status = 0;
  int p = 0;  // the row of counts and front that holds the frontier
  for (;;) {
    // level start, 1: the level value and the processed count; the row the
    // dense walk writes is zeroed (the last sub-level read it)
    const int w = levels & 1;
    const int q = 1 - p;
    if (lead) {
      for (int k = 0; k < 4; ++k) counts[4 * q + k] = 0;
    }
    level_min(S, proc, ctl + kLevelMin + w, ctl + kLevelDone + w, m);
    grid.sync();
    const int l = ctl[kLevelMin + w];
    n_done = ctl[kLevelDone + w];
    if (slots - n_done <= stop_live) break;
    // level start, 2: the dense walk forms the level's first frontier; the
    // other level's words are reset for the next level
    if (lead) {
      ctl[kLevelMin + 1 - w] = INT_MAX;
      ctl[kLevelDone + 1 - w] = 0;
      counts[4 * q + 2] = n_done;
    }
    dense_walk(dec, S, proc, curr, l, u, v, Es, front + q * slots, work_e,
               work_j, counts + 4 * q, m, slice);
    grid.sync();
    p = q;
    ++levels;
    for (;;) {
      int* in = counts + 4 * p;
      int* out = counts + 4 * (1 - p);
      if (lead) {
        for (int k = 0; k < 4; ++k) out[k] = 0;
      }
      fold(in[0], work_e, work_j, in + 3, l, u, v, Es, N, Eid, S, proc, curr,
           pin, dec, touched, slice);
      grid.sync();
      sparse_update(dec, S, proc, curr, l, u, v, Es, touched,
                    front + p * slots, in, front + (1 - p) * slots, work_e,
                    work_j, out, m, slice);
      grid.sync();
      p = 1 - p;
      ++subs;
      if (subs > m) {
        status = kOverrun;
        break;
      }
      if (counts[4 * p + 1] == 0) break;
    }
    if (status != 0) {
      n_done = counts[4 * p + 2];
      break;
    }
  }
  if (lead) {
    ctl[kResult] = levels;
    ctl[kResult + 1] = subs;
    ctl[kResult + 2] = n_done;
    ctl[kResult + 3] = status;
    ctl[kResult + 4] = static_cast<int>(gridDim.x);
  }
}

}  // namespace

extern "C" int peel_decrement_fold_launch(
    const int* work_e, const int* work_j, int* counts, const int* level,
    const int* u, const int* v, const int* Es, const int* N, const int* Eid,
    const int* S, const uint8_t* proc, const uint8_t* curr,
    const uint8_t* pin, int* dec, int* touched, int slice, void* stream) {
  if (slice <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static wedge::GridCache grid;
  const int blocks = wedge::resident_grid(grid, peel_kernel, kThreads, 0);
  peel_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      work_e, work_j, counts, level, u, v, Es, N, Eid, S, proc, curr, pin,
      dec, touched, slice);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_update_launch(
    int* dec, int* S, uint8_t* proc, uint8_t* curr, const int* level,
    const int* u, const int* v, const int* Es, const int* touched,
    const int* front_in, const int* in, int* front_out, int* work_e,
    int* work_j, int* out, int m, int slice, void* stream) {
  if (m < 0 || slice <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  static wedge::GridCache grid;
  const int blocks = wedge::resident_grid(grid, sparse_update_kernel,
                                          kThreads, 0);
  sparse_update_kernel<<<blocks, kThreads, 0, s>>>(
      dec, S, proc, curr, level, u, v, Es, touched, front_in, in, front_out,
      work_e, work_j, out, m, slice);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_update_launch(
    int* dec, int* S, uint8_t* proc, uint8_t* curr, const int* level,
    const int* u, const int* v, const int* Es, int* front, int* work_e,
    int* work_j, int* out, int m, int slice, void* stream) {
  if (m < 0 || slice <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(m) + kThreads) / kThreads;
  static wedge::GridCache grid;
  const long long cap = wedge::resident_grid(grid, dense_update_kernel,
                                             kThreads, 0);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  dense_update_kernel<<<blocks, kThreads, 0, s>>>(dec, S, proc, curr, level,
                                                  u, v, Es, front, work_e,
                                                  work_j, out, m, slice);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the fused loop on `stream`: blocks = min(resident blocks,
// ceil((m + 1) / kThreads)), launched cooperatively (a refused launch
// returns its error: too many blocks, no cooperative launch).  The result
// is ctl[4:9] = [levels, sublevels, n_done, status, blocks], read after the
// launch.
extern "C" int peel_loop_launch(
    int* dec, int* S, uint8_t* proc, uint8_t* curr, const int* u,
    const int* v, const int* Es, const int* N, const int* Eid,
    const uint8_t* pin, int* touched, int* front, int* work_e, int* work_j,
    int* counts, int* ctl, int m, int slice, int stop_live, void* stream) {
  if (m < 0 || slice <= 0 || stop_live < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long need = (static_cast<long long>(m) + kThreads) / kThreads;
  static wedge::GridCache grid;
  const long long cap = wedge::resident_grid(grid, peel_loop_kernel,
                                             kThreads, 0);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  void* args[] = {&dec, &S, &proc, &curr, &u, &v, &Es, &N, &Eid, &pin,
                  &touched, &front, &work_e, &work_j, &counts, &ctl, &m,
                  &slice, &stop_live};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(peel_loop_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The resident grid of the fused loop and of K2 (blocks per SM times SMs)
// on the current device, for chip_smoke.py's register check.
extern "C" int peel_loop_grid(int* loop_blocks, int* fold_blocks) {
  static wedge::GridCache loop_grid;
  static wedge::GridCache fold_grid;
  *loop_blocks = wedge::resident_grid(loop_grid, peel_loop_kernel, kThreads,
                                      0);
  *fold_blocks = wedge::resident_grid(fold_grid, peel_kernel, kThreads, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* peel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
