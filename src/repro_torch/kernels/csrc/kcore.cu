// The k-core decomposition as one cooperative launch; sm_90a.
//
// kcore_kernel computes every vertex's coreness: the level-synchronous peel
// of core/kcore.py: peel_cores (ParK), frontier-driven.  It replaces no TPU
// kernel: the JAX package peels cores with jnp operations in a
// lax.while_loop (src/repro/core/kcore.py: kcore_park), and the port ran the
// same loop as torch operations, one pass over every adjacency slot and one
// host read a sub-level (about 800 sub-levels over 7.6 M slots at Graph500
// scale 18).
//
// The semantics are peel_cores', sub-level for sub-level:
//  * Level l removes, sub-level by sub-level, the frontier {v alive :
//    deg[v] <= l} at once; a level ends on an empty sub-level, and the peel
//    once no vertex is alive.  Each sub-level, empty ones included, counts.
//  * A level's first frontier comes from one scan of the vertices.  Within
//    a level every alive vertex off the frontier has deg > l, so a later
//    frontier is exactly the neighbours whose degree a decrement takes from
//    l + 1 to l: the decrement that returns l + 1 appends the vertex, once.
//  * A frontier's members are marked dead (core[v] = l) when they are
//    appended, before the barrier that opens their sub-level, so only alive
//    vertices off the frontier are decremented.  A vertex appended during a
//    sub-level may still take a decrement in it, or miss one: its degree is
//    past use once it is dead, and only decrements that come after its
//    crossing can see it dead.
//
// Design:
//  * The retired vertices form one list in the order they die (list_v),
//    each with its first work item (list_item): a frontier is a range of
//    the list.  A warp appends its lanes' vertices with one 64-bit atomic
//    that returns both the list position and the item offset, so the list
//    needs no scan pass.
//  * Work items split hubs.  An item is kSlice consecutive slots of one
//    frontier vertex's row; one warp walks one item, a lane kSlice / 32
//    slots with their loads and decrements in flight together.  A warp
//    finds its item's vertex by a 32-way search of the frontier's item
//    offsets (four rounds at 2^18 vertices).  A Graph500 hub of 10^4-10^5
//    slots spreads over hundreds of warps instead of serializing its
//    sub-level.
//  * Phases are separated by grid-wide barriers (cooperative_groups grid
//    sync), one a sub-level.  State that a later phase rewrites (deg, core,
//    the list) is read with plain loads, never through the read-only cache.
//    Every block reads the same appended counts after a barrier, so every
//    block takes the same branch.  A phase appends to one of three counter
//    rows, which the lead thread zeroes two phases ahead, when no block can
//    still be reading it (as csrc/peel.cu alternates its count rows).
//  * The grid is the blocks the SMs hold at once, at most one block per 256
//    vertices (as peel_loop_kernel's).
//  * A simple graph peels in at most 2n sub-levels (at most n levels, and
//    each nonempty sub-level retires a vertex; a clique of n takes n + 1);
//    past that the kernel stops and reports it (status 1), and the wrapper
//    raises.
//
// What bounds it: each slot read once when its vertex dies (4 bytes, and a
// decrement of its neighbour's degree), plus one scan of the n degrees and
// states a level; and the barriers, one a sub-level, which at Graph500
// scale 18 (about 800 of them) outweigh the bytes.
#include <cooperative_groups.h>

#include "wedge_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = wedge::kFullMask;
// slots of one work item, and of one lane in it
constexpr int kSlice = 128;
constexpr int kPerLane = kSlice / 32;
// the coreness of a vertex still alive
constexpr int kAlive = -1;
// status: the peel passed 2n sub-levels
constexpr int kOverrun = 1;

// Append the lanes whose `want` is set to the list at level l: each is
// marked dead and gets its list position and first work item.  tail counts
// this phase's appends, (items << 32) | vertices; the phase's first position
// and item are `base_v` and `base_item`.  All 32 lanes call it.
__device__ __forceinline__ void append(bool want, int v, int l, int* core,
                                       const int* __restrict__ Es,
                                       int* list_v, int* list_item,
                                       unsigned long long* tail, int base_v,
                                       int base_item) {
  const unsigned mask = __ballot_sync(kFullMask, want);
  if (mask == 0u) return;
  const int lane = threadIdx.x & 31;
  int items = 0;
  if (want) {
    core[v] = l;
    items = (__ldg(Es + v + 1) - __ldg(Es + v) + kSlice - 1) / kSlice;
  }
  int incl = items;  // inclusive prefix of the lanes' items
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFullMask, incl, d);
    if (lane >= d) incl += t;
  }
  const int total = __shfl_sync(kFullMask, incl, 31);
  const int leader = __ffs(mask) - 1;
  unsigned long long old = 0;
  if (lane == leader) {
    old = atomicAdd(tail, (static_cast<unsigned long long>(total) << 32) |
                              static_cast<unsigned long long>(__popc(mask)));
  }
  old = __shfl_sync(kFullMask, old, leader);
  if (want) {
    const int pos = base_v + static_cast<int>(old & 0xffffffffull) +
                    __popc(mask & ((1u << lane) - 1u));
    list_v[pos] = v;
    list_item[pos] = base_item + static_cast<int>(old >> 32) + incl - items;
  }
}

// A level's first frontier: every alive vertex with deg <= l.  All threads
// of the grid call it.
__device__ __forceinline__ void level_scan(int l, int n,
                                           const int* __restrict__ Es,
                                           const int* deg, int* core,
                                           int* list_v, int* list_item,
                                           unsigned long long* tail,
                                           int base_v, int base_item) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x +
                     (threadIdx.x & ~31);
       w < n; w += stride) {  // warp-uniform: w is the warp's first vertex
    const long long v = w + lane;
    const bool want = v < n && core[v] == kAlive && deg[v] <= l;
    append(want, static_cast<int>(v), l, core, Es, list_v, list_item, tail,
           base_v, base_item);
  }
}

// The list position in [a, b) of work item t: the last whose first item is
// <= t (list_item rises along the list, and list_item[a] <= t).  A 32-way
// search; all 32 lanes call it and get the answer.
__device__ __forceinline__ int find_item(const int* list_item, int a, int b,
                                         int t) {
  const int lane = threadIdx.x & 31;
  int lo = a;
  int len = b - a;
  while (len > 32) {
    const int step = (len + 31) >> 5;
    const int k0 = lane * step;
    const bool le = k0 < len && list_item[lo + k0] <= t;
    const int k = 31 - __clz(__ballot_sync(kFullMask, le));
    lo += k * step;
    len = min(step, len - k * step);
  }
  const bool le = lane < len && list_item[lo + lane] <= t;
  return lo + 31 - __clz(__ballot_sync(kFullMask, le));
}

// One nonempty sub-level at level l: the frontier is the list's [a, b),
// its work items [ia, ib).  Each slot of a frontier vertex decrements its
// neighbour if alive, and appends it when the degree crosses from l + 1.
// All threads of the grid call it.
__device__ __forceinline__ void walk(int l, int a, int b, int ia, int ib,
                                     const int* __restrict__ Es,
                                     const int* __restrict__ N, int* deg,
                                     int* core, int* list_v, int* list_item,
                                     unsigned long long* tail, int base_v,
                                     int base_item) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int t = ia + ((blockIdx.x * blockDim.x + threadIdx.x) >> 5); t < ib;
       t += warps) {  // warp-uniform
    const int i = find_item(list_item, a, b, t);
    const int v = list_v[i];
    const int lo = __ldg(Es + v) + (t - list_item[i]) * kSlice;
    const int hi = min(lo + kSlice, __ldg(Es + v + 1));
    int u[kPerLane];
    bool cross[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int j = lo + k * 32 + lane;
      u[k] = j < hi ? __ldg(N + j) : -1;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      cross[k] = u[k] >= 0 && core[u[k]] == kAlive;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (cross[k]) cross[k] = atomicSub(deg + u[k], 1) == l + 1;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      append(cross[k], u[k], l, core, Es, list_v, list_item, tail, base_v,
             base_item);
    }
  }
}

// result: int32 [sublevels, status, blocks]
constexpr int kSublevels = 0;
constexpr int kStatus = 1;
constexpr int kBlocks = 2;

// The whole peel (see the top of this file).  Es (n + 1) and N: the CSR;
// deg, core, list_v, list_item: (n,) scratch and output (core); tails: three
// zeroed 64-bit counter rows.  Launched cooperatively.
__global__ void __launch_bounds__(kThreads)
kcore_kernel(const int* __restrict__ Es, const int* __restrict__ N, int n,
             int* deg, int* core, int* list_v, int* list_item,
             unsigned long long* tails, int* result) {
  cg::grid_group grid = cg::this_grid();
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  const int stride = gridDim.x * blockDim.x;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n; v += stride) {
    deg[v] = __ldg(Es + v + 1) - __ldg(Es + v);
    core[v] = kAlive;
  }
  grid.sync();
  const long long max_subs = 2LL * n;
  int phase = 0;  // phases run; phase p appends to tails[p % 3]
  int done = 0;   // list positions [0, done) hold the retired vertices
  int items = 0;  // and their work items [0, items)
  int l = 0;
  long long subs = 0;
  int status = 0;
  for (;;) {
    // a level's first sub-level: the scan
    if (lead) tails[(phase + 1) % 3] = 0ull;
    level_scan(l, n, Es, deg, core, list_v, list_item, tails + phase % 3,
               done, items);
    grid.sync();
    unsigned long long got = tails[phase % 3];
    ++phase;
    ++subs;
    int a = done;
    int ia = items;
    done += static_cast<int>(got & 0xffffffffull);
    items += static_cast<int>(got >> 32);
    // the level's later sub-levels, while the frontier is not empty
    while (done > a) {  // each pass retires a vertex: at most n in all
      if (lead) tails[(phase + 1) % 3] = 0ull;
      walk(l, a, done, ia, items, Es, N, deg, core, list_v, list_item,
           tails + phase % 3, done, items);
      grid.sync();
      got = tails[phase % 3];
      ++phase;
      ++subs;
      a = done;
      ia = items;
      done += static_cast<int>(got & 0xffffffffull);
      items += static_cast<int>(got >> 32);
    }
    if (done >= n) break;
    if (subs > max_subs) {
      status = kOverrun;
      break;
    }
    ++l;
  }
  if (lead) {
    result[kSublevels] = static_cast<int>(subs);
    result[kStatus] = status;
    result[kBlocks] = static_cast<int>(gridDim.x);
  }
}

}  // namespace

// One launch on `stream`: blocks = min(resident blocks, ceil(n / kThreads)),
// launched cooperatively (a refused launch returns its error).  tails must
// be three zeroed 64-bit words; the result is
// result[0:3] = [sublevels, status, blocks], read after the launch.
extern "C" int kcore_launch(const int* Es, const int* N, int* deg, int* core,
                            int* list_v, int* list_item, void* tails,
                            int* result, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long need = (static_cast<long long>(n) + kThreads - 1) /
                         kThreads;
  static wedge::GridCache grid;
  const long long cap = wedge::resident_grid(grid, kcore_kernel, kThreads, 0);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  unsigned long long* t = static_cast<unsigned long long*>(tails);
  void* args[] = {&Es, &N, &n, &deg, &core, &list_v, &list_item, &t,
                  &result};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kcore_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kcore_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
