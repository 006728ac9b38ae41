// K2: one ProcessSubLevel decrement fold, frontier-driven and fed by the
// CSR, and the fused sub-level state update that makes its next frontier;
// sm_90a.
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
//    update kernel below appends each new frontier edge's items with one
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
//
// update_kernel replaces the jnp body of one sub-level of the JAX package's
// peel loop (src/repro/core/pkt.py, `sublevel`): in one pass over m + 1
// slots it applies S <- max(S - dec, l) off the frontier, marks the frontier
// processed, forms the next frontier S == l, appends its work items, zeroes
// dec for the next fold and counts the processed slots.  Run with dec = 0
// and an empty frontier it forms a level's first frontier.
//
// What bounds them: per sub-level, the adjacency lists the frontier's edges
// scan and probe, Eid of the hit slots and the state of the touched edges
// (K2), and one pass over the (m + 1,) state (update); chip_smoke.py counts
// those bytes and the search compares from the run's own states.
#include "wedge_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the id a lane past the end of the slice searches for (never stored)
constexpr int kNoId = -1;

// One wedge hit of frontier edge e1: candidate slot c, probe slot p.
__device__ __forceinline__ void fold_hit(
    int e1, int c, int p, int l, const int* __restrict__ Eid,
    const int* __restrict__ S, const uint8_t* __restrict__ proc,
    const uint8_t* __restrict__ curr, const uint8_t* __restrict__ pin,
    int* __restrict__ dec) {
  const int e2 = __ldg(Eid + c);
  const int e3 = __ldg(Eid + p);
  if (__ldg(proc + e2) || __ldg(proc + e3)) return;
  const bool in2 = __ldg(curr + e2) != 0;
  const bool in3 = __ldg(curr + e3) != 0;
  const bool pin2 = pin != nullptr && __ldg(pin + e2) != 0;
  const bool pin3 = pin != nullptr && __ldg(pin + e3) != 0;
  if (__ldg(S + e2) > l && (!in3 || e1 < e3) && !pin2) atomicAdd(dec + e2, 1);
  if (__ldg(S + e3) > l && (!in2 || e1 < e2) && !pin3) atomicAdd(dec + e3, 1);
}

__global__ void __launch_bounds__(kThreads)
peel_kernel(const int* __restrict__ work_e, const int* __restrict__ work_j,
            const int* __restrict__ counts, const int* __restrict__ level,
            const int* __restrict__ u, const int* __restrict__ v,
            const int* __restrict__ Es, const int* __restrict__ N,
            const int* __restrict__ Eid, const int* __restrict__ S,
            const uint8_t* __restrict__ proc,
            const uint8_t* __restrict__ curr,
            const uint8_t* __restrict__ pin, int* __restrict__ dec,
            int slice) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_items = counts[0];
  const int l = __ldg(level);
  const int all_warps = gridDim.x * kWarps;
  for (int t = blockIdx.x * kWarps + warp; t < n_items; t += all_warps) {
    const int e1 = __ldg(work_e + t);
    const int j = __ldg(work_j + t);
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
    // each lane takes two candidates a step, c and c + 32
    for (int c = c0 + lane; c < c1; c += 64) {
      const int cb = c + 32;
      const int wb = cb < c1 ? __ldg(N + cb) : kNoId;
      int sa = -1;
      int sb = -1;
      wedge::find2(plist, plen, __ldg(N + c), wb, &sa, &sb);
      if (sa >= 0) fold_hit(e1, c, lo + sa, l, Eid, S, proc, curr, pin, dec);
      if (cb < c1 && sb >= 0) {
        fold_hit(e1, cb, lo + sb, l, Eid, S, proc, curr, pin, dec);
      }
    }
  }
}

// counts: int32 [n_items, n_front, n_done, unused]; the first two form one
// little-endian 64-bit word (n_front high, n_items low), zeroed before the
// launch.
__global__ void __launch_bounds__(kThreads)
update_kernel(int* __restrict__ dec, int* __restrict__ S,
              uint8_t* __restrict__ proc, uint8_t* __restrict__ curr,
              const int* __restrict__ level, const int* __restrict__ u,
              const int* __restrict__ v, const int* __restrict__ Es,
              int* __restrict__ work_e, int* __restrict__ work_j,
              int* __restrict__ counts, int m, int slice) {
  const int l = __ldg(level);
  const int lane = threadIdx.x & 31;
  const long long slots = static_cast<long long>(m) + 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  unsigned done = 0;
  // the loop test is on the warp's first slot, so all 32 lanes run the same
  // number of iterations and the warp-wide intrinsics below see every lane
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
      if (next) {
        const int a = __ldg(u + i);
        const int b = __ldg(v + i);
        const int da = __ldg(Es + a + 1) - __ldg(Es + a);
        const int db = __ldg(Es + b + 1) - __ldg(Es + b);
        const int scan = min(da, db);
        items = (scan + slice - 1) / slice;
      }
    }
    const unsigned ballot = __ballot_sync(wedge::kFullMask, next);
    if (ballot == 0u) continue;
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
      base = atomicAdd(reinterpret_cast<unsigned long long*>(counts), add);
    }
    base = __shfl_sync(wedge::kFullMask, base, 0);
    if (next) {
      const int first = static_cast<int>(base & 0xffffffffULL) + incl - items;
      for (int k = 0; k < items; ++k) {
        work_e[first + k] = static_cast<int>(i);
        work_j[first + k] = k;
      }
    }
  }
  done = __reduce_add_sync(wedge::kFullMask, done);
  if (lane == 0 && done != 0u) atomicAdd(counts + 2, static_cast<int>(done));
}

}  // namespace

extern "C" int peel_decrement_fold_launch(
    const int* work_e, const int* work_j, const int* counts, const int* level,
    const int* u, const int* v, const int* Es, const int* N, const int* Eid,
    const int* S, const uint8_t* proc, const uint8_t* curr,
    const uint8_t* pin, int* dec, int slice, void* stream) {
  if (slice <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static wedge::GridCache grid;
  const int blocks = wedge::resident_grid(grid, peel_kernel, kThreads, 0);
  peel_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      work_e, work_j, counts, level, u, v, Es, N, Eid, S, proc, curr, pin,
      dec, slice);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sublevel_update_launch(
    int* dec, int* S, uint8_t* proc, uint8_t* curr, const int* level,
    const int* u, const int* v, const int* Es, int* work_e, int* work_j,
    int* counts, int m, int slice, void* stream) {
  if (m < 0 || slice <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, 3 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(m) + kThreads) / kThreads;
  static wedge::GridCache grid;
  const long long cap = wedge::resident_grid(grid, update_kernel, kThreads,
                                             0);
  const int blocks = static_cast<int>(need < cap ? need : cap);
  update_kernel<<<blocks, kThreads, 0, s>>>(dec, S, proc, curr, level, u, v,
                                            Es, work_e, work_j, counts, m,
                                            slice);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* peel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
