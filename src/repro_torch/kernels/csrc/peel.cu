// K2: one ProcessSubLevel decrement fold over the peel wedge table, sm_90a.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/peel.py: peel_decrement_fold (body _peel_chunk_kernel).
// At level l a row counts if its chunk is active, its anchor e1 is on the
// frontier, the probe hits, and neither e2 = Eid[cand] nor e3 = Eid[safe]
// is processed.  Then dec[e2] += 1 if S[e2] > l, e2 is not pinned and
// (e3 is off the frontier or e1 < e3) — the paper's lowest-id tie-break —
// and the same for e3.
//
// Design, against what the TPU kernel assumed:
//  * The TPU grid walks the chunks in order with one (m+1,) accumulator in
//    VMEM.  Here one block takes one chunk and loops over its rows; the
//    wrapper zeroes dec and the rows fold in with integer atomicAdd, exact
//    in any order.  Misses and rows that do not count write nothing (no
//    sentinel slot m traffic), so dec[m] stays 0.
//  * The launch covers all n_chunks and needs no host sync: the active
//    chunk mask stays on the device and a block whose chunk is inactive
//    returns at once.  The level l is read from device memory for the same
//    reason.
//  * The processed / frontier / pinned masks are bytes, not int32, which
//    cuts the state gathers four times.  pinned may be null (no schedule
//    edges).
//  * A row whose anchor is off the frontier is dropped after one 4-byte
//    read of e1 and a 1-byte gather; only frontier rows load the rest of
//    the row and probe.
//
// What bounds it: per call, the bytes it must move — the 4-byte anchor of
// every row of an active chunk, the other 12 bytes of the frontier rows,
// the adjacency and the state vectors; chip_smoke.py computes that bound
// for each launch it checks.  In a run without compaction every peel row
// is a frontier row exactly once, so the launches together must stream
// the table at least once: at Graph500 scale 17, 419,465,131 rows x 16 B
// = 6.7 GB, about 2.0 ms at 3.35 TB/s (compaction rebuilds the survivors'
// rows, somewhat fewer).  The probe gathers into N and Eid hit L2 (15 MB
// each at scale 17), so frontier-heavy sub-levels wait on L2 latency.
#include "wedge_common.cuh"

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
peel_kernel(const uint8_t* __restrict__ active, const int* __restrict__ level,
            const int* __restrict__ e1, const int* __restrict__ cand,
            const int* __restrict__ lo, const int* __restrict__ hi,
            const int* __restrict__ N, const int* __restrict__ Eid,
            const int* __restrict__ S, const uint8_t* __restrict__ proc,
            const uint8_t* __restrict__ curr,
            const uint8_t* __restrict__ pin, int* __restrict__ dec,
            int chunk, int iters, int two_m) {
  const long long c = blockIdx.x;
  if (!__ldg(active + c)) return;
  const int l = __ldg(level);
  const long long base = c * chunk;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long long r = base + i;
    const int a = __ldg(e1 + r);
    if (!__ldg(curr + a)) continue;  // padding rows carry a == m: curr[m] = 0
    const int cs = __ldg(cand + r);
    int safe = 0;
    if (!wedge::probe(N, two_m, cs, __ldg(lo + r), __ldg(hi + r), iters,
                      &safe)) {
      continue;
    }
    const int e2 = __ldg(Eid + cs);
    const int e3 = __ldg(Eid + safe);
    if (__ldg(proc + e2) || __ldg(proc + e3)) continue;
    const bool in2 = __ldg(curr + e2) != 0;
    const bool in3 = __ldg(curr + e3) != 0;
    const bool pin2 = pin != nullptr && __ldg(pin + e2) != 0;
    const bool pin3 = pin != nullptr && __ldg(pin + e3) != 0;
    if (__ldg(S + e2) > l && (!in3 || a < e3) && !pin2) atomicAdd(dec + e2, 1);
    if (__ldg(S + e3) > l && (!in2 || a < e2) && !pin3) atomicAdd(dec + e3, 1);
  }
}

}  // namespace

extern "C" int peel_decrement_fold_launch(
    const uint8_t* active, const int* level, const int* e1, const int* cand,
    const int* lo, const int* hi, const int* N, const int* Eid, const int* S,
    const uint8_t* proc, const uint8_t* curr, const uint8_t* pin, int* dec,
    long long n_chunks, int chunk, int iters, int two_m, void* stream) {
  if (n_chunks <= 0 || chunk <= 0) return static_cast<int>(cudaSuccess);
  if (n_chunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // a whole number of warps, at most kMaxThreads, no more than the chunk needs
  int threads = ((chunk + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  peel_kernel<<<static_cast<unsigned>(n_chunks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      active, level, e1, cand, lo, hi, N, Eid, S, proc, curr, pin, dec, chunk,
      iters, two_m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* peel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
