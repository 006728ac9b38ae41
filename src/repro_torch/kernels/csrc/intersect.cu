// K3: row-wise intersection of padded id rows, sm_90a: a sorted search per
// row where the row allows it, all-pairs equality where it does not.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/intersect.py: intersect_blocked (body
// _intersect_kernel).  For every row r of a (E, DA) and b (E, DB):
//   hit_a[r, i] = 1 if a[r, i] equals some b[r, j]
//   hit_b[r, j] = 1 if b[r, j] equals some a[r, i]
//   count[r]    = sum_i hit_a[r, i]
// Rows may be unsorted and may repeat ids; padding (-1 in a, -2 in b by the
// callers' convention) is compared like any id and never matches.
//
// Design, against what the TPU kernel assumed:
//  * The TPU kernel builds a (BE, DA, DB) compare cube in VMEM per grid
//    step.  Here one warp takes one row at a time and stages the row's B in
//    the warp's slice of shared memory; each lane holds up to kA of the
//    row's A ids in registers.  No cube exists.
//  * The warp picks the row's path from the data.  It counts the descents
//    of the staged B with a ballot: they split B into maximal
//    non-decreasing runs.  A CSR row (the degree-class buckets) has two,
//    the sorted ids and then the constant -2 padding.  With at most kRuns
//    runs each lane binary-searches each of its A ids in each run
//    (DA * ceil(log2(DB + 1)) compares for the row, against DA * DB), and
//    a constant run takes one compare.  A hit sets the hit_b flag of every
//    slot of the equal range, so duplicates in B stay right.  A row of
//    more runs takes the all-pairs scan: each B id (a broadcast read) is
//    compared with all of the lane's A ids.
//  * hit_b is a shared-memory flag per B slot: a lane that matches stores
//    1 (several lanes may store the same 1; any of them wins).  count is a
//    warp reduction (__reduce_add_sync) of the lanes' hit_a bits.
//  * A block takes block_rows rows (the wrapper's block_rows, as in the
//    JAX grid), its warps striding over them; the grid covers E.  Each
//    block adds the rows that took each path to path_rows once.
//  * Lanes past the end of A compare a copy of the row's last A id: its
//    matches set the same hit_b flags as the real slot, and the copy's own
//    hit_a is neither stored nor counted.  So the loops need no predicate.
//
// What bounds it: the bytes.  At the degree-class buckets of Graph500
// scale 17 (D = 8 ... 256, E*D = 277,169,176 row slots) a and b are read
// and count, hit_a and hit_b written once, 16 B per slot, 4.43 GB, about
// 1.33 ms at 3.35 TB/s.  The search (or a merge) needs at most 2 * D
// compares a row, 5.5e8 in all, about 0.03 ms at the H100's 16.73 T int32
// operations/s; the all-pairs scan needed sum E*D^2 = 6.32e10, 3.8 ms.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 8;
// a block's shared memory on the H100 (227 KB)
constexpr size_t kMaxSmem = 232448;
// the most non-decreasing runs of B a row may have to be searched
constexpr int kRuns = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// The lower bound of w in the sorted p[0:n) (n >= 1): the first index
// whose value is >= w, or n.  Branch-free; the same ceil(log2(n)) halvings
// for any w, so a warp searching one run stays in step.
template <typename T>
__device__ __forceinline__ int lower_bound(const T* p, int n, T w) {
  int base = 0;
  while (n > 1) {
    const int half = n >> 1;
    base = p[base + half] < w ? base + half : base;
    n -= half;
  }
  return base + (p[base] < w ? 1 : 0);
}

template <typename T, int kA>
__global__ void __launch_bounds__(kMaxWarps * 32)
intersect_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 int* __restrict__ cnt, int* __restrict__ hita,
                 int* __restrict__ hitb,
                 unsigned long long* __restrict__ path_rows, long long E,
                 int DA, int DB, int block_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned block_rows_by_path[2];
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31u);
  if (threadIdx.x < 2) block_rows_by_path[threadIdx.x] = 0u;
  __syncthreads();
  // the int flags first, then the staged ids: both stay aligned
  int* flags = reinterpret_cast<int*>(smem) + static_cast<size_t>(warp) * DB;
  T* sb = reinterpret_cast<T*>(smem + static_cast<size_t>(warps) * DB *
                                          sizeof(int)) +
          static_cast<size_t>(warp) * DB;
  unsigned searched = 0;
  unsigned scanned = 0;
  const long long r0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long r1 = r0 + block_rows < E ? r0 + block_rows : E;
  for (long long r = r0 + warp; r < r1; r += warps) {
    const T* brow = b + r * DB;
    for (int j = lane; j < DB; j += 32) {
      sb[j] = brow[j];
      flags[j] = 0;
    }
    __syncwarp();
    // the starts of B's non-decreasing runs (registers: constant indices);
    // runs stops counting past kRuns
    int start[kRuns + 1];
#pragma unroll
    for (int q = 0; q <= kRuns; ++q) start[q] = DB;
    start[0] = 0;
    int runs = DB > 0 ? 1 : 0;
    for (int base = 0; base < DB && runs <= kRuns; base += 32) {
      const int j = base + lane;
      unsigned desc = __ballot_sync(kFullMask, j > 0 && j < DB &&
                                                   sb[j] < sb[j - 1]);
      while (desc != 0u && runs <= kRuns) {
        const int pos = base + __ffs(desc) - 1;
        desc &= desc - 1u;
#pragma unroll
        for (int q = 1; q <= kRuns; ++q) {
          if (q == runs) start[q] = pos;
        }
        ++runs;
      }
    }
    const bool search = runs <= kRuns;
    const T* arow = a + r * DA;
    int* harow = hita + r * DA;
    int count = 0;
    for (int base = 0; base < DA; base += 32 * kA) {
      T av[kA];
      bool h[kA];
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        const int i = base + k * 32 + lane;
        av[k] = arow[i < DA ? i : DA - 1];
        h[k] = false;
      }
      if (search) {
#pragma unroll
        for (int q = 0; q < kRuns; ++q) {
          if (q >= runs) break;
          const int s = start[q];
          const int n = start[q + 1] - s;
          const T first = sb[s];
          const T last = sb[s + n - 1];
          if (first == last) {
            // a constant run (the padding): one compare, the whole run hit
            bool any = false;
#pragma unroll
            for (int k = 0; k < kA; ++k) {
              const bool eq = av[k] == first;
              h[k] |= eq;
              any |= eq;
            }
            if (__any_sync(kFullMask, any)) {
              for (int j = s + lane; j < s + n; j += 32) flags[j] = 1;
            }
            continue;
          }
#pragma unroll
          for (int k = 0; k < kA; ++k) {
            const T w = av[k];
            if (w < first || w > last) continue;
            int j = s + lower_bound(sb + s, n, w);
            if (j < s + n && sb[j] == w) {
              h[k] = true;
              for (; j < s + n && sb[j] == w; ++j) flags[j] = 1;
            }
          }
        }
      } else {
        for (int j = 0; j < DB; ++j) {
          const T bj = sb[j];
          bool any = false;
#pragma unroll
          for (int k = 0; k < kA; ++k) {
            const bool eq = av[k] == bj;
            h[k] |= eq;
            any |= eq;
          }
          if (any) flags[j] = 1;
        }
      }
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        const int i = base + k * 32 + lane;
        if (i < DA) {
          harow[i] = h[k] ? 1 : 0;
          count += h[k] ? 1 : 0;
        }
      }
    }
    count = __reduce_add_sync(kFullMask, count);
    if (lane == 0) {
      cnt[r] = count;
      searched += search ? 1u : 0u;
      scanned += search ? 0u : 1u;
    }
    __syncwarp();
    int* hbrow = hitb + r * DB;
    for (int j = lane; j < DB; j += 32) hbrow[j] = flags[j];
    // the next row restages sb and flags only after every lane has read them
    __syncwarp();
  }
  if (lane == 0 && searched != 0u) atomicAdd(block_rows_by_path, searched);
  if (lane == 0 && scanned != 0u) {
    atomicAdd(block_rows_by_path + 1, scanned);
  }
  __syncthreads();
  if (threadIdx.x < 2 && block_rows_by_path[threadIdx.x] != 0u) {
    atomicAdd(path_rows + threadIdx.x,
              static_cast<unsigned long long>(
                  block_rows_by_path[threadIdx.x]));
  }
}

template <typename T, int kA>
int launch_as(const T* a, const T* b, int* cnt, int* hita, int* hitb,
              unsigned long long* path_rows, long long E, int DA, int DB,
              int block_rows, int warps, size_t smem, cudaStream_t stream) {
  const long long blocks = (E + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_kernel<T, kA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  intersect_kernel<T, kA><<<static_cast<unsigned>(blocks), warps * 32, smem,
                            stream>>>(a, b, cnt, hita, hitb, path_rows, E, DA,
                                      DB, block_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b, int* cnt, int* hita, int* hitb,
           unsigned long long* path_rows, long long E, int DA, int DB,
           int block_rows, void* stream) {
  if (E <= 0) return static_cast<int>(cudaSuccess);
  if (DA < 0 || DB < 0 || block_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // warps per block: no more than the block's rows, and the staged rows of
  // all of them must fit in shared memory
  const size_t per_warp = static_cast<size_t>(DB) * (sizeof(int) + sizeof(T));
  int warps = block_rows < kMaxWarps ? block_rows : kMaxWarps;
  while (warps > 1 && per_warp * warps > kMaxSmem) --warps;
  if (per_warp > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = per_warp * warps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // A ids a lane holds in registers: the fewest of 1, 2, 4, 8 that cover
  // the row in one pass, 8 (and several passes) beyond 256
  const int per_lane = (DA + 31) / 32;
  if (per_lane <= 1) {
    return launch_as<T, 1>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                           block_rows, warps, smem, s);
  }
  if (per_lane <= 2) {
    return launch_as<T, 2>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                           block_rows, warps, smem, s);
  }
  if (per_lane <= 4) {
    return launch_as<T, 4>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                           block_rows, warps, smem, s);
  }
  return launch_as<T, 8>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                         block_rows, warps, smem, s);
}

}  // namespace

// path_rows: uint64 [rows searched, rows scanned all-pairs], added to.
extern "C" int intersect_i32_launch(const int32_t* a, const int32_t* b,
                                    int* cnt, int* hita, int* hitb,
                                    unsigned long long* path_rows,
                                    long long E, int DA, int DB,
                                    int block_rows, void* stream) {
  return launch<int32_t>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                         block_rows, stream);
}

extern "C" int intersect_i16_launch(const int16_t* a, const int16_t* b,
                                    int* cnt, int* hita, int* hitb,
                                    unsigned long long* path_rows,
                                    long long E, int DA, int DB,
                                    int block_rows, void* stream) {
  return launch<int16_t>(a, b, cnt, hita, hitb, path_rows, E, DA, DB,
                         block_rows, stream);
}

extern "C" const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
