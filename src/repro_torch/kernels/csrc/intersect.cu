// K3: row-wise intersection of padded id rows (all-pairs equality), sm_90a.
//
// Replaces the Pallas kernel of the JAX package,
// src/repro/kernels/intersect.py: intersect_blocked (body
// _intersect_kernel).  For every row r of a (E, DA) and b (E, DB):
//   hit_a[r, i] = 1 if a[r, i] equals some b[r, j]
//   hit_b[r, j] = 1 if b[r, j] equals some a[r, i]
//   count[r]    = sum_i hit_a[r, i]
// Every pair is compared, so the result needs no order in the rows and is
// right for unsorted rows and duplicate ids; padding (-1 in a, -2 in b by
// the callers' convention) is compared like any id and never matches.
//
// Design, against what the TPU kernel assumed:
//  * The TPU kernel builds a (BE, DA, DB) compare cube in VMEM per grid
//    step.  Here one warp takes one row at a time: the row's B is staged in
//    the warp's slice of shared memory, each lane holds up to kA of the
//    row's A ids in registers and scans the staged B once, comparing each
//    B id (a broadcast read) with all of its A ids.  No cube exists.
//  * hit_b is a shared-memory flag per B slot: a lane that matches stores
//    1 (several lanes may store the same 1; any of them wins).  count is a
//    warp reduction (__reduce_add_sync) of the lanes' hit_a bits.
//  * A block takes block_rows rows (the wrapper's block_rows, as in the
//    JAX grid), its warps striding over them; the grid covers E.
//  * Lanes past the end of A compare a copy of the row's last A id: its
//    matches set the same hit_b flags as the real slot, and the copy's own
//    hit_a is neither stored nor counted.  So the loop needs no predicate.
//
// What bounds it: the compares.  At the degree-class buckets of Graph500
// scale 17 (D = 8 ... 256, E*D = 277,169,176 row slots) the all-pairs work
// is sum E*D^2 = 6.32e10 compares, about 3.8 ms at the H100's 16.73 T int32
// operations/s, against 16 B per slot of reads and writes, 4.43 GB, about
// 1.33 ms at 3.35 TB/s.  A sorted-merge or binary-search form would do
// O(D log D) work per row and approach that byte floor (later work).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxWarps = 8;
// a block's shared memory on the H100 (227 KB)
constexpr size_t kMaxSmem = 232448;

template <typename T, int kA>
__global__ void __launch_bounds__(kMaxWarps * 32)
intersect_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 int* __restrict__ cnt, int* __restrict__ hita,
                 int* __restrict__ hitb, long long E, int DA, int DB,
                 int block_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = static_cast<int>(blockDim.x >> 5);
  const int warp = static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31u);
  // the int flags first, then the staged ids: both stay aligned
  int* flags = reinterpret_cast<int*>(smem) + static_cast<size_t>(warp) * DB;
  T* sb = reinterpret_cast<T*>(smem + static_cast<size_t>(warps) * DB *
                                          sizeof(int)) +
          static_cast<size_t>(warp) * DB;
  const long long r0 = static_cast<long long>(blockIdx.x) * block_rows;
  const long long r1 = r0 + block_rows < E ? r0 + block_rows : E;
  for (long long r = r0 + warp; r < r1; r += warps) {
    const T* brow = b + r * DB;
    for (int j = lane; j < DB; j += 32) {
      sb[j] = brow[j];
      flags[j] = 0;
    }
    __syncwarp();
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
#pragma unroll
      for (int k = 0; k < kA; ++k) {
        const int i = base + k * 32 + lane;
        if (i < DA) {
          harow[i] = h[k] ? 1 : 0;
          count += h[k] ? 1 : 0;
        }
      }
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) cnt[r] = count;
    __syncwarp();
    int* hbrow = hitb + r * DB;
    for (int j = lane; j < DB; j += 32) hbrow[j] = flags[j];
    // the next row restages sb and flags only after every lane has read them
    __syncwarp();
  }
}

template <typename T, int kA>
int launch_as(const T* a, const T* b, int* cnt, int* hita, int* hitb,
              long long E, int DA, int DB, int block_rows, int warps,
              size_t smem, cudaStream_t stream) {
  const long long blocks = (E + block_rows - 1) / block_rows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        intersect_kernel<T, kA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  intersect_kernel<T, kA><<<static_cast<unsigned>(blocks), warps * 32, smem,
                            stream>>>(a, b, cnt, hita, hitb, E, DA, DB,
                                      block_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b, int* cnt, int* hita, int* hitb,
           long long E, int DA, int DB, int block_rows, void* stream) {
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
    return launch_as<T, 1>(a, b, cnt, hita, hitb, E, DA, DB, block_rows,
                           warps, smem, s);
  }
  if (per_lane <= 2) {
    return launch_as<T, 2>(a, b, cnt, hita, hitb, E, DA, DB, block_rows,
                           warps, smem, s);
  }
  if (per_lane <= 4) {
    return launch_as<T, 4>(a, b, cnt, hita, hitb, E, DA, DB, block_rows,
                           warps, smem, s);
  }
  return launch_as<T, 8>(a, b, cnt, hita, hitb, E, DA, DB, block_rows, warps,
                         smem, s);
}

}  // namespace

extern "C" int intersect_i32_launch(const int32_t* a, const int32_t* b,
                                    int* cnt, int* hita, int* hitb,
                                    long long E, int DA, int DB,
                                    int block_rows, void* stream) {
  return launch<int32_t>(a, b, cnt, hita, hitb, E, DA, DB, block_rows,
                         stream);
}

extern "C" int intersect_i16_launch(const int16_t* a, const int16_t* b,
                                    int* cnt, int* hita, int* hitb,
                                    long long E, int DA, int DB,
                                    int block_rows, void* stream) {
  return launch<int16_t>(a, b, cnt, hita, hitb, E, DA, DB, block_rows,
                         stream);
}

extern "C" const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
