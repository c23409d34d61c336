// Sorted row scatter, in place: table[rows[s]] = vals[s] for every slot s
// whose row lies in [0, V); other slots are dropped.
//
// Replaces the Pallas kernel news_recsys_tpu/ops/scatter_rows.py::_scatter_pallas
// (body _kernel), which walked the sorted slots one grid step at a time and
// moved each touched 8-row slab through VMEM (read-modify-write of the
// aliased table), so untouched rows never left HBM.
//
// What bounds it on the H100: memory latency and the launch. At a DCN step
// (1,024 slots of 32 floats) it reads 128 KB of vals and writes as much, a
// few hundredths of a microsecond of bandwidth; the table itself is never
// read. What costs is the trip to memory, so the design makes it one trip a
// slot and one write a distinct row:
//   - one writer per distinct row: a slot writes only if it is the last of
//     its run, s == S-1 or rows[s+1] != rows[s]. The contract (rows
//     non-decreasing, duplicates carrying identical values, as the sparse
//     step's sorted dedup gives them) makes this change no bit; outside it
//     the last slot of a run wins, as the Pallas grid's order has it, and
//     the result no longer depends on which of several writers lands last.
//     The sparse attention step hands each of its two tables all 16,384
//     joint slots, the other table's clamped to row 0 or the spare row: a
//     run of ~15,872 slots there is one row write, not ~4,000 warps' writes
//     to one line;
//   - no dependent chain: a thread issues its loads of rows[s], rows[s+1]
//     and its vals chunk together, then decides and stores;
//   - one thread per 16-byte chunk of a slot's row (float4), so the D/4
//     threads of a slot write its row as one contiguous segment; one thread
//     per float where D % 4 != 0 or a base address is not 16-byte aligned;
//     rows outside [0, V) are dropped, as XLA's scatter drops them;
//   - 256 threads a block (S 1,024: 32 blocks; S 16,384: 512): at both no
//     slower than 128, and 0.15-0.6 us faster than 64
//     (chip_profile.py --scatter-split).
// No sort, no atomics, no scratch, no memset.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// A load of vals issued where it stands: the compiler sinks a plain load
// (and ptxas an ld.global.nc) below the branch that decides the store, so it
// would wait for the row ids, a second trip to memory; a volatile load is
// never made conditional.
__device__ __forceinline__ float4 load_now(const float4* p) {
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.volatile.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <typename T>  // float4: a 16-byte chunk a thread; float: one float
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(T* __restrict__ table, const int* __restrict__ rows,
                    const T* __restrict__ vals, long long total, int chunks, int shift, int S,
                    int V) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  // a shift where chunks is a power of two (D 16, 32), so the loads'
  // addresses do not wait on an integer division
  const long long slot = shift >= 0 ? i >> shift : i / chunks;
  const int c = (int)(i - slot * chunks);
  const bool has_next = slot + 1 < S;
  // every load first, none waiting on another
  const int row = __ldg(rows + slot);
  const int next = has_next ? __ldg(rows + slot + 1) : 0;
  const T val = load_now(vals + i);
  if ((unsigned)row >= (unsigned)V || (has_next && next == row)) return;
  table[(size_t)row * chunks + c] = val;
}

}  // namespace

// table (V, D) float32, rows (S,) int32, vals (S, D) float32; all
// contiguous, on the device. Writes the table in place. Returns the
// cudaError_t of the launch.
extern "C" int nrt_scatter_rows_set(float* table, const int* rows, const float* vals, int S,
                                    int D, int V, cudaStream_t stream) {
  if (S <= 0 || D <= 0) return (int)cudaSuccess;
  const bool vector = D % 4 == 0 && (uintptr_t)table % 16 == 0 && (uintptr_t)vals % 16 == 0;
  const int chunks = vector ? D / 4 : D;
  const int shift = (chunks & (chunks - 1)) == 0 ? __builtin_ctz(chunks) : -1;
  const long long total = (long long)S * chunks;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (vector)
    scatter_rows_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(table), rows, reinterpret_cast<const float4*>(vals), total,
        chunks, shift, S, V);
  else
    scatter_rows_kernel<<<blocks, kThreads, 0, stream>>>(table, rows, vals, total, chunks,
                                                         shift, S, V);
  return (int)cudaGetLastError();
}
