// The first design of this kernel, kept unchanged beside its redesign so that
// chip_smoke.py (previous_ms) and chip_profile.py time both in one run; built
// into a library of its own (ops/_build.py, PREVIOUS), never called by the
// port. Entry and kernels carry the suffix _v1; it goes with the next change
// to these kernels.
//
// Sorted row scatter, in place: table[rows[s]] = vals[s] for every slot s
// whose row lies in [0, V); other slots are dropped.
//
// Replaces the Pallas kernel news_recsys_tpu/ops/scatter_rows.py::_scatter_pallas
// (body _kernel), which walked the sorted slots one grid step at a time and
// moved each touched 8-row slab through VMEM (read-modify-write of the
// aliased table), so untouched rows never left HBM.
//
// What bounds it on the H100: memory latency. At the training slice's shape
// (1,024 slots of 32 floats) it writes 128 KB and reads as much of vals, a
// few microseconds of bandwidth; the table itself is never read. The slab
// read-modify-write does not carry over: Hopper writes a row directly, so
// each slot costs one coalesced row write and nothing else:
//   - one thread per 16-byte chunk of a slot's row (float4), so the D/4
//     threads of a slot write its row as one contiguous segment and a warp
//     covers 32*4/D slots at D = 32; where D % 4 != 0 or a base address is
//     not 16-byte aligned, one thread per float instead;
//   - a thread reads its slot's row id itself (the group of a slot reads the
//     same word, one transaction) and leaves when it is outside [0, V), as
//     XLA's scatter drops out-of-range indices.
// Duplicate slots are allowed by the contract only with identical values
// (the sorted dedup layout gives every duplicate of a row the same summed
// gradient), so two threads writing one address write the same bytes and
// their order does not matter: the race is benign. Sortedness is not needed
// here at all; the Pallas kernel needed it for its slab walk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
scatter_rows_vec4_v1_kernel(float4* __restrict__ table, const int* __restrict__ rows,
                         const float4* __restrict__ vals, long long total, int D4, int V) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long slot = i / D4;
  const int c = (int)(i - slot * D4);
  const int row = __ldg(rows + slot);
  if ((unsigned)row >= (unsigned)V) return;  // negative or >= V: dropped
  table[(long long)row * D4 + c] = __ldg(vals + i);
}

__global__ void __launch_bounds__(kThreads)
scatter_rows_scalar_v1_kernel(float* __restrict__ table, const int* __restrict__ rows,
                           const float* __restrict__ vals, long long total, int D, int V) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long slot = i / D;
  const int d = (int)(i - slot * D);
  const int row = __ldg(rows + slot);
  if ((unsigned)row >= (unsigned)V) return;
  table[(long long)row * D + d] = __ldg(vals + i);
}

}  // namespace

// table (V, D) float32, rows (S,) int32, vals (S, D) float32; all
// contiguous, on the device. Writes the table in place. Returns the
// cudaError_t of the launch.
extern "C" int nrt_scatter_rows_set_v1(float* table, const int* rows, const float* vals,
                                    int S, int D, int V, cudaStream_t stream) {
  if (S <= 0 || D <= 0) return (int)cudaSuccess;
  const bool vec4 = D % 4 == 0 && ((uintptr_t)table % 16 == 0) && ((uintptr_t)vals % 16 == 0);
  const long long total = (long long)S * (vec4 ? D / 4 : D);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  if (vec4)
    scatter_rows_vec4_v1_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<float4*>(table), rows, reinterpret_cast<const float4*>(vals),
        total, D / 4, V);
  else
    scatter_rows_scalar_v1_kernel<<<blocks, kThreads, 0, stream>>>(table, rows, vals, total, D, V);
  return (int)cudaGetLastError();
}
