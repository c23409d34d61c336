// The first design of this kernel, kept unchanged beside its redesign so that
// chip_smoke.py (previous_ms) and chip_profile.py --pool-split time both in
// one run; built into a library of its own (ops/_build.py, PREVIOUS), never
// called by the port. Entry and kernels carry the suffix _v1; it goes with
// the next change to these kernels.
//
// Fused embedding lookup + masked mean pool, backward: the table's gradient
//   grad_table[ids[b,l]] += g[b] * w[b,l] / (sum_l w[b,l] + 1e-8),
//   w[b,l] = mask[b,l] * (ids[b,l] != 0),
// a dense (V, D) array, zero wherever no id points. Duplicates of an id,
// inside an example and across examples, add up; id 0 and masked slots add
// nothing; ids outside [0, V) are dropped.
//
// Replaces the backward of news_recsys_tpu/ops/fused_lookup_pool.py (_bwd,
// the custom VJP of the Pallas kernel _pool_pallas; an XLA scatter-add in
// JAX).
//
// What bounds it on the H100: memory. It must write V*D*4 bytes of zeros
// (4.2 MB for the item table at D 16) and reads B*D gradients and B*L ids
// and masks; the sums are B*L*D adds. Blocks run concurrently on Hopper, so
// a scatter-add needs either float atomics, whose order changes from run
// to run, or an order. The design takes the order:
//   - the caller sorts the B*L slots by id (a stable sort, so equal ids
//     keep their slot order) and passes the sorted ids and the permutation;
//   - one kernel writes each slot's coefficient w / denom, one warp a batch
//     row;
//   - one kernel gives each (sorted position, column) a thread; the thread
//     at the head of a run of equal ids walks the run, adds coef * g in
//     slot order (eight terms' loads in flight at a time) and writes the
//     table row once. No atomic, one writer per row, and two runs give the
//     same bits. A hot id's run is walked by D threads only: the cost of
//     the order.
// The table is cleared with a memset on the same stream before that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;   // terms of a run in flight per thread

// coef[b*L + l] = w[b,l] / (sum_l w[b,l] + 1e-8); one warp per batch row
__global__ void __launch_bounds__(kThreads)
pool_coef_kernel_v1(const int* __restrict__ ids, const float* __restrict__ mask,
                 float* __restrict__ coef, int B, int L) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= B) return;
  const int* idr = ids + row * L;
  const float* mr = mask + row * L;
  float wsum = 0.f;
  for (int l = lane; l < L; l += 32) wsum += idr[l] != 0 ? mr[l] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
  const float denom = wsum + 1e-8f;
  for (int l = lane; l < L; l += 32) coef[row * L + l] = (idr[l] != 0 ? mr[l] : 0.f) / denom;
}

// sorted_ids (S,) ascending, order (S,) the slot of each sorted position
__global__ void __launch_bounds__(kThreads)
pool_segment_sum_kernel_v1(const int* __restrict__ sorted_ids, const long long* __restrict__ order,
                        const float* __restrict__ coef, const float* __restrict__ g,
                        float* __restrict__ grad_table, long long S, int L, int D, int V) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= S * D) return;
  const long long s = i / D;
  const int d = (int)(i - s * D);
  const int id = __ldg(sorted_ids + s);
  if (id <= 0 || id >= V) return;                       // padding, or outside the table
  if (s > 0 && __ldg(sorted_ids + s - 1) == id) return;  // not the head of its run
  long long end = s + 1;
  while (end < S && __ldg(sorted_ids + end) == id) ++end;
  // kUnroll terms are loaded at once, so that their three dependent reads
  // overlap, and then added in slot order: a hot id's run costs its length
  // in adds, not in memory round trips
  float acc = 0.f;
  for (long long j = s; j < end; j += kUnroll) {
    float c[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j + u < end;
      const long long slot = in ? __ldg(order + j + u) : 0;
      c[u] = in ? __ldg(coef + slot) : 0.f;
      gv[u] = in ? __ldg(g + (slot / L) * D + d) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = fmaf(c[u], gv[u], acc);
  }
  grad_table[(long long)id * D + d] = acc;
}

}  // namespace

// ids (B, L) int32, mask (B, L) float32, g (B, D) float32, sorted_ids
// (B*L,) int32 = ids flattened and sorted ascending (stable), order (B*L,)
// int64 = the permutation that sorts them; grad_table (V, D) float32 out,
// coef (B*L,) float32 scratch. All contiguous, on the device. Returns the
// cudaError_t of the launches.
extern "C" int nrt_lookup_pool_bwd_v1(const int* ids, const float* mask, const float* g,
                                   const int* sorted_ids, const long long* order,
                                   float* grad_table, float* coef, int B, int L, int D, int V,
                                   cudaStream_t stream) {
  if (V <= 0 || D <= 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(grad_table, 0, (size_t)V * D * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const int rows_per_block = kThreads / 32;
  pool_coef_kernel_v1<<<(B + rows_per_block - 1) / rows_per_block, kThreads, 0, stream>>>(
      ids, mask, coef, B, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long S = (long long)B * L;
  const long long total = S * D;
  pool_segment_sum_kernel_v1<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      sorted_ids, order, coef, g, grad_table, S, L, D, V);
  return (int)cudaGetLastError();
}
