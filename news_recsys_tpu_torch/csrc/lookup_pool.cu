// Fused embedding lookup + masked mean pool, forward:
//   out[b] = sum_l w[b,l] * table[ids[b,l]] / (sum_l w[b,l] + 1e-8),
//   w[b,l] = mask[b,l] * (ids[b,l] != 0).
//
// Replaces the Pallas kernel
// news_recsys_tpu/ops/fused_lookup_pool.py::_pool_pallas (body _kernel),
// which DMA'd the L gathered rows of each batch row into VMEM and reduced
// them with one (1,L)x(L,D) matmul, so the (B, L, D) gather never reached
// HBM.
//
// What bounds it on the H100: the gathered bytes, B*L*D*4, read from rows
// scattered over the table; the arithmetic is 2 flops per loaded float.
// The design keeps the gather out of device memory in the same way and
// keeps as many row reads in flight as a warp can issue:
//   - one warp per batch row; a warp splits into 32/TD groups of TD lanes
//     (TD = the power of two >= D, at most 32), so for D = 16 two ids are
//     read at once, each as one 64-byte coalesced segment;
//   - each lane accumulates w * row in registers (VPL = ceil(D/TD) values)
//     and the group partial sums meet in a warp-shuffle reduction;
//   - only the (B, D) result is written.
// Ids outside [0, V) read as NaN, so the pooled row is NaN whatever its
// mask, as with the XLA gather (jnp.take fills) in the JAX package.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // batch rows per block

template <int TD, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
lookup_pool_fwd_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                       const float* __restrict__ mask, float* __restrict__ out,
                       int B, int L, int D, int V) {
  constexpr int G = 32 / TD;  // ids read at once by one warp
  const int lane = threadIdx.x & 31;
  const int g = lane / TD;
  const int t = lane % TD;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;

  const int* idr = ids + row * L;
  const float* mr = mask + row * L;
  float acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) acc[j] = 0.f;
  float wsum = 0.f;
  for (int l = g; l < L; l += G) {
    const int id = idr[l];
    const float w = id != 0 ? mr[l] : 0.f;
    const bool ok = id >= 0 && id < V;
    const float* src = table + (long long)(ok ? id : 0) * D;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = t + TD * j;
      if (d < D) acc[j] += (ok ? __ldg(src + d) : NAN) * w;
    }
    wsum += w;
  }
#pragma unroll
  for (int o = TD; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
    wsum += __shfl_xor_sync(0xffffffffu, wsum, o);
  }
  if (g != 0) return;
  const float denom = wsum + 1e-8f;
  float* outr = out + row * D;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = t + TD * j;
    if (d < D) outr[d] = acc[j] / denom;
  }
}

template <int TD, int VPL>
void launch(const float* table, const int* ids, const float* mask, float* out,
            int B, int L, int D, int V, cudaStream_t stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  lookup_pool_fwd_kernel<TD, VPL><<<grid, kWarps * 32, 0, stream>>>(
      table, ids, mask, out, B, L, D, V);
}

}  // namespace

// table (V, D) float32, ids (B, L) int32, mask (B, L) float32, out (B, D)
// float32; all contiguous, on the device; 1 <= D <= 256. Returns the
// cudaError_t of the launch.
extern "C" int nrt_lookup_pool_fwd(const float* table, const int* ids, const float* mask,
                                   float* out, int B, int L, int D, int V,
                                   cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (D <= 1) launch<1, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 2) launch<2, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 4) launch<4, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 8) launch<8, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 16) launch<16, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 32) launch<32, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 64) launch<32, 2>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 128) launch<32, 4>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 256) launch<32, 8>(table, ids, mask, out, B, L, D, V, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
