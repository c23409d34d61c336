// Fused embedding lookup + masked mean pool, forward:
//   out[b] = sum_l w[b,l] * table[ids[b,l]] / (sum_l w[b,l] + 1e-8),
//   w[b,l] = mask[b,l] * (ids[b,l] != 0).
//
// Replaces the Pallas kernel
// news_recsys_tpu/ops/fused_lookup_pool.py::_pool_pallas (body _kernel),
// which issued the DMAs of all L gathered rows of a batch row into VMEM
// before waiting on any, and reduced them with one (1,L)x(L,D) matmul, so
// the (B, L, D) gather never reached HBM.
//
// What bounds it on the H100: the gathered bytes, B*L*D*4, read from rows
// scattered over the table, and at the main path's sizes (B 64-1,024, L 5-30,
// D 16) the latency of two dependent reads, the ids and then the rows; the
// arithmetic is 2 flops per loaded float. The design keeps the gather out of
// device memory, as the Pallas kernel did, and has every row read of an
// example in flight at once:
//   - one warp per batch row, two a block (B 1,024: 512 blocks);
//   - a row's D floats are read by TC lanes as 16-byte loads when D % 4 == 0
//     and the table is 16-byte aligned (else as floats), G = 32 / TC slots
//     per warp instruction; a chunk of up to 32 slots is read in three
//     rounds, each issued whole before the next waits: every id and mask
//     (G consecutive slots an instruction, coalesced), then every row, then
//     the adds: at D 16, L 30 that is four independent row loads a lane, not
//     fifteen dependent round trips;
//   - the adds run in slot order, the groups' sums (and sum_l w) meet in a
//     fixed shuffle reduction, and only the (B, D) result is written.
// Rows of at most 8 slots keep the first design's loop (below): it is as fast there.
// Ids outside [0, V) read as NaN, so the pooled row is NaN whatever its
// mask, as with the XLA gather (jnp.take fills) in the JAX package.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;  // batch rows a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 nan_of(float4) { return make_float4(NAN, NAN, NAN, NAN); }
__device__ __forceinline__ float nan_of(float) { return NAN; }
__device__ __forceinline__ void zero(float4& v) { v = make_float4(0.f, 0.f, 0.f, 0.f); }
__device__ __forceinline__ void zero(float& v) { v = 0.f; }
__device__ __forceinline__ void fma_to(float4& acc, float4 v, float w) {
  acc.x += v.x * w; acc.y += v.y * w; acc.z += v.z * w; acc.w += v.w * w;
}
__device__ __forceinline__ void fma_to(float& acc, float v, float w) { acc += v * w; }
__device__ __forceinline__ void add_shfl(float4& acc, int o) {
  acc.x += __shfl_xor_sync(kFull, acc.x, o); acc.y += __shfl_xor_sync(kFull, acc.y, o);
  acc.z += __shfl_xor_sync(kFull, acc.z, o); acc.w += __shfl_xor_sync(kFull, acc.w, o);
}
__device__ __forceinline__ void add_shfl(float& acc, int o) {
  acc += __shfl_xor_sync(kFull, acc, o);
}
__device__ __forceinline__ float4 divide(float4 v, float d) {
  return make_float4(v.x / d, v.y / d, v.z / d, v.w / d);
}
__device__ __forceinline__ float divide(float v, float d) { return v / d; }

// T: float4 or float; C: columns of T in a table row. TC lanes read a row
// (a power of two; TC >= C when C <= 32), G = 32 / TC slots an instruction,
// VPL columns a lane, IT instructions of loads in flight before the adds.
template <typename T, int TC, int VPL, int IT>
__global__ void __launch_bounds__(kWarps * 32)
lookup_pool_fwd_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                       const float* __restrict__ mask, T* __restrict__ out, int B, int L, int C,
                       int V) {
  constexpr int G = 32 / TC;
  const int lane = threadIdx.x & 31;
  const int grp = lane / TC, t = lane % TC;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const int* idr = ids + row * L;
  const float* mr = mask + row * L;
  T acc[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) zero(acc[j]);
  float wsum = 0.f;                 // of this lane's slots; the groups' sums meet below
  for (int base = 0; base < L; base += G * IT) {
    int id[IT];
    float w[IT];
    T v[IT][VPL];
#pragma unroll
    for (int it = 0; it < IT; ++it) {                    // every id and mask of the chunk
      const int slot = base + it * G + grp;
      const bool live = slot < L;
      id[it] = live ? idr[slot] : 0;
      const float m = live ? mr[slot] : 0.f;
      w[it] = id[it] != 0 ? m : 0.f;
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {                    // then every row
      const bool live = base + it * G + grp < L;
      const bool ok = id[it] >= 0 && id[it] < V;
      const T* src = table + (long long)(ok ? id[it] : 0) * C;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int col = t + TC * j;
        if (live && col < C) v[it][j] = ok ? __ldg(src + col) : nan_of(v[it][j]);
        else zero(v[it][j]);
      }
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {                    // then the adds, in slot order
      wsum += w[it];
#pragma unroll
      for (int j = 0; j < VPL; ++j) fma_to(acc[j], v[it][j], w[it]);
    }
  }
#pragma unroll
  for (int o = TC; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) add_shfl(acc[j], o);
    wsum += __shfl_xor_sync(kFull, wsum, o);
  }
  if (grp != 0) return;
  const float denom = wsum + 1e-8f;
  T* outr = out + row * C;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = t + TC * j;
    if (col < C) outr[col] = divide(acc[j], denom);
  }
}

// Rows of at most kShortL slots (``entities``, L 5): the first design's kernel.
// Both designs take two dependent reads there, and this one was as fast or
// up to ~0.15 us faster in the runs that timed both (PERF.md): a warp per
// batch row, TD lanes a table row (the power of two >= D, at most 32), 32 / TD
// ids at a time, 4-byte loads, one shuffle round.
constexpr int kShortL = 8;
constexpr int kShortWarps = 8;

template <int TD, int VPL>
__global__ void __launch_bounds__(kShortWarps * 32)
lookup_pool_fwd_short_kernel(const float* __restrict__ table, const int* __restrict__ ids,
                             const float* __restrict__ mask, float* __restrict__ out, int B,
                             int L, int D, int V) {
  constexpr int G = 32 / TD;  // ids read at once by one warp
  const int lane = threadIdx.x & 31;
  const int g = lane / TD;
  const int t = lane % TD;
  const long long row = (long long)blockIdx.x * kShortWarps + (threadIdx.x >> 5);
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
    for (int j = 0; j < VPL; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    wsum += __shfl_xor_sync(kFull, wsum, o);
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
void launch_short(const float* table, const int* ids, const float* mask, float* out, int B,
                  int L, int D, int V, cudaStream_t stream) {
  const dim3 grid((B + kShortWarps - 1) / kShortWarps);
  lookup_pool_fwd_short_kernel<TD, VPL><<<grid, kShortWarps * 32, 0, stream>>>(
      table, ids, mask, out, B, L, D, V);
}

int dispatch_short(const float* table, const int* ids, const float* mask, float* out, int B,
                   int L, int D, int V, cudaStream_t stream) {
  if (D <= 1) launch_short<1, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 2) launch_short<2, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 4) launch_short<4, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 8) launch_short<8, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 16) launch_short<16, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 32) launch_short<32, 1>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 64) launch_short<32, 2>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 128) launch_short<32, 4>(table, ids, mask, out, B, L, D, V, stream);
  else if (D <= 256) launch_short<32, 8>(table, ids, mask, out, B, L, D, V, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, int TC, int VPL>
void launch(const float* table, const int* ids, const float* mask, float* out, int B, int L,
            int C, int V, cudaStream_t stream) {
  // loads in flight a lane: at most 64 floats of registers, at most a chunk of 32 slots
  constexpr int W = sizeof(T) / sizeof(float);
  constexpr int IT = TC < 64 / (VPL * W) ? TC : 64 / (VPL * W);
  const dim3 grid((B + kWarps - 1) / kWarps);
  lookup_pool_fwd_kernel<T, TC, VPL, IT><<<grid, kWarps * 32, 0, stream>>>(
      reinterpret_cast<const T*>(table), ids, mask, reinterpret_cast<T*>(out), B, L, C, V);
}

// C columns of T: the lanes a row takes and the columns a lane holds
template <typename T>
int dispatch(const float* table, const int* ids, const float* mask, float* out, int B, int L,
             int C, int V, cudaStream_t stream) {
  if (C <= 1) launch<T, 1, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 2) launch<T, 2, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 4) launch<T, 4, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 8) launch<T, 8, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 16) launch<T, 16, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 32) launch<T, 32, 1>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 64) launch<T, 32, 2>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 128) launch<T, 32, 4>(table, ids, mask, out, B, L, C, V, stream);
  else if (C <= 256) launch<T, 32, 8>(table, ids, mask, out, B, L, C, V, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// table (V, D) float32, ids (B, L) int32, mask (B, L) float32, out (B, D)
// float32; all contiguous, on the device; 1 <= D <= 256. Returns the
// cudaError_t of the launch.
extern "C" int nrt_lookup_pool_fwd(const float* table, const int* ids, const float* mask,
                                   float* out, int B, int L, int D, int V,
                                   cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  if (L <= kShortL) return dispatch_short(table, ids, mask, out, B, L, D, V, stream);
  const bool vec = D % 4 == 0 && ((uintptr_t)table & 15) == 0 && ((uintptr_t)out & 15) == 0;
  return vec ? dispatch<float4>(table, ids, mask, out, B, L, D / 4, V, stream)
             : dispatch<float>(table, ids, mask, out, B, L, D, V, stream);
}
