// Device routines shared by the cross stack's forward (dcn_cross.cu) and
// backward (dcn_cross_bwd.cu).
//
// Layout of a row. A row of D floats is cut into chunks of VW floats: VW = 4
// (one 16-byte load or store) when D % 4 == 0 and the row pointers are
// 16-byte aligned, else VW = 1. A group of G lanes (a power of two, at most
// 32) owns a row: lane `sub` of the group holds S chunks, sub, sub + G, ...,
// so a dot product is the lane's own sum and a shuffle sum over the group
// alone (log2 G levels), and 32 / G rows share a warp. The wrapper picks G
// and S (ops/dcn_kernel.py::plan_cross) so that G * S chunks cover the row.
// Lanes of chunks past the row hold zeros and store nothing; rows past the
// batch likewise, but they take part in every shuffle, so all 32 lanes of a
// warp always do.
//
// The recurrence x_{l+1} = x0 * s_l + b_l + x_l is written with explicit
// round-to-nearest intrinsics (fma, then add), so that nvcc cannot contract
// it differently in the two kernels: the backward rebuilds the forward's x_l
// from x0, ss and bs bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace dcn {

constexpr unsigned kFull = 0xffffffffu;

// VW floats at p (16-byte aligned when VW == 4)
template <int VW>
__device__ __forceinline__ void load(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&r)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}

// the lane's chunks of the row at p (device or shared memory): zeros where the
// chunk is past the row (c >= nchunk) or the row is past the batch
template <int VW, int G, int S>
__device__ __forceinline__ void load_row(float (&r)[S][VW], const float* p, int sub, int nchunk,
                                         bool live) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int c = sub + k * G;
    if (live && c < nchunk) {
      load<VW>(r[k], p + c * VW);
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) r[k][j] = 0.f;
    }
  }
}

// Both kernels stage the layer weights, ws (NL, D) then bs (NL, D), in shared
// memory with cp.async, issued after the row's own loads and waited for
// after them, so the two trips to memory overlap and no barrier stands
// before the first row load.
__device__ __forceinline__ void cp_async(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

template <int VW>
__device__ __forceinline__ void stage_weights(float* sw, const float* ws, const float* bs,
                                              int nw) {
  for (int i = threadIdx.x * VW; i < 2 * nw; i += blockDim.x * VW)
    cp_async(sw + i, i < nw ? ws + i : bs + (i - nw), VW * 4);
}

// every cp.async of this thread landed, and (after the barrier) every thread's
__device__ __forceinline__ void weights_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// the lane's part of a . b, in chunk order
template <int VW, int S>
__device__ __forceinline__ float dot(const float (&a)[S][VW], const float (&b)[S][VW]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) s = __fmaf_rn(a[k][j], b[k][j], s);
  }
  return s;
}

// the sum over the G lanes of a group (xor butterfly: every lane gets it)
template <int G>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// x <- x0 * s + b + x, the one rounding order of both kernels
template <int VW, int S>
__device__ __forceinline__ void cross_step(float (&x)[S][VW], const float (&a0)[S][VW], float s,
                                           const float (&b)[S][VW]) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) x[k][j] = __fadd_rn(__fmaf_rn(a0[k][j], s, b[k][j]), x[k][j]);
  }
}

}  // namespace dcn

// The layouts each kernel is built for, X(VW, G, S): every one that
// ops/dcn_kernel.py::plan_cross picks for 1 <= D <= 256 and 1 <= NL <= 32.
// The forward takes the fewest lanes that hold a row at up to 4 float4s (8
// floats) a lane: rows in flight share warps and a lane has work to overlap.
// The backward takes one chunk a lane, up to 32 lanes: a lane's chain of
// dependent steps a row is what it waits on there.
#define NRT_CROSS_FWD_LAYOUTS(X)                                                             \
  X(4, 1, 1) X(4, 1, 2) X(4, 1, 4) X(4, 2, 4) X(4, 4, 4) X(4, 8, 4) X(4, 16, 4)             \
  X(1, 1, 1) X(1, 1, 2) X(1, 1, 4) X(1, 1, 8) X(1, 2, 8) X(1, 4, 8) X(1, 8, 8) X(1, 16, 8)  \
  X(1, 32, 8)
#define NRT_CROSS_BWD_LAYOUTS(X)                                                             \
  X(4, 1, 1) X(4, 2, 1) X(4, 4, 1) X(4, 8, 1) X(4, 16, 1) X(4, 32, 1) X(4, 32, 2)           \
  X(1, 1, 1) X(1, 2, 1) X(1, 4, 1) X(1, 8, 1) X(1, 16, 1) X(1, 32, 1) X(1, 32, 2)           \
  X(1, 32, 4) X(1, 32, 8)
