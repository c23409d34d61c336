// DCN-v1 cross stack, forward: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l for
// l = 0..NL-1, using the rank-1 identity (x0 x_l^T) w == x0 * (x_l . w).
//
// Replaces the Pallas kernel news_recsys_tpu/ops/dcn_kernel.py::_cross_pallas
// (body _kernel), which ran the whole stack over a 512-row batch tile with
// all layer weights resident in VMEM.
//
// What bounds it on the H100: memory. Per row it reads D floats of x0 and
// writes D floats of out, and does ~4*NL*D flops: about NL/2 flop per byte,
// far below the ~20 flop/byte where fp32 CUDA cores become the limit. The
// design therefore touches device memory exactly once per element:
//   - one warp per batch row; x0 and the running x stay in registers
//     (VPL = ceil(D/32) values per lane, the ragged tail masked);
//   - w_l and b_l of all NL layers are staged once per block in shared
//     memory;
//   - s_l = x_l . w_l is a warp-shuffle reduction, so no layer's x goes
//     back to device memory;
//   - loads and stores are coalesced: lane i touches elements i, i+32, ...
// xs (NL, B, D) and ss (NL, B), the per-layer inputs and scalars that the
// backward pass needs, are written only when their pointers are non-null.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
dcn_cross_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ ws,
                     const float* __restrict__ bs, float* __restrict__ out,
                     float* __restrict__ xs, float* __restrict__ ss,
                     int B, int D, int NL) {
  extern __shared__ float smem[];  // ws (NL*D) then bs (NL*D)
  const int nw = NL * D;
  for (int i = threadIdx.x; i < 2 * nw; i += blockDim.x)
    smem[i] = i < nw ? ws[i] : bs[i - nw];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves together; no barrier follows

  const float* x0r = x0 + row * D;
  float a0[VPL], x[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = lane + 32 * j;
    a0[j] = d < D ? x0r[d] : 0.f;
    x[j] = a0[j];
  }
  for (int l = 0; l < NL; ++l) {
    const float* w = smem + l * D;
    const float* b = smem + nw + l * D;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) {
        s += x[j] * w[d];
        if (xs) xs[((long long)l * B + row) * D + d] = x[j];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (ss && lane == 0) ss[(long long)l * B + row] = s;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) x[j] = a0[j] * s + b[d] + x[j];
    }
  }
  float* outr = out + row * D;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int d = lane + 32 * j;
    if (d < D) outr[d] = x[j];
  }
}

template <int VPL>
void launch(const float* x0, const float* ws, const float* bs, float* out,
            float* xs, float* ss, int B, int D, int NL, cudaStream_t stream) {
  const dim3 grid((B + kWarps - 1) / kWarps);
  const size_t smem = 2 * (size_t)NL * D * sizeof(float);
  dcn_cross_fwd_kernel<VPL><<<grid, kWarps * 32, smem, stream>>>(
      x0, ws, bs, out, xs, ss, B, D, NL);
}

}  // namespace

// x0 (B, D), ws (NL, D), bs (NL, D), out (B, D); xs (NL, B, D) and ss (NL, B)
// may be null. All float32, contiguous, on the device. 1 <= D <= 256 and
// 2*NL*D*4 bytes must fit the default 48 KB of shared memory. Returns the
// cudaError_t of the launch.
extern "C" int nrt_dcn_cross_fwd(const float* x0, const float* ws, const float* bs,
                                 float* out, float* xs, float* ss,
                                 int B, int D, int NL, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  switch ((D + 31) / 32) {
    case 1: launch<1>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 2: launch<2>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 3: launch<3>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 4: launch<4>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 5: launch<5>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 6: launch<6>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 7: launch<7>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    case 8: launch<8>(x0, ws, bs, out, xs, ss, B, D, NL, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
