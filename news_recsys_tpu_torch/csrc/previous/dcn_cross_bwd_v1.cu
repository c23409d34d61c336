// The first design of this kernel, kept unchanged beside its redesign so that
// chip_smoke.py (previous_ms) and chip_profile.py --cross-split time both in
// one run; built into a library of its own (ops/_build.py, PREVIOUS), never
// called by the port. Entry and kernels carry the suffix _v1; it goes with
// the next change to these kernels.
//
// DCN-v1 cross stack, backward. With g the gradient of the stack's output,
// for l = NL-1 .. 0:
//   ds_l = sum_d g . x0          (per row)
//   dw_l += xs_l * ds_l ;  db_l += g      (summed over the batch)
//   dx0_extra += g * s_l
//   g += w_l * ds_l              (the gradient of x_l)
// and finally dx0 = g + dx0_extra. xs (NL, B, D) and ss (NL, B) are the
// per-layer inputs and scalars that the forward kernel (dcn_cross_v1.cu)
// wrote.
//
// Replaces the backward of news_recsys_tpu/ops/dcn_kernel.py (_bwd, the
// custom VJP of the Pallas kernel _cross_pallas; XLA code in JAX).
//
// What bounds it on the H100: memory. Per row it reads x0, g and NL rows of
// xs and writes dx0, (NL + 3) * D floats, at about 8 flops per float read.
// The design reads each of them once and keeps the chain in registers, as
// the forward does:
//   - one warp per batch row; g, x0 and dx0_extra stay in registers
//     (VPL = ceil(D/32) values per lane, the ragged tail masked), ds_l is a
//     warp-shuffle sum, w_l of all layers sits in shared memory;
//   - dw and db are sums over the batch, which no block holds whole on
//     Hopper. Each warp accumulates its rows into its own slice of shared
//     memory (a lane owns its columns, so there is no atomic and no
//     conflict), the block sums its warps' slices in warp order into one
//     partial per block, and a second small kernel sums the partials in
//     block order. Rows go to warps by a fixed rule, so the sums are taken
//     in the same order on every run: two runs give the same bits, which
//     float atomics would not.
// It reads xs/ss instead of recomputing them: the forward already wrote
// them, and recomputing costs the same x0 read plus NL more reductions.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows in flight per block

template <int VPL>
__global__ void __launch_bounds__(kWarps * 32)
dcn_cross_bwd_v1_kernel(const float* __restrict__ x0, const float* __restrict__ ws,
                     const float* __restrict__ xs, const float* __restrict__ ss,
                     const float* __restrict__ g, float* __restrict__ dx0,
                     float* __restrict__ partial, int B, int D, int NL) {
  extern __shared__ float smem[];  // ws (NL*D), then per warp dw (NL*D) and db (NL*D)
  const int nw = NL * D;
  float* acc = smem + nw;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) smem[i] = ws[i];
  for (int i = threadIdx.x; i < kWarps * 2 * nw; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* wacc = acc + warp * 2 * nw;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < B;
       row += (long long)gridDim.x * kWarps) {
    const float* x0r = x0 + row * D;
    const float* gr = g + row * D;
    float a0[VPL], gg[VPL], ex[VPL];
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      a0[j] = d < D ? x0r[d] : 0.f;
      gg[j] = d < D ? gr[d] : 0.f;
      ex[j] = 0.f;
    }
    for (int l = NL - 1; l >= 0; --l) {
      float ds = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) ds += gg[j] * a0[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, o);
      const float s = ss[(long long)l * B + row];
      const float* xr = xs + ((long long)l * B + row) * D;
      const float* w = smem + l * D;
      float* dw = wacc + l * D;
      float* db = wacc + nw + l * D;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int d = lane + 32 * j;
        if (d < D) {
          dw[d] += xr[d] * ds;
          db[d] += gg[j];
          ex[j] += gg[j] * s;
          gg[j] += w[d] * ds;
        }
      }
    }
    float* outr = dx0 + row * D;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int d = lane + 32 * j;
      if (d < D) outr[d] = gg[j] + ex[j];
    }
  }
  __syncthreads();
  float* out = partial + (long long)blockIdx.x * 2 * nw;
  for (int i = threadIdx.x; i < 2 * nw; i += blockDim.x) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += acc[w * 2 * nw + i];
    out[i] = sum;
  }
}

// dws/dbs (NL*D each) = the sum over nblk block partials, in block order
__global__ void dcn_cross_bwd_reduce_v1_kernel(const float* __restrict__ partial,
                                            float* __restrict__ dws, float* __restrict__ dbs,
                                            int nblk, int nw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * nw) return;
  float sum = 0.f;
  for (int b = 0; b < nblk; ++b) sum += partial[(long long)b * 2 * nw + i];
  if (i < nw) dws[i] = sum;
  else dbs[i - nw] = sum;
}

template <int VPL>
cudaError_t launch(const float* x0, const float* ws, const float* xs, const float* ss,
                   const float* g, float* dx0, float* partial, int B, int D, int NL,
                   int nblk, cudaStream_t stream) {
  const size_t smem = (size_t)(1 + 2 * kWarps) * NL * D * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dcn_cross_bwd_v1_kernel<VPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dcn_cross_bwd_v1_kernel<VPL><<<nblk, kWarps * 32, smem, stream>>>(
      x0, ws, xs, ss, g, dx0, partial, B, D, NL);
  return cudaSuccess;
}

}  // namespace

// x0 (B, D), ws (NL, D), xs (NL, B, D), ss (NL, B), g (B, D) in; dx0 (B, D),
// dws (NL, D), dbs (NL, D) out; partial (nblk, 2, NL, D) scratch. All
// float32, contiguous, on the device. 1 <= D <= 256, NL >= 1, and
// (1 + 2*8)*NL*D*4 bytes of shared memory must fit a block (227 KB). Any
// nblk >= 1 is right (rows are spread over the blocks); the caller sizes
// partial for it. Returns the cudaError_t of the launches.
extern "C" int nrt_dcn_cross_bwd_v1(const float* x0, const float* ws, const float* xs,
                                 const float* ss, const float* g, float* dx0, float* dws,
                                 float* dbs, float* partial, int B, int D, int NL, int nblk,
                                 cudaStream_t stream) {
  if (NL <= 0 || D <= 0 || nblk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  switch ((D + 31) / 32) {
    case 1: err = launch<1>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 2: err = launch<2>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 3: err = launch<3>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 4: err = launch<4>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 5: err = launch<5>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 6: err = launch<6>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 7: err = launch<7>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    case 8: err = launch<8>(x0, ws, xs, ss, g, dx0, partial, B, D, NL, nblk, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nw = NL * D;
  dcn_cross_bwd_reduce_v1_kernel<<<(2 * nw + 255) / 256, 256, 0, stream>>>(partial, dws, dbs,
                                                                        nblk, nw);
  return (int)cudaGetLastError();
}
