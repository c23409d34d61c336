// DCN-v1 cross stack, forward: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l for
// l = 0..NL-1, using the rank-1 identity (x0 x_l^T) w == x0 * (x_l . w).
//
// Replaces the Pallas kernel news_recsys_tpu/ops/dcn_kernel.py::_cross_pallas
// (body _kernel), which ran the whole stack over a 512-row batch tile with
// all layer weights resident in VMEM.
//
// What bounds it on the H100: memory, and at the sizes the ranker gives it
// (B 512 to 6,400 rows of 112 floats, 0.2-2.9 MB) the latency of one trip to
// it. Per row it reads D floats of x0 and writes D floats of out, and does
// ~4*NL*D flops: about NL/2 flop per byte, far below the ~20 flop/byte where
// fp32 CUDA cores become the limit. The design touches device memory once
// per element and makes that one trip the only one before the arithmetic:
//   - a row's loads are the first instructions of the kernel; the layer
//     weights (2*NL*D floats, 2.7 KB at D 112, NL 3) follow as cp.async
//     copies into shared memory, so both are in flight together, and the
//     one barrier waits for the weights after the row's loads are issued
//     (loading each layer's weights as the layer needs it made a trip to L2
//     a layer: 5.41 us at B 6,400 against the first design's 4.38);
//   - a group of G lanes owns a row (dcn_cross.cuh), 16-byte loads and stores
//     where D % 4 == 0 and the pointers are aligned (D 112: 28 float4 over 8
//     lanes, 4 rows a warp), so s_l = x_l . w_l is a shuffle sum of log2 G
//     levels (3 at D 112, not 5), and a lane has 4 float4s of work to
//     overlap;
//   - the wrapper gives every row its lanes at once, four warps a block
//     (ops/dcn_kernel.py::plan_cross): 32 blocks at B 512, 400 at B 6,400,
//     all resident in the first wave. Of the layouts timed at D 112 (1 to
//     8 warps a block, 8 to 32 lanes a row), this one was fastest or within
//     noise of it at both shapes; one float4 a lane over 32 lanes took 5-7
//     us at B 6,400 (NVIDIA H100 80GB HBM3).
// When a gradient is needed it also writes ss (NL, B), each layer's s_l, and
// nothing else: the backward (dcn_cross_bwd.cu) rebuilds each x_l from x0, ss
// and bs by the same recurrence, bit for bit, instead of reading NL*B*D
// floats of x_l back.

#include "dcn_cross.cuh"

namespace {

using namespace dcn;

template <int VW, int G, int S>
__global__ void __launch_bounds__(256)
dcn_cross_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ ws,
                     const float* __restrict__ bs, float* __restrict__ out,
                     float* __restrict__ ss, int B, int D, int NL) {
  extern __shared__ __align__(16) float sw[];       // ws (NL, D), then bs (NL, D)
  const int sub = threadIdx.x & (G - 1);
  const long long row = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
  const bool live = row < B;
  const int nchunk = D / VW;
  const int nw = NL * D;
  const long long base = (live ? row : 0) * D;

  float a0[S][VW], x[S][VW];
  load_row<VW, G, S>(a0, x0 + base, sub, nchunk, live);   // the kernel's first loads
  stage_weights<VW>(sw, ws, bs, nw);
  weights_ready();
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) x[k][j] = a0[k][j];
  }
  for (int l = 0; l < NL; ++l) {
    float w[S][VW], b[S][VW];
    load_row<VW, G, S>(w, sw + l * D, sub, nchunk, true);
    load_row<VW, G, S>(b, sw + nw + l * D, sub, nchunk, true);
    const float s = group_sum<G>(dot<VW, S>(x, w));
    if (ss != nullptr && live && sub == 0) ss[(long long)l * B + row] = s;
    cross_step<VW, S>(x, a0, s, b);
  }
  if (!live) return;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int c = sub + k * G;
    if (c < nchunk) store<VW>(out + base + c * VW, x[k]);
  }
}

template <int VW, int G, int S>
cudaError_t launch(const float* x0, const float* ws, const float* bs, float* out, float* ss,
                   int B, int D, int NL, int warps, int blocks, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)NL * D * sizeof(float);
  dcn_cross_fwd_kernel<VW, G, S><<<blocks, warps * 32, smem, stream>>>(x0, ws, bs, out, ss, B, D,
                                                                       NL);
  return cudaGetLastError();
}

}  // namespace

// x0 (B, D), ws (NL, D), bs (NL, D), out (B, D); ss (NL, B) may be null. All
// float32, contiguous, on the device. The launch is the wrapper's plan
// (ops/dcn_kernel.py::plan_cross): vector (1: float4 chunks, which needs D % 4
// == 0 and x0, ws, bs, out 16-byte aligned), group (lanes a row) and slots
// (chunks a lane), one of NRT_CROSS_FWD_LAYOUTS with group * slots chunks
// covering a row, warps a block (1-8) and blocks (blocks * warps * 32 /
// group >= B). The weights, 2*NL*D
// floats, must fit 48 KB of shared memory. Returns the cudaError_t of the
// launch.
extern "C" int nrt_dcn_cross_fwd(const float* x0, const float* ws, const float* bs, float* out,
                                 float* ss, int B, int D, int NL, int vector, int group,
                                 int slots, int warps, int blocks, cudaStream_t stream) {
  if (B == 0) return (int)cudaSuccess;
  const int vw = vector ? 4 : 1;
  if (D <= 0 || NL < 0 || warps < 1 || warps > 8 || blocks < 1 || (vector && D % 4 != 0) ||
      (long long)group * slots < D / vw || (long long)blocks * warps * 32 / group < B ||
      2LL * NL * D * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
#define NRT_CROSS_FWD_CASE(VW_, G_, S_)                                                     \
  if (vw == VW_ && group == G_ && slots == S_)                                              \
    return (int)launch<VW_, G_, S_>(x0, ws, bs, out, ss, B, D, NL, warps, blocks, stream);
  NRT_CROSS_FWD_LAYOUTS(NRT_CROSS_FWD_CASE)
#undef NRT_CROSS_FWD_CASE
  return (int)cudaErrorInvalidValue;
}
