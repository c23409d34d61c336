// The first design of this kernel, kept unchanged beside its redesign so that
// chip_smoke.py (previous_ms) and chip_profile.py time both in one run; built
// into a library of its own (ops/_build.py, PREVIOUS), never called by the
// port. Entry and kernels carry the suffix _v1; it goes with the next change
// to these kernels.
//
// FM second-order interaction, the forward (its backward, unchanged, stays in
// csrc/fm_second_order.cu; the note below is the first design's, of both):
//   out[b]       = 0.5 * sum_d [ (sum_f v[b,f,d])^2 - sum_f v[b,f,d]^2 ]
//   dv[b, f, d]  = (sum_f' v[b,f',d] - v[b,f,d]) * g[b]
//
// Replaces the Pallas kernel news_recsys_tpu/ops/fm_kernel.py::_fm_pallas
// (body _kernel), which reduced a (256, F, D) batch tile in VMEM, and its
// XLA VJP _bwd in the same file. Unlike the Pallas path, which falls back to
// XLA when B is not a multiple of its tile, these kernels take any B.
//
// What bounds them on the H100: memory. Per row the forward reads F*D floats
// and writes one, the backward reads F*D + 1 and writes F*D; either does ~3
// flops per element read, far below the ~20 flop/byte where fp32 CUDA cores
// become the limit. At the DeepFM shapes (F 5, D 15) the forward reads
// 1.9 MB at B 6,400 and 154 KB at B 512. The design touches each element of
// v once and keeps every sum in registers:
//   - one warp per batch row, a lane per column d, looping over d in steps
//     of 32 when D > 32;
//   - each lane sums s_d = sum_f v and q_d = sum_f v^2 down its column, so
//     the F-reduction needs no communication;
//   - the forward ends with one warp-shuffle sum of s_d^2 - q_d; the
//     backward recomputes s_d the same way and writes (s_d - v_fd) * g_b.
// Every reduction stays inside one row, in a fixed order: no atomics, and
// two runs give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(kWarps * 32)
fm_fwd_v1_kernel(const float* __restrict__ v, float* __restrict__ out, int B, int F, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // whole warp leaves together; no barrier follows
  const float* vr = v + row * F * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) {
    float s = 0.f, q = 0.f;
    for (int f = 0; f < F; ++f) {
      const float x = __ldg(vr + f * D + d);
      s += x;
      q += x * x;
    }
    acc += s * s - q;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = 0.5f * acc;
}

unsigned grid_for(int B) { return (unsigned)((B + kWarps - 1) / kWarps); }

}  // namespace

// v (B, F, D) float32, out (B,) float32; contiguous, on the device.
// Returns the cudaError_t of the launch.
extern "C" int nrt_fm_fwd_v1(const float* v, float* out, int B, int F, int D,
                          cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  fm_fwd_v1_kernel<<<grid_for(B), kWarps * 32, 0, stream>>>(v, out, B, F, D);
  return (int)cudaGetLastError();
}
