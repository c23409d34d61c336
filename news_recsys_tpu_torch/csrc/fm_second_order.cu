// FM second-order interaction, forward and backward:
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
// 1.9 MB at B 6,400 and 154 KB at B 512, the backward moves 309 KB at B 512:
// at those sizes the time is the launch and one trip to memory, and what the
// design can win is lanes that wait on nothing and loads that issue together.
//
// Both kernels have two paths, picked by shape in nrt_fm_fwd / nrt_fm_bwd and
// stated by ops/fm_kernel.py::plan_fm_fwd / plan_fm_bwd:
//   - staged, at DeepFM's 5 fields of 15 columns, F and D fixed at compile
//     time so every loop unrolls and a thread's loads issue back to back
//     (with F and D at run time the staged forward lost its whole gain over
//     the general path at B 512; chip_profile.py --fm-split). A block copies
//     its rows' span of v, contiguous in memory, into shared memory with
//     16-byte cp.async copies (stage_span: a ragged head and tail of at most
//     3 floats each as 4-byte copies), then:
//       forward: a block of 32 rows, 8 lanes a row; each lane sums s_d =
//       sum_f v and q_d = sum_f v^2 over every 8th column and the row's 8
//       lanes meet in a butterfly of 3 shuffles, so no lane waits on a
//       15-column chain and all but one of a row's 8 lanes hold two of its
//       15 columns (a warp a row left 17 of 32 lanes idle). A block is 256
//       threads (B 6,400: 200 blocks; B 512: 16); 9.4 KB of shared memory;
//       backward: dv has v's layout, so it is a staged elementwise pass. A
//       block of kBwdRows rows (a multiple of 4, so its span of kBwdRows x 75
//       floats is whole float4s) copies g's kBwdRows values beside the span;
//       after one barrier kBwdRows x 15 threads fill a table of s_d in shared
//       memory, and after a second each thread makes a float4 of dv and
//       writes it with one 16-byte store (scalar stores for a ragged head and
//       tail where dv is off the float4 grid). The first design, a warp a row
//       and a lane a column, left 17 of 32 lanes idle, issued a lane's 10
//       loads one after another and stored 4-byte scalars along 60-byte row
//       segments. Of 8, 16 and 32 rows a block, each with s_d summed again
//       for every element (5 loads, no second barrier) or from the table, 8
//       rows with the table measured fastest on an NVIDIA H100 80GB HBM3
//       (700 W; chip_profile.py --fm-split): 2.03 us at B 512 (the others
//       2.03-2.54, the general path 2.19) and 2.89 at B 6,400 (3.21-3.81;
//       3.43). More warps a block wait longer on one SM, and the table cost
//       less than summing each element's column again;
//   - general (every other shape): one warp a row, a lane a column, looping
//     over d in steps of 32, as the first design did; the forward ends in one
//     warp-shuffle sum, the backward recomputes s_d the same way and writes
//     (s_d - v_fd) * g_b.
// Every reduction stays inside one row, in a fixed order: no atomics, and
// two runs give the same bits. The staged backward sums s_d over f in order
// with __fadd_rn and takes (s - v) * g with __fsub_rn / __fmul_rn, no
// contraction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block

constexpr int kRows = 32;   // a staged forward block's rows
constexpr int kLanes = 8;   // lanes a row

constexpr int kBwdRows = 8;   // a staged backward block's rows (a multiple of 4)
static_assert(kBwdRows % 4 == 0, "a backward block's span must be whole float4s");

// the shared memory a staged block takes: its span of kRows rows of fd
// floats and up to 3 floats in front of it, in whole float4s
size_t staged_smem_bytes(int fd) { return 16 * (((size_t)kRows * fd + 6) / 4); }

// a staged backward block's threads: a float4 of its span each
constexpr int bwd_threads(int fd) { return 32 * ((kBwdRows * fd / 4 + 31) / 32); }

// the shared memory a staged backward block takes: its span as above, g's
// kBwdRows values and the table of s (kBwdRows x d)
size_t staged_bwd_smem_bytes(int fd, int d) {
  return 16 * (((size_t)kBwdRows * fd + 6) / 4) + 4 * (size_t)kBwdRows * (1 + d);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Copies the n floats at src into dst + lead, where lead = (src / 4) % 4
// puts both ends of every 16-byte copy on a 16-byte boundary (dst is one):
// scalars up to src's first boundary, float4s, scalars after the last.
// Returns lead once every thread's copies have landed.
__device__ __forceinline__ int stage_span(float* dst, const float* src, int n) {
  const int lead = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  const int head = min(n, (4 - lead) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  for (int i = threadIdx.x; i < body; i += blockDim.x)
    cp_async16(dst + lead + head + 4 * i, src + head + 4 * i);
  if ((int)threadIdx.x < head) cp_async4(dst + lead + threadIdx.x, src + threadIdx.x);
  if ((int)threadIdx.x < n - tail)
    cp_async4(dst + lead + tail + threadIdx.x, src + tail + threadIdx.x);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return lead;
}

// Lane j of a row sums columns j, j + 8, ... in order, each over f in
// order, and the row's 8 lanes (side by side in one warp) meet in a
// butterfly of shuffles: the same order on every run.
template <int F, int D>
__global__ void __launch_bounds__(kRows * kLanes)
fm_fwd_staged_kernel(const float* __restrict__ v, float* __restrict__ out, int B) {
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);
  const int fd = F * D;
  const long long b0 = (long long)blockIdx.x * kRows;
  const int rows = (int)min((long long)kRows, B - b0);
  const int lead = stage_span(span, v + b0 * fd, rows * fd);
  const int r = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
  float acc = 0.f;  // lanes past the last row add 0 and leave nothing
  if (r < rows) {
    const float* x = span + lead + r * fd;
#pragma unroll
    for (int m = 0; m < (D + kLanes - 1) / kLanes; ++m) {
      const int d = j + kLanes * m;
      if (d < D) {
        float s = 0.f, q = 0.f;
#pragma unroll
        for (int f = 0; f < F; ++f) {
          const float xv = x[f * D + d];
          s = __fadd_rn(s, xv);
          q = __fmaf_rn(xv, xv, q);
        }
        acc = __fadd_rn(acc, __fmaf_rn(s, s, -q));
      }
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if (r < rows && j == 0) out[b0 + r] = 0.5f * acc;
}

__global__ void __launch_bounds__(kWarps * 32)
fm_fwd_general_kernel(const float* __restrict__ v, float* __restrict__ out, int B, int F, int D) {
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

// sum_f p[f * D] in f order, rounded at each add
template <int F, int D>
__device__ __forceinline__ float column_sum(const float* p) {
  float s = p[0];
#pragma unroll
  for (int f = 1; f < F; ++f) s = __fadd_rn(s, p[f * D]);
  return s;
}

// Element e of the block's span (row e / FD, column e % FD % D) gets (s - v) * g,
// s from the block's table st.
template <int F, int D, int R>
__global__ void __launch_bounds__(32 * ((R * F * D / 4 + 31) / 32))
fm_bwd_staged_kernel(const float* __restrict__ v, const float* __restrict__ g,
                     float* __restrict__ dv, int B) {
  constexpr int FD = F * D;
  extern __shared__ float4 smem4[];
  float* span = reinterpret_cast<float*>(smem4);
  float* gs = span + 4 * ((R * FD + 6) / 4);
  float* st = gs + R;
  const long long b0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, B - b0);
  if ((int)threadIdx.x < rows) cp_async4(gs + threadIdx.x, g + b0 + threadIdx.x);
  const float* x = span + stage_span(span, v + b0 * FD, rows * FD);  // waits for g too
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    st[i] = column_sum<F, D>(x + r * FD + (i - r * D));
  }
  __syncthreads();
  auto grad = [&](int e) {
    const int r = e / FD, d = (e - r * FD) % D;
    return __fmul_rn(__fsub_rn(st[r * D + d], x[e]), gs[r]);
  };
  // dv's span: scalars up to its first 16-byte boundary, float4s, scalars after
  float* out = dv + b0 * FD;
  const int n = rows * FD;
  const int head = min(n, (4 - (int)((reinterpret_cast<uintptr_t>(out) >> 2) & 3)) & 3);
  const int body = (n - head) >> 2;
  const int tail = head + 4 * body;
  for (int i = threadIdx.x; i < body; i += blockDim.x) {
    const int e = head + 4 * i;
    *reinterpret_cast<float4*>(out + e) = make_float4(grad(e), grad(e + 1), grad(e + 2),
                                                      grad(e + 3));
  }
  if ((int)threadIdx.x < head) out[threadIdx.x] = grad(threadIdx.x);
  if ((int)threadIdx.x < n - tail) out[tail + threadIdx.x] = grad(tail + threadIdx.x);
}

__global__ void __launch_bounds__(kWarps * 32)
fm_bwd_general_kernel(const float* __restrict__ v, const float* __restrict__ g,
                      float* __restrict__ dv, int B, int F, int D) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;
  const long long base = row * F * D;
  const float gb = __ldg(g + row);
  for (int d = lane; d < D; d += 32) {
    float s = 0.f;
    for (int f = 0; f < F; ++f) s += __ldg(v + base + f * D + d);
    for (int f = 0; f < F; ++f) {
      const long long i = base + f * D + d;
      dv[i] = (s - __ldg(v + i)) * gb;
    }
  }
}

unsigned grid_for(int B) { return (unsigned)((B + kWarps - 1) / kWarps); }

}  // namespace

// v (B, F, D) float32, out (B,) float32; contiguous, on the device, F*D <
// 2**31. Returns the cudaError_t of the launch.
extern "C" int nrt_fm_fwd(const float* v, float* out, int B, int F, int D, cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (F == 5 && D == 15) {  // DeepFM's fields and columns
    const unsigned blocks = (unsigned)((B + kRows - 1) / kRows);
    const size_t smem = staged_smem_bytes(F * D);
    fm_fwd_staged_kernel<5, 15><<<blocks, kRows * kLanes, smem, stream>>>(v, out, B);
  } else {
    fm_fwd_general_kernel<<<grid_for(B), kWarps * 32, 0, stream>>>(v, out, B, F, D);
  }
  return (int)cudaGetLastError();
}

// v (B, F, D), g (B,), dv (B, F, D), float32; contiguous, on the device, F*D <
// 2**31. Returns the cudaError_t of the launch.
extern "C" int nrt_fm_bwd(const float* v, const float* g, float* dv, int B, int F, int D,
                          cudaStream_t stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (F == 5 && D == 15) {  // DeepFM's fields and columns
    const unsigned blocks = (unsigned)((B + kBwdRows - 1) / kBwdRows);
    fm_bwd_staged_kernel<5, 15, kBwdRows>
        <<<blocks, bwd_threads(F * D), staged_bwd_smem_bytes(F * D, D), stream>>>(v, g, dv, B);
  } else {
    fm_bwd_general_kernel<<<grid_for(B), kWarps * 32, 0, stream>>>(v, g, dv, B, F, D);
  }
  return (int)cudaGetLastError();
}
