// NRMS's masked multi-head self-attention without bias, forward and backward:
//   qkv (N, L, 3 H hd) = x @ [Q | K | V], head k in columns k hd .. (k + 1) hd
//   of each third; mask (N, L) bytes, nonzero keeps a key;
//   s_ts  = (q_t . k_s) / sqrt(hd) over the kept keys s of row n,
//   alpha = softmax_s(s_ts), out (N, L, H hd): out_t = sum_s alpha_ts v_s.
// A row whose keys are all masked attends uniformly over its L keys, as
// torch.softmax over L scores of -1e9 does (models/nrms.py::masked_softmax);
// beside a kept key a -1e9 weighs exactly 0 in float32, so the kernels skip
// masked keys and do the same arithmetic.
//
// Replaces no TPU kernel: the JAX package has no NRMS. It replaces the chain
// of library calls that models/nrms.py::SelfAttention ran (a view / permute
// of x @ wqkv, q @ k^T, torch.where, softmax, alpha @ v, transpose /
// reshape, and their backward: bmm, the stack of dQ, dK, dV, layout copies).
//
// What bounds it on the H100: memory. At NRMS's news encoder (N 3,520
// titles, L 30, 16 heads of 16) the forward reads 324 MB of qkv and writes
// 108 MB for 3.2 GFLOP (0.13 ms at 3.35 TB/s against 0.05 ms at the float32
// peak); the backward reads qkv and dO and writes dqkv, 757 MB. The design
// moves each byte once and keeps the L x L scores out of device memory:
//   - a block owns one row n and G heads (ops/mhsa.py::plan_mhsa: a warp
//     for each 32 query rows of a head, G heads to a block of at most four
//     warps, 14,080 blocks at the news encoder's shape), and stages that
//     row's K and V of its heads (the backward: Q, K, V and dO) in shared
//     memory with 16-byte cp.async copies, each staged row padded by 4
//     floats so that 8 lanes reading 8 rows hit 8 bank groups;
//   - a thread owns a query row t of one head: q_t in registers, the kept
//     keys' k_s and v_s read from shared memory as broadcasts (every lane
//     of a warp reads the same s), two passes: the max of the scores, then
//     e = expf(s - max) (the accurate expf, no fast math), their sum and
//     sum e v_s in registers; out_t = (sum e v_s) / (sum e);
//   - the backward recomputes the scores and P, nothing saved but qkv and
//     the mask. Phase 1, a thread a query row t: the row's max and sum as
//     the forward takes them (the same code, the same bits), D_t = sum_s
//     P_ts dP_ts with dP_ts = dO_t . v_s, and dQ_t = sum_s dS_ts k_s /
//     sqrt(hd) with dS_ts = P_ts (dP_ts - D_t); the rows' max, sum and D go
//     to shared memory. Phase 2, a thread a key s: dK_s = sum_t dS_ts q_t /
//     sqrt(hd) and dV_s = sum_t P_ts dO_t, P and dS recomputed with the same
//     code as phase 1. A masked key's dK and dV are 0; in a row with no kept
//     key dQ and dK are 0 and dV_s = sum_t dO_t / L, as autograd through
//     torch.where gives. dQ, dK and dV go straight into one packed (N, L,
//     3 H hd) gradient, the layout the projection's backward reads.
// Every sum runs in a fixed order inside one block, with no atomics: two runs
// give the same bits. Every arithmetic step is an explicit _rn intrinsic, so
// phases 1 and 2 round alike.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLen = 128;    // the longest row the kernels take
constexpr int kMaxWarps = 4;    // a block's warps at most (G heads x W warps a head)
constexpr int kPad = 4;         // floats after each staged row of G hd floats

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies rows [0, L) of `cols` floats (a multiple of 4) at src + r * stride
// into dst + r * rs with 16-byte copies, the block's threads in turn.
__device__ __forceinline__ void stage_rows(float* dst, int rs, const float* src,
                                           long long stride, int L, int cols) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < L * per_row; i += blockDim.x) {
    const int r = i / per_row, c = 4 * (i - r * per_row);
    cp_async16(dst + r * rs + c, src + r * stride + c);
  }
}

// The row's mask into shared memory; true where the row keeps some key.
// Ends with the block's barrier, after its copies have landed.
__device__ __forceinline__ bool stage_mask(uint8_t* mk, const uint8_t* mask, int L) {
  int kept = 0;
  for (int s = threadIdx.x; s < L; s += blockDim.x) {
    mk[s] = mask[s] != 0;
    kept |= mk[s];
  }
  cp_async_wait_all();
  return __syncthreads_or(kept) != 0;
}

template <int HD>
__device__ __forceinline__ void load_row(float (&r)[HD], const float* src) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + d);
    r[d] = v.x;
    r[d + 1] = v.y;
    r[d + 2] = v.z;
    r[d + 3] = v.w;
  }
}

template <int HD>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]);
}

// a . b over d in order; b in shared memory (16-byte aligned)
template <int HD>
__device__ __forceinline__ float dot(const float (&a)[HD], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + d);
    s = __fmaf_rn(a[d], v.x, s);
    s = __fmaf_rn(a[d + 1], v.y, s);
    s = __fmaf_rn(a[d + 2], v.z, s);
    s = __fmaf_rn(a[d + 3], v.w, s);
  }
  return s;
}

// acc += w b, b in shared memory
template <int HD>
__device__ __forceinline__ void axpy(float (&acc)[HD], float w, const float* b) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(b + d);
    acc[d] = __fmaf_rn(w, v.x, acc[d]);
    acc[d + 1] = __fmaf_rn(w, v.y, acc[d + 1]);
    acc[d + 2] = __fmaf_rn(w, v.z, acc[d + 2]);
    acc[d + 3] = __fmaf_rn(w, v.w, acc[d + 3]);
  }
}

template <int HD>
__device__ __forceinline__ void zero(float (&r)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; ++d) r[d] = 0.f;
}

__device__ __forceinline__ float scaled(float dot_, float scale) { return __fmul_rn(dot_, scale); }

// The largest score of query q over the kept keys of Ks (row stride rs).
template <int HD>
__device__ __forceinline__ float row_max(const float (&q)[HD], const float* Ks, int rs,
                                         const uint8_t* mk, int L, float scale) {
  float m = -INFINITY;
  for (int s = 0; s < L; ++s)
    if (mk[s]) m = fmaxf(m, scaled(dot<HD>(q, Ks + s * rs), scale));
  return m;
}

// A kept key's unnormalised weight, P (the weight over the row's sum l) and
// dS = P (dP - D) / sqrt(hd), as the forward and both backward phases take them
__device__ __forceinline__ float weight(float score, float m) { return expf(__fsub_rn(score, m)); }

__device__ __forceinline__ float prob(float score, float m, float l) {
  return __fdiv_rn(weight(score, m), l);
}

__device__ __forceinline__ float score_grad(float p, float dp, float D, float scale) {
  return __fmul_rn(__fmul_rn(p, __fsub_rn(dp, D)), scale);
}

// One block: row n = blockIdx.x, heads g0 .. g0 + G - 1 with g0 = blockIdx.y G;
// warp w takes head w / W and query rows (w % W) 32 + lane.
template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
mhsa_fwd_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                float* __restrict__ out, int L, int H, int G, int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hh = H * HD, rs = G * HD + kPad;
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * G;
  float* Ks = smem;
  float* Vs = Ks + L * rs;
  uint8_t* mk = reinterpret_cast<uint8_t*>(Vs + L * rs);
  const float* row = qkv + n * L * 3 * hh;
  stage_rows(Ks, rs, row + hh + g0 * HD, 3 * hh, L, G * HD);
  stage_rows(Vs, rs, row + 2 * hh + g0 * HD, 3 * hh, L, G * HD);
  const bool kept = stage_mask(mk, mask + n * L, L);

  const int warp = threadIdx.x / 32, head = warp / W;
  const int t = (warp % W) * 32 + threadIdx.x % 32;
  if (t >= L) return;                       // no barrier follows
  float q[HD], acc[HD];
  load_row<HD>(q, row + (long long)t * 3 * hh + (g0 + head) * HD);
  const float* K = Ks + head * HD;
  const float* V = Vs + head * HD;
  // with no kept key every key weighs 1: the uniform softmax of all -1e9
  const float m = kept ? row_max<HD>(q, K, rs, mk, L, scale) : 0.f;
  float l = 0.f;
  zero<HD>(acc);
  for (int s = 0; s < L; ++s) {
    if (kept && !mk[s]) continue;
    const float e = kept ? weight(scaled(dot<HD>(q, K + s * rs), scale), m) : 1.f;
    l = __fadd_rn(l, e);
    axpy<HD>(acc, e, V + s * rs);
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = __fdiv_rn(acc[d], l);
  store_row<HD>(out + (n * L + t) * hh + (g0 + head) * HD, acc);
}

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
mhsa_bwd_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ mask,
                const float* __restrict__ dout, float* __restrict__ dqkv, int L, int H, int G,
                int W, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hh = H * HD, rs = G * HD + kPad;
  const long long n = blockIdx.x;
  const int g0 = blockIdx.y * G;
  float* Qs = smem;
  float* Ks = Qs + L * rs;
  float* Vs = Ks + L * rs;
  float* Gs = Vs + L * rs;                  // dO
  float* Ms = Gs + L * rs;                  // a row's max, sum and D, G x L each
  float* Ls = Ms + G * L;
  float* Ds = Ls + G * L;
  uint8_t* mk = reinterpret_cast<uint8_t*>(Ds + G * L);
  const float* row = qkv + n * L * 3 * hh;
  stage_rows(Qs, rs, row + g0 * HD, 3 * hh, L, G * HD);
  stage_rows(Ks, rs, row + hh + g0 * HD, 3 * hh, L, G * HD);
  stage_rows(Vs, rs, row + 2 * hh + g0 * HD, 3 * hh, L, G * HD);
  stage_rows(Gs, rs, dout + n * L * hh + g0 * HD, hh, L, G * HD);
  const bool kept = stage_mask(mk, mask + n * L, L);

  const int warp = threadIdx.x / 32, head = warp / W;
  const int r = (warp % W) * 32 + threadIdx.x % 32;   // phase 1: query row; 2: key
  const int col = (g0 + head) * HD;
  const float* Q = Qs + head * HD;
  const float* K = Ks + head * HD;
  const float* V = Vs + head * HD;
  const float* G_ = Gs + head * HD;
  float* dst = dqkv + (n * L + r) * 3 * hh;

  // phase 1: query row t = r
  if (r < L) {
    float q[HD], g[HD], dq[HD];
    load_row<HD>(q, Q + r * rs);
    load_row<HD>(g, G_ + r * rs);
    // the row's max and sum as the forward takes them, the same bits
    const float m = kept ? row_max<HD>(q, K, rs, mk, L, scale) : 0.f;
    float l = (float)L, D = 0.f;
    zero<HD>(dq);
    if (kept) {
      l = 0.f;
      for (int s = 0; s < L; ++s)
        if (mk[s]) {
          const float e = weight(scaled(dot<HD>(q, K + s * rs), scale), m);
          l = __fadd_rn(l, e);
          D = __fmaf_rn(e, dot<HD>(g, V + s * rs), D);
        }
      D = __fdiv_rn(D, l);
      for (int s = 0; s < L; ++s)
        if (mk[s]) {
          const float p = prob(scaled(dot<HD>(q, K + s * rs), scale), m, l);
          axpy<HD>(dq, score_grad(p, dot<HD>(g, V + s * rs), D, scale), K + s * rs);
        }
    }
    store_row<HD>(dst + col, dq);
    Ms[head * L + r] = m;
    Ls[head * L + r] = l;
    Ds[head * L + r] = D;
  }
  __syncthreads();

  // phase 2: key s = r
  if (r >= L) return;                       // no barrier follows
  float dk[HD], dv[HD];
  zero<HD>(dk);
  zero<HD>(dv);
  if (!kept) {
    const float p = __fdiv_rn(1.f, (float)L);
    for (int t = 0; t < L; ++t) axpy<HD>(dv, p, G_ + t * rs);
  } else if (mk[r]) {
    float k[HD], v[HD];
    load_row<HD>(k, K + r * rs);
    load_row<HD>(v, V + r * rs);
    const float* Mh = Ms + head * L;
    const float* Lh = Ls + head * L;
    const float* Dh = Ds + head * L;
    for (int t = 0; t < L; ++t) {
      const float p = prob(scaled(dot<HD>(k, Q + t * rs), scale), Mh[t], Lh[t]);
      axpy<HD>(dk, score_grad(p, dot<HD>(v, G_ + t * rs), Dh[t], scale), Q + t * rs);
      axpy<HD>(dv, p, G_ + t * rs);
    }
  }
  store_row<HD>(dst + hh + col, dk);
  store_row<HD>(dst + 2 * hh + col, dv);
}

size_t fwd_smem_bytes(int L, int G, int hd) {
  return 16 * ((2 * (size_t)L * (G * hd + kPad) * 4 + L + 15) / 16);
}

size_t bwd_smem_bytes(int L, int G, int hd) {
  return 16 * ((4 * (size_t)L * (G * hd + kPad) * 4 + 3 * (size_t)G * L * 4 + L + 15) / 16);
}

// the launch's shape, or false where the kernels do not take it
bool valid(int N, int L, int H, int hd, int G, int W) {
  return N >= 0 && L >= 1 && L <= kMaxLen && H >= 1 && G >= 1 && H % G == 0 &&
         H / G <= 65535 && W == (L + 31) / 32 && G * W <= kMaxWarps &&
         (hd == 8 || hd == 16 || hd == 32 || hd == 64) &&
         (long long)N * L * 3 * H * hd < (1LL << 62);
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
cudaError_t launch_fwd(const float* qkv, const uint8_t* mask, float* out, int N, int L, int H,
                       int G, int W, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L, G, HD);
  cudaError_t err = opt_in_smem(mhsa_fwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  mhsa_fwd_kernel<HD><<<dim3(N, H / G), G * W * 32, smem, stream>>>(qkv, mask, out, L, H, G, W,
                                                                    scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const float* qkv, const uint8_t* mask, const float* dout, float* dqkv,
                       int N, int L, int H, int G, int W, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(L, G, HD);
  cudaError_t err = opt_in_smem(mhsa_bwd_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  mhsa_bwd_kernel<HD><<<dim3(N, H / G), G * W * 32, smem, stream>>>(qkv, mask, dout, dqkv, L, H,
                                                                    G, W, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv (N, L, 3 H hd), mask (N, L) bytes -> out (N, L, H hd); G heads to a
// block of G W warps (W = ceil(L / 32)); scale = 1 / sqrt(hd).
extern "C" int nrt_mhsa_fwd(const float* qkv, const uint8_t* mask, float* out, int N, int L,
                            int H, int hd, int G, int W, float scale, cudaStream_t stream) {
  if (!valid(N, L, H, hd, G, W)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  switch (hd) {
    case 8: return (int)launch_fwd<8>(qkv, mask, out, N, L, H, G, W, scale, stream);
    case 16: return (int)launch_fwd<16>(qkv, mask, out, N, L, H, G, W, scale, stream);
    case 32: return (int)launch_fwd<32>(qkv, mask, out, N, L, H, G, W, scale, stream);
    default: return (int)launch_fwd<64>(qkv, mask, out, N, L, H, G, W, scale, stream);
  }
}

// ... and dout (N, L, H hd) -> dqkv (N, L, 3 H hd), every element written
extern "C" int nrt_mhsa_bwd(const float* qkv, const uint8_t* mask, const float* dout,
                            float* dqkv, int N, int L, int H, int hd, int G, int W, float scale,
                            cudaStream_t stream) {
  if (!valid(N, L, H, hd, G, W)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  switch (hd) {
    case 8: return (int)launch_bwd<8>(qkv, mask, dout, dqkv, N, L, H, G, W, scale, stream);
    case 16: return (int)launch_bwd<16>(qkv, mask, dout, dqkv, N, L, H, G, W, scale, stream);
    case 32: return (int)launch_bwd<32>(qkv, mask, dout, dqkv, N, L, H, G, W, scale, stream);
    default: return (int)launch_bwd<64>(qkv, mask, dout, dqkv, N, L, H, G, W, scale, stream);
  }
}
