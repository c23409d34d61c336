// One post-norm Transformer block, forward and backward, fused: the general
// route, for every shape of the domain (L <= 128, D <= 128, F <= 512). The
// attention ranker's widths take the tiled route instead
// (fused_attention_tiled_fwd.cu, fused_attention_tiled_bwd.cu), which keeps
// the parameters in shared memory and runs the products on the tensor cores.
//
//   qkv  = x Wqkv + bqkv                     (L, 3D): q | k | v, head h = columns h*hd..
//   s    = q_h k_h^T / sqrt(hd); s = -1e9 where the key is invalid; p = softmax(s)
//   ao   = concat_h p v_h
//   z1   = x + ao Wo + bo ;  y1 = LN(z1) g1 + b1
//   pre  = y1 W1 + c1 ;      z2 = y1 + relu(pre) W2 + c2 ;  y2 = LN(z2) g2 + b2
// LN is flax's: eps 1e-6, var = E[z^2] - E[z]^2. The backward recomputes the
// forward from (x, mask, parameters) and gives dx and the 12 parameter
// gradients, which are sums over all B*L rows. Kernels are (in, out), as
// flax stores them.
//
// Replaces the Pallas kernels of news_recsys_tpu/ops/fused_attention.py:
// _fused_fwd_call (body _fwd_kernel) and _fused_block_bwd (body _bwd_kernel).
// Those pad L to 32/64/128, flatten examples into 512-row tiles and run
// attention as 128 x 128 block-diagonal products with cross-example scores
// masked, to feed the MXU, and they leave garbage rows for an example whose
// mask is all zero. None of that carries over: here an example attends
// inside itself only, L is not padded, any B is taken, and an all-masked
// example attends uniformly over its L keys, as the flax block does (its
// masked scores get no gradient, as under autograd of the flax block).
//
// What bounds it on the H100: float32 operations outside the tensor cores.
// A row costs about 2*(4*D*D + 2*D*F) + 4*L*D flops (20 K at L 30, D 32,
// F 64) against 2*D*4 bytes of traffic, some 80 flops a byte. The design
// keeps everything between x and y2 out of device memory:
//   - one thread block walks whole examples (a persistent loop over b); an
//     example's activations live in one workspace, in shared memory when it
//     fits (30 KB forward, 73 KB backward at the ranker's shape), else in a
//     per-block slice of device memory that the caller provides (it stays
//     in L2), so that every L <= 128, D <= 128, F <= 512 runs in one body;
//   - every product is one routine: a thread owns an output column and RB
//     rows, reads the weight once per k from device memory (coalesced over
//     the columns; from L1 where the workspace leaves it room, else from L2)
//     and the activations as shared-memory broadcasts;
//   - products with a transposed weight (the backward's g W^T) read a
//     transposed copy that a small kernel writes first, so that they too
//     are coalesced;
//   - q | k | v rows have an odd stride, so that k_m . q_r over threads m is
//     free of bank conflicts;
//   - parameter gradients: a block adds each example's term into its own
//     partial (an element is always owned by the same thread, so there is no
//     atomic), and a second kernel sums the partials in block order. Rows
//     go to blocks by a fixed rule: two runs give the same bits.
// Nothing but x, mask and the parameters is saved for the backward: the
// recompute is a third of its arithmetic and saves writing nine (L, D|F)
// arrays per example to device memory in the forward.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int RB = 4;                 // rows per thread in a product
constexpr float kNeg = -1e9f;         // score of an invalid key
constexpr float kLnEps = 1e-6f;
constexpr int kMaxSmem = 227 * 1024;  // dynamic shared memory a block can opt in to

struct Params {  // each a device pointer; kernels (in, out)
  const float* wqkv; const float* bqkv; const float* wo; const float* bo;
  const float* g1; const float* b1; const float* w1; const float* c1;
  const float* w2; const float* c2; const float* g2; const float* b2;
};

__host__ __device__ inline int qkv_stride(int D) { return (3 * D) | 1; }

// floats of workspace per example
__host__ __device__ inline long long fwd_ws_floats(int L, int D, int F) {
  return (long long)L * (2 * D + qkv_stride(D) + L + F + 1);
}
__host__ __device__ inline long long bwd_ws_floats(int L, int D, int F) {
  return (long long)L * (7 * D + 2 * qkv_stride(D) + 2 * L + 2 * F + 3);
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[r*ldo + n] = (bias[n]) + sum_k a(act[r*lda + k]) * W[k*ldw + n] (+ res[r*ldr + n]),
// r < R, n < N, with a = relu when relu_in; the result goes through relu
// when relu_out, and is zeroed where gate[r*ldgate + n] <= 0 when gate is
// given. W and bias are read-only inputs in device memory; act, res, gate
// and out lie in the workspace (out may also be device memory), and res may
// be out itself.
__device__ void linear(float* out, int ldo, const float* act, int lda,
                       const float* __restrict__ W, int ldw, const float* __restrict__ bias,
                       const float* res, int ldr, const float* gate, int ldgate,
                       int R, int K, int N, bool relu_in, bool relu_out) {
  const int groups = (R + RB - 1) / RB;
  for (int item = threadIdx.x; item < groups * N; item += blockDim.x) {
    const int n = item % N;
    const int r0 = (item / N) * RB;
    float acc[RB];
    const float* a[RB];
    const float b = bias ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      acc[j] = b;
      a[j] = act + (long long)min(r0 + j, R - 1) * lda;
    }
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (long long)k * ldw + n);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        float v = a[j][k];
        if (relu_in) v = fmaxf(v, 0.f);
        acc[j] = fmaf(v, w, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) {
      const int r = r0 + j;
      if (r >= R) break;
      float v = acc[j];
      if (res) v += res[(long long)r * ldr + n];
      if (relu_out) v = fmaxf(v, 0.f);
      if (gate && gate[(long long)r * ldgate + n] <= 0.f) v = 0.f;
      out[(long long)r * ldo + n] = v;
    }
  }
}

// dst[k*N + n] (+)= sum_r a(act[r*lda + k]) * g[r*ldg + n]: a weight's
// gradient from one example, into this block's partial (device memory).
__device__ void outer_acc(float* dst, const float* act, int lda, const float* g, int ldg,
                          int R, int K, int N, bool relu_in, bool first) {
  for (int item = threadIdx.x; item < K * N; item += blockDim.x) {
    const int n = item % N;
    const int k = item / N;
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      float v = act[(long long)r * lda + k];
      if (relu_in) v = fmaxf(v, 0.f);
      acc = fmaf(v, g[(long long)r * ldg + n], acc);
    }
    dst[item] = first ? acc : dst[item] + acc;
  }
}

// dst[n] (+)= sum_r g[r*ldg + n] * (mul ? mul[r*ldm + n] : 1): a bias's or a
// LayerNorm scale's gradient from one example.
__device__ void colsum_acc(float* dst, const float* g, int ldg, const float* mul, int ldm,
                           int R, int N, bool first) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < R; ++r) {
      const float v = g[(long long)r * ldg + n];
      acc += mul ? v * mul[(long long)r * ldm + n] : v;
    }
    dst[n] = first ? acc : dst[n] + acc;
  }
}

// y[r] = LN(z[r]) * scale + bias per row, one warp a row; xhat (the
// normalised row) and inv (1/sqrt(var + eps), per row) are also written
// when given. y or xhat may be z itself.
__device__ void layer_norm_rows(const float* z, int ldz, float* y, long long ldy, float* xhat,
                                int ldx, float* inv_out, const float* __restrict__ scale,
                                const float* __restrict__ bias, int R, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kWarps) {
    const float* zr = z + (long long)r * ldz;
    float s = 0.f, ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float v = zr[d];
      s += v;
      ss += v * v;
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / D;
    const float var = ss / D - mean * mean;
    const float inv = rsqrtf(var + kLnEps);
    for (int d = lane; d < D; d += 32) {
      const float xh = (zr[d] - mean) * inv;
      if (xhat) xhat[(long long)r * ldx + d] = xh;
      if (y) y[(long long)r * ldy + d] = xh * __ldg(scale + d) + __ldg(bias + d);
    }
    if (inv_out && lane == 0) inv_out[r] = inv;
  }
}

// g[r] <- the gradient of LN's input, from g[r] = the gradient of its output,
// in place, one warp a row (news_recsys_tpu/ops/fused_attention.py::_ln_bwd).
__device__ void layer_norm_bwd_rows(float* g, int ldg, const float* xhat, int ldx,
                                    const float* inv, const float* __restrict__ scale,
                                    int R, int D) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += kWarps) {
    float* gr = g + (long long)r * ldg;
    const float* xr = xhat + (long long)r * ldx;
    float m1 = 0.f, m2 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float dxh = gr[d] * __ldg(scale + d);
      m1 += dxh;
      m2 += dxh * xr[d];
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    const float iv = inv[r];
    for (int d = lane; d < D; d += 32)
      gr[d] = iv * (gr[d] * __ldg(scale + d) - m1 - xr[d] * m2);
  }
}

// p (L, L) = softmax over the keys of q_h k_h^T / sqrt(hd), invalid keys at -1e9
__device__ void attention_probs(float* p, const float* qkv, int ldq, const float* valid,
                                int L, int D, int hd, int h, float scale) {
  const float* q = qkv + h * hd;
  const float* k = qkv + D + h * hd;
  for (int item = threadIdx.x; item < L * L; item += blockDim.x) {
    const int m = item % L;
    const int r = item / L;
    const float* qr = q + (long long)r * ldq;
    const float* km = k + (long long)m * ldq;
    float s = 0.f;
    for (int d = 0; d < hd; ++d) s = fmaf(qr[d], km[d], s);
    p[item] = valid[m] > 0.f ? s * scale : kNeg;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < L; r += kWarps) {
    float* pr = p + (long long)r * L;
    float mx = -INFINITY;
    for (int m = lane; m < L; m += 32) mx = fmaxf(mx, pr[m]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int m = lane; m < L; m += 32) {
      const float e = expf(pr[m] - mx);
      pr[m] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int m = lane; m < L; m += 32) pr[m] = pr[m] / sum;
  }
  __syncthreads();
}

// The forward up to ao: x and the mask into the workspace, qkv, and the
// attention of every head. Ends synchronised.
__device__ void attention_forward(const float* __restrict__ x, const float* __restrict__ mask,
                                  const Params& P, float* sX, float* sQKV, int ldq, float* sAO,
                                  float* sS, float* sM, int L, int D, int H) {
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) sX[i] = __ldg(x + i);
  for (int i = threadIdx.x; i < L; i += blockDim.x) sM[i] = __ldg(mask + i);
  __syncthreads();
  linear(sQKV, ldq, sX, D, P.wqkv, 3 * D, P.bqkv, nullptr, 0, nullptr, 0, L, D, 3 * D, false,
         false);
  __syncthreads();
  for (int h = 0; h < H; ++h) {
    attention_probs(sS, sQKV, ldq, sM, L, D, hd, h, scale);
    const float* v = sQKV + 2 * D + h * hd;
    for (int item = threadIdx.x; item < L * hd; item += blockDim.x) {
      const int d = item % hd;
      const int r = item / hd;
      const float* pr = sS + (long long)r * L;
      float acc = 0.f;
      for (int m = 0; m < L; ++m) acc = fmaf(pr[m], v[(long long)m * ldq + d], acc);
      sAO[(long long)r * D + h * hd + d] = acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
fused_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mask, Params P,
                       float* __restrict__ out, float* gws, int B, int L, int D, int F, int H) {
  extern __shared__ float smem[];
  float* ws = gws ? gws + (long long)blockIdx.x * fwd_ws_floats(L, D, F) : smem;
  const int ldq = qkv_stride(D);
  float* sX = ws;                             // x, then z1, then y1
  float* sAO = sX + (long long)L * D;
  float* sQKV = sAO + (long long)L * D;
  float* sS = sQKV + (long long)L * ldq;
  float* sH = sS + (long long)L * L;          // relu(pre)
  float* sM = sH + (long long)L * F;

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const long long off = (long long)b * L * D;
    attention_forward(x + off, mask + (long long)b * L, P, sX, sQKV, ldq, sAO, sS, sM, L, D, H);
    linear(sX, D, sAO, D, P.wo, D, P.bo, sX, D, nullptr, 0, L, D, D, false, false);
    __syncthreads();
    layer_norm_rows(sX, D, sX, D, nullptr, 0, nullptr, P.g1, P.b1, L, D);
    __syncthreads();
    linear(sH, F, sX, D, P.w1, F, P.c1, nullptr, 0, nullptr, 0, L, D, F, false, true);
    __syncthreads();
    linear(sAO, D, sH, F, P.w2, D, P.c2, sX, D, nullptr, 0, L, F, D, false, false);
    __syncthreads();
    layer_norm_rows(sAO, D, out + off, D, nullptr, 0, nullptr, P.g2, P.b2, L, D);
    __syncthreads();
  }
}

// Offsets of the 12 parameters in the flat gradient (and in a partial)
struct Offsets {
  long long wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2, b2, total;
};
__host__ __device__ inline Offsets param_offsets(int D, int F) {
  Offsets o;
  long long at = 0;
  o.wqkv = at; at += 3LL * D * D;
  o.bqkv = at; at += 3 * D;
  o.wo = at; at += (long long)D * D;
  o.bo = at; at += D;
  o.g1 = at; at += D;
  o.b1 = at; at += D;
  o.w1 = at; at += (long long)D * F;
  o.c1 = at; at += F;
  o.w2 = at; at += (long long)F * D;
  o.c2 = at; at += D;
  o.g2 = at; at += D;
  o.b2 = at; at += D;
  o.total = at;
  return o;
}

// wt = the four kernels transposed: wqkv^T (3D, D), wo^T (D, D), w1^T (F, D), w2^T (D, F)
__global__ void transpose_kernels(Params P, float* __restrict__ wt, int D, int F) {
  const long long n_qkv = 3LL * D * D, n_o = (long long)D * D, n_1 = (long long)D * F;
  const long long total = n_qkv + n_o + 2 * n_1;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const float* src;
    long long j = i;
    int rows, cols;  // of the source
    if (j < n_qkv) { src = P.wqkv; rows = D; cols = 3 * D; }
    else if ((j -= n_qkv) < n_o) { src = P.wo; rows = D; cols = D; }
    else if ((j -= n_o) < n_1) { src = P.w1; rows = D; cols = F; }
    else { j -= n_1; src = P.w2; rows = F; cols = D; }
    const int c = (int)(j / rows);   // wt[c][r] = src[r][c]
    const int r = (int)(j % rows);
    wt[i] = __ldg(src + (long long)r * cols + c);
  }
}

__global__ void __launch_bounds__(kThreads)
fused_block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                       const float* __restrict__ dy, Params P, const float* __restrict__ wt,
                       float* __restrict__ dx, float* partial, float* gws, int B, int L, int D,
                       int F, int H) {
  extern __shared__ float smem[];
  float* ws = gws ? gws + (long long)blockIdx.x * bwd_ws_floats(L, D, F) : smem;
  const int ldq = qkv_stride(D);
  const long long LD = (long long)L * D;
  float* sX = ws;                  // x
  float* sAO = sX + LD;            // ao
  float* sX1 = sAO + LD;           // z1, then xhat1
  float* sY1 = sX1 + LD;           // y1
  float* sX2 = sY1 + LD;           // z2, then xhat2
  float* sG = sX2 + LD;            // dy2 -> dz2 -> dy1 -> dz1
  float* sDAO = sG + LD;           // dao
  float* sQKV = sDAO + LD;         // q | k | v
  float* sDQKV = sQKV + (long long)L * ldq;   // dq | dk | dv
  float* sS = sDQKV + (long long)L * ldq;     // p of the current head
  float* sDS = sS + (long long)L * L;         // dp -> ds
  float* sH = sDS + (long long)L * L;         // pre
  float* sDH = sH + (long long)L * F;         // dpre
  float* sM = sDH + (long long)L * F;         // mask
  float* sInv1 = sM + L;
  float* sInv2 = sInv1 + L;

  const Offsets o = param_offsets(D, F);
  float* part = partial + (long long)blockIdx.x * o.total;
  const float* wqkvT = wt;                              // (3D, D)
  const float* woT = wqkvT + 3LL * D * D;               // (D, D)
  const float* w1T = woT + (long long)D * D;            // (F, D)
  const float* w2T = w1T + (long long)D * F;            // (D, F)
  const int hd = D / H;
  const float scale = 1.0f / sqrtf((float)hd);

  bool first = true;
  for (int b = blockIdx.x; b < B; b += gridDim.x, first = false) {
    const long long off = (long long)b * LD;
    // -- the forward again, keeping what the backward reads
    attention_forward(x + off, mask + (long long)b * L, P, sX, sQKV, ldq, sAO, sS, sM, L, D, H);
    linear(sX1, D, sAO, D, P.wo, D, P.bo, sX, D, nullptr, 0, L, D, D, false, false);
    for (int i = threadIdx.x; i < LD; i += blockDim.x) sG[i] = __ldg(dy + off + i);
    __syncthreads();
    layer_norm_rows(sX1, D, sY1, D, sX1, D, sInv1, P.g1, P.b1, L, D);
    __syncthreads();
    linear(sH, F, sY1, D, P.w1, F, P.c1, nullptr, 0, nullptr, 0, L, D, F, false, false);
    __syncthreads();
    linear(sX2, D, sH, F, P.w2, D, P.c2, sY1, D, nullptr, 0, L, F, D, true, false);
    __syncthreads();
    layer_norm_rows(sX2, D, nullptr, 0, sX2, D, sInv2, P.g2, P.b2, L, D);
    __syncthreads();

    // -- LN 2
    colsum_acc(part + o.g2, sG, D, sX2, D, L, D, first);
    colsum_acc(part + o.b2, sG, D, nullptr, 0, L, D, first);
    __syncthreads();
    layer_norm_bwd_rows(sG, D, sX2, D, sInv2, P.g2, L, D);        // sG = dz2
    __syncthreads();
    // -- feed-forward
    outer_acc(part + o.w2, sH, F, sG, D, L, F, D, true, first);
    colsum_acc(part + o.c2, sG, D, nullptr, 0, L, D, first);
    linear(sDH, F, sG, D, w2T, F, nullptr, nullptr, 0, sH, F, L, D, F, false, false);  // dpre
    __syncthreads();
    outer_acc(part + o.w1, sY1, D, sDH, F, L, D, F, false, first);
    colsum_acc(part + o.c1, sDH, F, nullptr, 0, L, F, first);
    __syncthreads();
    linear(sG, D, sDH, F, w1T, D, nullptr, sG, D, nullptr, 0, L, F, D, false, false);  // dy1
    __syncthreads();
    // -- LN 1
    colsum_acc(part + o.g1, sG, D, sX1, D, L, D, first);
    colsum_acc(part + o.b1, sG, D, nullptr, 0, L, D, first);
    __syncthreads();
    layer_norm_bwd_rows(sG, D, sX1, D, sInv1, P.g1, L, D);        // sG = dz1
    __syncthreads();
    // -- output projection
    outer_acc(part + o.wo, sAO, D, sG, D, L, D, D, false, first);
    colsum_acc(part + o.bo, sG, D, nullptr, 0, L, D, first);
    linear(sDAO, D, sG, D, woT, D, nullptr, nullptr, 0, nullptr, 0, L, D, D, false, false);
    __syncthreads();
    // -- attention, head by head
    for (int h = 0; h < H; ++h) {
      attention_probs(sS, sQKV, ldq, sM, L, D, hd, h, scale);
      const float* q = sQKV + h * hd;
      const float* k = sQKV + D + h * hd;
      const float* v = sQKV + 2 * D + h * hd;
      const float* dao = sDAO + h * hd;
      for (int item = threadIdx.x; item < L * L; item += blockDim.x) {   // dp = dao v^T
        const int m = item % L;
        const int r = item / L;
        const float* dr = dao + (long long)r * D;
        const float* vm = v + (long long)m * ldq;
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s = fmaf(dr[d], vm[d], s);
        sDS[item] = s;
      }
      __syncthreads();
      const int lane = threadIdx.x & 31;
      for (int r = threadIdx.x >> 5; r < L; r += kWarps) {   // ds = p (dp - sum dp p) scale
        float* dr = sDS + (long long)r * L;
        const float* pr = sS + (long long)r * L;
        float t = 0.f;
        for (int m = lane; m < L; m += 32) t = fmaf(dr[m], pr[m], t);
        t = warp_sum(t);
        for (int m = lane; m < L; m += 32)
          dr[m] = sM[m] > 0.f ? pr[m] * (dr[m] - t) * scale : 0.f;
      }
      __syncthreads();
      for (int item = threadIdx.x; item < L * hd; item += blockDim.x) {
        const int d = item % hd;
        const int r = item / hd;   // a query row for dq, a key row for dk and dv
        float aq = 0.f, ak = 0.f, av = 0.f;
        for (int m = 0; m < L; ++m) {
          aq = fmaf(sDS[(long long)r * L + m], k[(long long)m * ldq + d], aq);
          ak = fmaf(sDS[(long long)m * L + r], q[(long long)m * ldq + d], ak);
          av = fmaf(sS[(long long)m * L + r], dao[(long long)m * D + d], av);
        }
        float* dst = sDQKV + (long long)r * ldq + h * hd + d;
        dst[0] = aq;
        dst[D] = ak;
        dst[2 * D] = av;
      }
      __syncthreads();
    }
    // -- qkv projection and dx
    outer_acc(part + o.wqkv, sX, D, sDQKV, ldq, L, D, 3 * D, false, first);
    colsum_acc(part + o.bqkv, sDQKV, ldq, nullptr, 0, L, 3 * D, first);
    linear(dx + off, D, sDQKV, ldq, wqkvT, D, nullptr, sG, D, nullptr, 0, L, 3 * D, D, false,
           false);
    __syncthreads();
  }
}

// dflat[i] = the sum over the nblk block partials, in block order
__global__ void reduce_partials_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dflat, int nblk, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = 0.f;
  for (int b = 0; b < nblk; ++b) sum += partial[(long long)b * total + i];
  dflat[i] = sum;
}

bool bad_shape(int B, int L, int D, int F, int H, int nblk) {
  return B <= 0 || L <= 0 || D <= 0 || F <= 0 || H <= 0 || D % H != 0 || nblk <= 0 || nblk > B;
}

template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Params make_params(const float* const* p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11]};
}

}  // namespace

// Floats of workspace one thread block needs (backward != 0: the backward
// kernel's). Up to 227 KB of it lives in shared memory; above that the
// caller passes nblk times as many floats of device memory as `ws`.
extern "C" long long nrt_fused_block_ws_floats(int L, int D, int F, int backward) {
  return backward ? bwd_ws_floats(L, D, F) : fwd_ws_floats(L, D, F);
}

// Floats of the flat parameter gradient (and of one block's partial).
extern "C" long long nrt_fused_block_param_floats(int D, int F) {
  return param_offsets(D, F).total;
}

// x (B, L, D), mask (B, L), params: 12 device pointers in the order wqkv
// (D, 3D), bqkv, wo (D, D), bo, g1, b1, w1 (D, F), c1, w2 (F, D), c2, g2, b2;
// out (B, L, D). All float32, contiguous, on the device. D % H == 0;
// 1 <= nblk <= B thread blocks share the examples. ws: null when the
// workspace fits shared memory, else nblk * nrt_fused_block_ws_floats(.., 0)
// floats. Returns the cudaError_t of the launch.
extern "C" int nrt_fused_block_fwd(const float* x, const float* mask, const float* const* params,
                                   float* out, float* ws, int B, int L, int D, int F, int H,
                                   int nblk, cudaStream_t stream) {
  if (bad_shape(B, L, D, F, H, nblk)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)fwd_ws_floats(L, D, F) * sizeof(float);
  const bool in_smem = bytes <= (size_t)kMaxSmem;
  if (!in_smem && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (in_smem) {
    const cudaError_t err = opt_in_smem(fused_block_fwd_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fused_block_fwd_kernel<<<nblk, kThreads, in_smem ? bytes : 0, stream>>>(
      x, mask, make_params(params), out, in_smem ? nullptr : ws, B, L, D, F, H);
  return (int)cudaGetLastError();
}

// As above, with dy (B, L, D) in; dx (B, L, D) and dflat (the 12 parameter
// gradients, flat, in the parameters' order) out. Scratch: wt, 4*D*D + 2*D*F
// floats (the transposed kernels); partial, nblk *
// nrt_fused_block_param_floats floats; ws as above with backward = 1.
extern "C" int nrt_fused_block_bwd(const float* x, const float* mask, const float* dy,
                                   const float* const* params, float* dx, float* dflat,
                                   float* wt, float* partial, float* ws, int B, int L, int D,
                                   int F, int H, int nblk, cudaStream_t stream) {
  if (bad_shape(B, L, D, F, H, nblk)) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)bwd_ws_floats(L, D, F) * sizeof(float);
  const bool in_smem = bytes <= (size_t)kMaxSmem;
  if (!in_smem && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Params P = make_params(params);
  const long long n_wt = 4LL * D * D + 2LL * D * F;
  transpose_kernels<<<(unsigned)((n_wt + 255) / 256), 256, 0, stream>>>(P, wt, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (in_smem) {
    err = opt_in_smem(fused_block_bwd_kernel, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fused_block_bwd_kernel<<<nblk, kThreads, in_smem ? bytes : 0, stream>>>(
      x, mask, dy, P, wt, dx, partial, in_smem ? nullptr : ws, B, L, D, F, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = param_offsets(D, F).total;
  reduce_partials_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(partial, dflat,
                                                                             nblk, total);
  return (int)cudaGetLastError();
}
