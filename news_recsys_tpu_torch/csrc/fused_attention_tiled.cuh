// Device routines of the tiled route of the fused Transformer block
// (fused_attention_tiled_fwd.cu, fused_attention_tiled_bwd.cu).
//
// The route takes one shape family: 16 < L <= 32, D = 32, F = 64, head width
// 16. A thread block of four warps walks tiles of two examples. An example
// fills a slot of 32 rows (rows >= L are zero, are never written out and add
// nothing to a gradient), so a tile is 64 rows and every projection of a tile
// is a (64 x K) x (K x N) product with K, N in {32, 64, 96}. A warp owns 16
// rows of the tile and all N columns of every product: a row's LayerNorm,
// bias, ReLU, residual and ReLU gate are epilogues on the accumulators in
// registers (a row lies in the four threads of a quad), and a row's scalars
// (1/sigma, the softmax's max and sum) never leave registers.
//
// Products run on the tensor cores as mma.sync.m16n8k8 TF32 with the split
// that keeps float32 accuracy ("3xTF32"): a = a_hi + a_lo, b = b_hi + b_lo,
// acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, float32 accumulators. Both
// operands come from shared memory as float32 and are split in registers: a
// second, pre-split copy of the weights would not fit beside the backward's
// transposed kernels. The split rounds with integer arithmetic (add half a
// TF32 ulp to the magnitude, clear the 13 low bits: what cvt.rna.tf32.f32
// does), because the cvt instruction proved the slowest part of the product
// (-DNRT_SPLIT_WITH_CVT builds the split with it, for chip_profile.py
// --block-split to time the two against each other). Where the
// registers allow (up to 48 output columns a warp) the two small terms sum in
// an accumulator of their own, which halves the error against float32. The
// loop over k is unrolled twice and no further, and the backward's loops over
// the heads not at all: unrolled in full, the kernels outgrew the instruction
// cache and ran a quarter slower (and ptxas took 26 s over the backward).
//
// Shared-memory strides: an activation that is read as the A operand has a
// stride of 4 mod 32 floats (36, 68, 100), a weight read as the B operand a
// stride of 8 mod 32 (40, 72, 104); both fragment loads are then free of bank
// conflicts. The transposed reads of the weight-gradient products (A =
// activation^T) take two-way conflicts.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tiled {

constexpr int D = 32;            // model width
constexpr int F = 64;            // feed-forward width
constexpr int HD = 16;           // head width
constexpr int H = D / HD;
constexpr int LP = 32;           // rows of an example's slot
constexpr int EX = 2;            // examples a tile
constexpr int TM = EX * LP;      // rows a tile
constexpr int kWarps = TM / 16;  // a warp owns 16 rows
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e9f;    // score of an invalid key
constexpr float kLnEps = 1e-6f;

// strides (floats) in shared memory
constexpr int LDX = D + 4;        // (rows, D) activations
constexpr int LDQ = 3 * D + 4;    // q | k | v
constexpr int LDH = F + 4;        // (rows, F) activations
constexpr int LDP = LP + 4;       // probabilities of a head
constexpr int LDW_QKV = 3 * D + 8;
constexpr int LDW_D = D + 8;      // a kernel with D output columns
constexpr int LDW_F = F + 8;      // a kernel with F output columns

// the small vectors, in one array: bqkv | bo | g1 | b1 | c1 | c2 | g2 | b2
constexpr int V_BQKV = 0, V_BO = 3 * D, V_G1 = 4 * D, V_B1 = 5 * D, V_C1 = 6 * D,
              V_C2 = 6 * D + F, V_G2 = 7 * D + F, V_B2 = 8 * D + F, V_TOTAL = 9 * D + F;

struct Params {  // each a device pointer; kernels (in, out)
  const float* wqkv; const float* bqkv; const float* wo; const float* bo;
  const float* g1; const float* b1; const float* w1; const float* c1;
  const float* w2; const float* c2; const float* g2; const float* b2;
};

inline Params make_params(const float* const* p) {
  return Params{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], p[9], p[10], p[11]};
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// v rounded to TF32 (10 bits of mantissa, to nearest, ties away from zero)
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both representable in TF32
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
#ifdef NRT_SPLIT_WITH_CVT
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
#else
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
#endif
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc (16 x 8*NT, the warp's fragment layout) += A (16 x K) * B (K x 8*NT),
// in 3xTF32. A(m, k) = AT ? A[k*LDA + m] : A[m*LDA + k];
// B(k, n) = BT ? B[n*LDB + k] : B[k*LDB + n]; both in shared memory.
// Fragment layout (gid = lane / 4, tig = lane % 4): acc[nt][0], [1] are row
// gid, columns 8*nt + 2*tig, + 1; acc[nt][2], [3] the same columns of row
// gid + 8.
template <int NT>
__device__ __forceinline__ void frag_zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

template <int NT, int K, int LDA, int LDB, bool AT, bool BT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A, const float* B) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  constexpr bool kOwnSmall = NT <= 6;             // the small terms in their own accumulator
  float small[kOwnSmall ? NT : 1][4];
  if (kOwnSmall) frag_zero(small);
#pragma unroll 2                                  // more would not fit the instruction cache
  for (int k0 = 0; k0 < K; k0 += 8) {
    float a[4];
    if (AT) {
      a[0] = A[(k0 + tig) * LDA + gid];
      a[1] = A[(k0 + tig) * LDA + gid + 8];
      a[2] = A[(k0 + tig + 4) * LDA + gid];
      a[3] = A[(k0 + tig + 4) * LDA + gid + 8];
    } else {
      a[0] = A[gid * LDA + k0 + tig];
      a[1] = A[(gid + 8) * LDA + k0 + tig];
      a[2] = A[gid * LDA + k0 + tig + 4];
      a[3] = A[(gid + 8) * LDA + k0 + tig + 4];
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float b0, b1;
      if (BT) {
        b0 = B[(8 * nt + gid) * LDB + k0 + tig];
        b1 = B[(8 * nt + gid) * LDB + k0 + tig + 4];
      } else {
        b0 = B[(k0 + tig) * LDB + 8 * nt + gid];
        b1 = B[(k0 + tig + 4) * LDB + 8 * nt + gid];
      }
      uint32_t bh[2], bl[2];
      split_tf32(b0, bh[0], bl[0]);
      split_tf32(b1, bh[1], bl[1]);
      float (&sm)[4] = kOwnSmall ? small[kOwnSmall ? nt : 0] : acc[nt];
      mma_tf32(sm, al, bh);      // without an accumulator of their own: the small terms first
      mma_tf32(sm, ah, bl);
      mma_tf32(acc[nt], ah, bh);
    }
  }
  if (kOwnSmall) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nt][j] += small[kOwnSmall ? nt : 0][j];
  }
}

// acc = vec[col] on both rows (a bias as the product's starting value)
template <int NT>
__device__ __forceinline__ void frag_fill(float (&acc)[NT][4], const float* vec) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 b = *reinterpret_cast<const float2*>(vec + 8 * nt + 2 * tig);
    acc[nt][0] = b.x; acc[nt][1] = b.y; acc[nt][2] = b.x; acc[nt][3] = b.y;
  }
}

// the warp's fragment to / from rows of shared memory; `rows` points at the
// warp's row 0, column 0 of the fragment
template <int NT, int LD>
__device__ __forceinline__ void frag_store(const float (&acc)[NT][4], float* rows) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    *reinterpret_cast<float2*>(rows + gid * LD + 8 * nt + 2 * tig) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(rows + (gid + 8) * LD + 8 * nt + 2 * tig) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

template <int NT, int LD>
__device__ __forceinline__ void frag_load(float (&acc)[NT][4], const float* rows) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 lo = *reinterpret_cast<const float2*>(rows + gid * LD + 8 * nt + 2 * tig);
    const float2 hi = *reinterpret_cast<const float2*>(rows + (gid + 8) * LD + 8 * nt + 2 * tig);
    acc[nt][0] = lo.x; acc[nt][1] = lo.y; acc[nt][2] = hi.x; acc[nt][3] = hi.y;
  }
}

// sums over the four threads that hold a row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// z (16 x D fragment) -> xhat in place; inv[0], inv[1] = 1/sqrt(var + eps) of
// rows gid, gid + 8. flax's LayerNorm: var = E[z^2] - E[z]^2.
__device__ __forceinline__ void frag_layer_norm(float (&z)[D / 8][4], float (&inv)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const float a = z[nt][2 * half], b = z[nt][2 * half + 1];
      s += a + b;
      ss += a * a + b * b;
    }
    s = quad_sum(s);
    ss = quad_sum(ss);
    const float mean = s / D;
    const float var = ss / D - mean * mean;
    const float iv = rsqrtf(var + kLnEps);
    inv[half] = iv;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      z[nt][2 * half] = (z[nt][2 * half] - mean) * iv;
      z[nt][2 * half + 1] = (z[nt][2 * half + 1] - mean) * iv;
    }
  }
}

// y = xhat * scale[col] + bias[col]
__device__ __forceinline__ void frag_affine(float (&y)[D / 8][4], const float (&xhat)[D / 8][4],
                                            const float* scale, const float* bias) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const float2 g = *reinterpret_cast<const float2*>(scale + 8 * nt + 2 * tig);
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * tig);
    y[nt][0] = xhat[nt][0] * g.x + b.x; y[nt][1] = xhat[nt][1] * g.y + b.y;
    y[nt][2] = xhat[nt][2] * g.x + b.x; y[nt][3] = xhat[nt][3] * g.y + b.y;
  }
}

// The key's code: 1 valid, 0 an invalid key of the example (score -1e9),
// -1 a padding row of the slot (no weight at all, so that an example with no
// valid key attends uniformly over its L real keys).
__device__ __forceinline__ float masked_score(float s, float scale, float code) {
  return code > 0.f ? s * scale : (code == 0.f ? kNeg : -INFINITY);
}

// s (16 queries x 32 keys fragment, raw q k^T) -> softmax probabilities in place
__device__ __forceinline__ void frag_softmax(float (&s)[LP / 8][4], const float* key_code,
                                             float scale) {
  const int tig = threadIdx.x & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < LP / 8; ++nt) {
    const float2 code = *reinterpret_cast<const float2*>(key_code + 8 * nt + 2 * tig);
    s[nt][0] = masked_score(s[nt][0], scale, code.x);
    s[nt][1] = masked_score(s[nt][1], scale, code.y);
    s[nt][2] = masked_score(s[nt][2], scale, code.x);
    s[nt][3] = masked_score(s[nt][3], scale, code.y);
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float m = quad_max(mx[half]);
    float sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt) {
      const float a = expf(s[nt][2 * half] - m), b = expf(s[nt][2 * half + 1] - m);
      s[nt][2 * half] = a;
      s[nt][2 * half + 1] = b;
      sum += a + b;
    }
    sum = quad_sum(sum);
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt) {
      s[nt][2 * half] = s[nt][2 * half] / sum;
      s[nt][2 * half + 1] = s[nt][2 * half + 1] / sum;
    }
  }
}

// A kernel (rows x cols, contiguous in device memory) into shared memory
// with stride ld, asynchronously; all threads of the block take part.
__device__ __forceinline__ void stage_kernel(float* dst, int ld, const float* src, int rows,
                                             int cols) {
  const int chunks = cols / 4;
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i % chunks;
    cp_async16(dst + r * ld + 4 * c, src + r * cols + 4 * c);
  }
}

__device__ __forceinline__ void stage_vectors(float* vec, const Params& P) {
  for (int i = threadIdx.x; i < V_TOTAL; i += blockDim.x) {
    float v;
    if (i < V_BO) v = P.bqkv[i];
    else if (i < V_G1) v = P.bo[i - V_BO];
    else if (i < V_B1) v = P.g1[i - V_G1];
    else if (i < V_C1) v = P.b1[i - V_B1];
    else if (i < V_C2) v = P.c1[i - V_C1];
    else if (i < V_G2) v = P.c2[i - V_C2];
    else if (i < V_B2) v = P.g2[i - V_G2];
    else v = P.b2[i - V_B2];
    vec[i] = v;
  }
}

// The tile's x rows into sX (rows >= L of a slot stay zero; the slot of an
// example that the batch does not have is zeroed), asynchronously.
__device__ __forceinline__ void stage_x(float* sX, const float* x, int b0, int nb, int L) {
  constexpr int chunks = D / 4;
  for (int i = threadIdx.x; i < EX * L * chunks; i += blockDim.x) {
    const int c = i % chunks, row = i / chunks, e = row / L, l = row % L;
    float* dst = sX + (e * LP + l) * LDX + 4 * c;
    if (e < nb) cp_async16(dst, x + ((long long)(b0 + e) * L + l) * D + 4 * c);
    else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The tile's key codes (see masked_score) from the mask
__device__ __forceinline__ void stage_keys(float* sKey, const float* mask, int b0, int nb, int L) {
  for (int i = threadIdx.x; i < TM; i += blockDim.x) {
    const int e = i / LP, l = i % LP;
    float code = -1.f;
    if (l < L) code = (e < nb && __ldg(mask + (long long)(b0 + e) * L + l) > 0.f) ? 1.f : 0.f;
    sKey[i] = code;
  }
}

// One head's attention for the warp's 16 queries: p = softmax(q k^T) in
// registers, through the warp's own scratch sPw (16 x LDP) as the A operand
// of p v. `qkv` points at the example's slot (row 0), `qrow` at the warp's
// first row. Returns ao of the head (16 x HD fragment).
__device__ __forceinline__ void head_forward(float (&p)[LP / 8][4], float (&o)[HD / 8][4],
                                             const float* qrow, const float* qkv,
                                             const float* key_code, float* sPw, int h,
                                             float scale) {
  frag_zero(p);
  warp_mma<LP / 8, HD, LDQ, LDQ, false, true>(p, qrow + h * HD, qkv + D + h * HD);
  frag_softmax(p, key_code, scale);
  __syncwarp();
  frag_store<LP / 8, LDP>(p, sPw);
  __syncwarp();
  frag_zero(o);
  warp_mma<HD / 8, LP, LDP, LDQ, false, false>(o, sPw, qkv + 2 * D + h * HD);
}

}  // namespace tiled
