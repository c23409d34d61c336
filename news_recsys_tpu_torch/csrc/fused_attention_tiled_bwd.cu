// The fused Transformer block's backward, tiled route (see fused_attention.cu
// for the function and the general route, fused_attention_tiled.cuh for the
// tile, the fragment layout and the 3xTF32 products).
//
// Replaces news_recsys_tpu/ops/fused_attention.py::_fused_block_bwd (body
// _bwd_kernel) at the attention ranker's widths (16 < L <= 32, D 32, F 64,
// heads of 16). It recomputes the forward from (x, mask, parameters) and
// gives dx and the flat gradient of the 12 parameters.
//
// What bounds it on the H100: operations (three times the forward's: 0.93
// GFLOP at batch 512, 1.9 us at the TF32 rate of 495 TFLOP/s) on paper; in
// fact one tile's chain of dependent phases, since a batch of 512 is two tiles
// a block. The design:
//   - a persistent block (one an SM: 213 KB of shared memory) stages the 12
//     parameters once with cp.async and builds the four transposed kernels
//     from that copy in shared memory: no launch transposes, no weight comes
//     from device memory inside a product;
//   - tiles of two examples, a warp owns 16 rows (see the header): both
//     LayerNorms and their backwards, the ReLU gate and the residuals run on
//     accumulators in registers; 1/sigma, xhat1, dz2 and dz1 of a row stay in
//     the registers of the threads that own it from where they arise to where
//     they are used;
//   - a weight's gradient is act^T g over the tile's 64 rows, one more product
//     on the tensor cores (the padding rows carry g = 0). The block keeps its
//     8,544 sums in shared memory across all its tiles (an element always
//     belongs to the same thread, tiles in a fixed order) and writes them to
//     device memory once, at the end; bias and LayerNorm-scale gradients are
//     column sums of fragments, kept per warp and added in warp order;
//   - tiles are dealt round-robin: a block's count differs from another's by
//     at most one. nrt_reduce_partials then adds the blocks' partials, each
//     block of it taking 32 elements with its eight warps striding over the
//     partials and adding their sums in warp order: two runs give the same
//     bits;
//   - attention per head: a warp recomputes p for its 16 queries, takes
//     dp = dao v^T and ds = p (dp - sum dp p) / sqrt(hd) on fragments, and
//     shares p and ds with the other warp of its example through shared
//     memory for dk = ds^T q and dv = p^T dao; dq | dk | dv overwrite
//     q | k | v once both warps have read the head.

#include "fused_attention_tiled.cuh"

namespace {

using namespace tiled;

// the flat gradient: offsets of the parameters, in their order
constexpr int O_WQKV = 0, O_BQKV = O_WQKV + 3 * D * D, O_WO = O_BQKV + 3 * D,
              O_BO = O_WO + D * D, O_G1 = O_BO + D, O_B1 = O_G1 + D, O_W1 = O_B1 + D,
              O_C1 = O_W1 + D * F, O_W2 = O_C1 + F, O_C2 = O_W2 + F * D, O_G2 = O_C2 + D,
              O_B2 = O_G2 + D, O_TOTAL = O_B2 + D;

// shared memory, in floats
constexpr int S_WQKV = 0;
constexpr int S_WO = S_WQKV + D * LDW_QKV;
constexpr int S_W1 = S_WO + D * LDW_D;
constexpr int S_W2 = S_W1 + D * LDW_F;
constexpr int S_WQKVT = S_W2 + F * LDW_D;          // (3D, D)
constexpr int S_WOT = S_WQKVT + 3 * D * LDW_D;     // (D, D)
constexpr int S_W1T = S_WOT + D * LDW_D;           // (F, D)
constexpr int S_W2T = S_W1T + F * LDW_D;           // (D, F)
constexpr int S_VEC = S_W2T + D * LDW_F;
constexpr int S_PART = S_VEC + V_TOTAL;            // the block's partial, flat
constexpr int S_COL = S_PART + O_TOTAL;            // column sums, a slot a warp
constexpr int S_X = S_COL + kWarps * V_TOTAL;
constexpr int S_AO = S_X + TM * LDX;
constexpr int S_Y1 = S_AO + TM * LDX;              // y1, then dao
constexpr int S_G = S_Y1 + TM * LDX;               // dz2, then dz1
constexpr int S_QKV = S_G + TM * LDX;              // q | k | v, then dq | dk | dv
constexpr int S_H = S_QKV + TM * LDQ;              // relu(pre), then dpre
constexpr int S_P = S_H + TM * LDH;
constexpr int S_DS = S_P + TM * LDP;
constexpr int S_KEY = S_DS + TM * LDP;
constexpr int S_TOTAL = S_KEY + TM;
static_assert(S_TOTAL * sizeof(float) <= 227 * 1024, "the block's shared memory");

// slot[col] += the sum of v over the warp's 16 rows (the slot is the warp's own)
template <int NT>
__device__ __forceinline__ void colsum_add(const float (&v)[NT][4], float* slot) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float s0 = v[nt][0] + v[nt][2], s1 = v[nt][1] + v[nt][3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (gid == 0) {
      slot[8 * nt + 2 * tig] += s0;
      slot[8 * nt + 2 * tig + 1] += s1;
    }
  }
}

// g = the gradient of LN's output -> the gradient of its input, in place
__device__ __forceinline__ void frag_layer_norm_bwd(float (&g)[D / 8][4],
                                                    const float (&xhat)[D / 8][4],
                                                    const float (&inv)[2], const float* scale) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * nt + 2 * tig);
      const float a = g[nt][2 * half] * sc.x, b = g[nt][2 * half + 1] * sc.y;
      g[nt][2 * half] = a;
      g[nt][2 * half + 1] = b;
      m1 += a + b;
      m2 += a * xhat[nt][2 * half] + b * xhat[nt][2 * half + 1];
    }
    m1 = quad_sum(m1) / D;
    m2 = quad_sum(m2) / D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      g[nt][2 * half] = inv[half] * (g[nt][2 * half] - m1 - xhat[nt][2 * half] * m2);
      g[nt][2 * half + 1] = inv[half] * (g[nt][2 * half + 1] - m1 - xhat[nt][2 * half + 1] * m2);
    }
  }
}

// part (rows m0.., columns n0.. of a (., N) gradient) += act^T g over the
// tile's rows: act points at column m0 of the activation, g at column n0.
template <int NT, int LDA, int LDB, int N>
__device__ __forceinline__ void wgrad_add(float* part, const float* act, const float* g) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  float acc[NT][4];
  frag_zero(acc);
  warp_mma<NT, TM, LDA, LDB, true, false>(acc, act, g);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float2* lo = reinterpret_cast<float2*>(part + gid * N + 8 * nt + 2 * tig);
    float2* hi = reinterpret_cast<float2*>(part + (gid + 8) * N + 8 * nt + 2 * tig);
    float2 a = *lo, b = *hi;
    a.x += acc[nt][0]; a.y += acc[nt][1]; b.x += acc[nt][2]; b.y += acc[nt][3];
    *lo = a;
    *hi = b;
  }
}

template <int NT>
__device__ __forceinline__ void frag_add(float (&a)[NT][4], const float (&b)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[nt][j] += b[nt][j];
}

template <int NT>
__device__ __forceinline__ void frag_mul(float (&out)[NT][4], const float (&a)[NT][4],
                                         const float (&b)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[nt][j] = a[nt][j] * b[nt][j];
}

// dst (cols x rows, stride ldd) = src (rows x cols, stride lds) transposed
__device__ __forceinline__ void transpose_kernel(float* dst, int ldd, const float* src, int lds,
                                                 int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    dst[c * ldd + r] = src[r * lds + c];
  }
}

// where a small vector's gradient lies in the flat gradient
__device__ __forceinline__ int vec_to_flat(int v) {
  if (v < V_BO) return O_BQKV + v;
  if (v < V_C1) return O_BO + v - V_BO;     // bo | g1 | b1
  if (v < V_C2) return O_C1 + v - V_C1;
  return O_C2 + v - V_C2;                   // c2 | g2 | b2
}

__global__ void __launch_bounds__(kThreads)
tiled_block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                       const float* __restrict__ dy, Params P, float* __restrict__ dx,
                       float* __restrict__ partial, int B, int L) {
  extern __shared__ __align__(16) float smem[];
  float* sVec = smem + S_VEC;
  float* sPart = smem + S_PART;
  float* sKey = smem + S_KEY;
  float* sX = smem + S_X;
  float* sQKV = smem + S_QKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int e = warp / (LP / 16);                 // the warp's example in the tile
  const int row0 = 16 * warp, erow0 = row0 % LP;
  float* sCol = smem + S_COL + warp * V_TOTAL;    // the warp's column sums
  const float scale = 1.0f / sqrtf((float)HD);
  const int tiles = (B + EX - 1) / EX;

  stage_kernel(smem + S_WQKV, LDW_QKV, P.wqkv, D, 3 * D);
  stage_kernel(smem + S_WO, LDW_D, P.wo, D, D);
  stage_kernel(smem + S_W1, LDW_F, P.w1, D, F);
  stage_kernel(smem + S_W2, LDW_D, P.w2, F, D);
  cp_async_commit();
  stage_vectors(sVec, P);
  for (int i = threadIdx.x; i < O_TOTAL + kWarps * V_TOTAL + TM * LDX; i += blockDim.x)
    sPart[i] = 0.f;                               // the partial, the column sums and x's padding
  cp_async_wait_all();
  __syncthreads();
  transpose_kernel(smem + S_WQKVT, LDW_D, smem + S_WQKV, LDW_QKV, D, 3 * D);
  transpose_kernel(smem + S_WOT, LDW_D, smem + S_WO, LDW_D, D, D);
  transpose_kernel(smem + S_W1T, LDW_D, smem + S_W1, LDW_F, D, F);
  transpose_kernel(smem + S_W2T, LDW_F, smem + S_W2, LDW_D, F, D);

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * EX, nb = min(EX, B - b0);
    __syncthreads();                              // the tile before is done with everything
    stage_x(sX, x, b0, nb, L);
    cp_async_commit();
    stage_keys(sKey, mask, b0, nb, L);
    const int next = tile + gridDim.x;
    if (next < tiles) {                           // the next tile's x and dy on their way to L2
      const int rows = min(EX, B - next * EX) * L;
      for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        prefetch_l2(x + ((long long)next * EX * L + i) * D);
        prefetch_l2(dy + ((long long)next * EX * L + i) * D);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- the forward again, keeping what the backward reads
    {   // q | k | v
      float acc[3 * D / 8][4];
      frag_fill(acc, sVec + V_BQKV);
      warp_mma<3 * D / 8, D, LDX, LDW_QKV, false, false>(acc, sX + row0 * LDX, smem + S_WQKV);
      frag_store<3 * D / 8, LDQ>(acc, sQKV + row0 * LDQ);
    }
    __syncthreads();                              // the other warp's k and v
    float* sAO = smem + S_AO + row0 * LDX;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      float p[LP / 8][4], o[HD / 8][4];
      head_forward(p, o, sQKV + row0 * LDQ, sQKV + e * LP * LDQ, sKey + e * LP,
                   smem + S_P + row0 * LDP, h, scale);
      frag_store<HD / 8, LDX>(o, sAO + h * HD);
    }
    __syncwarp();
    float xhat1[D / 8][4], inv1[2], y1[D / 8][4];
    {   // z1 = x + ao Wo + bo; xhat1 = LN(z1); y1 = xhat1 g1 + b1
      float res[D / 8][4];
      frag_fill(xhat1, sVec + V_BO);
      frag_load<D / 8, LDX>(res, sX + row0 * LDX);
      frag_add(xhat1, res);
      warp_mma<D / 8, D, LDX, LDW_D, false, false>(xhat1, sAO, smem + S_WO);
      frag_layer_norm(xhat1, inv1);
      frag_affine(y1, xhat1, sVec + V_G1, sVec + V_B1);
    }
    float* sY1 = smem + S_Y1 + row0 * LDX;
    float* sH = smem + S_H + row0 * LDH;
    frag_store<D / 8, LDX>(y1, sY1);
    __syncwarp();
    {   // relu(y1 W1 + c1)
      float acc[F / 8][4];
      frag_fill(acc, sVec + V_C1);
      warp_mma<F / 8, D, LDX, LDW_F, false, false>(acc, sY1, smem + S_W1);
#pragma unroll
      for (int nt = 0; nt < F / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = fmaxf(acc[nt][j], 0.f);
      frag_store<F / 8, LDH>(acc, sH);
      __syncwarp();
    }
    float dz2[D / 8][4];
    {   // z2 = y1 + h W2 + c2; xhat2 = LN(z2); then LN 2's backward on dy
      float xhat2[D / 8][4], inv2[2], t[D / 8][4];
      frag_fill(xhat2, sVec + V_C2);
      frag_add(xhat2, y1);
      warp_mma<D / 8, F, LDH, LDW_D, false, false>(xhat2, sH, smem + S_W2);
      frag_layer_norm(xhat2, inv2);
      const int l0 = erow0 + gid;
      const float* src = dy + ((long long)(b0 + e) * L) * D + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        float2 lo = make_float2(0.f, 0.f), hi = lo;
        if (e < nb && l0 < L)
          lo = __ldg(reinterpret_cast<const float2*>(src + (long long)l0 * D + 8 * nt));
        if (e < nb && l0 + 8 < L)
          hi = __ldg(reinterpret_cast<const float2*>(src + (long long)(l0 + 8) * D + 8 * nt));
        dz2[nt][0] = lo.x; dz2[nt][1] = lo.y; dz2[nt][2] = hi.x; dz2[nt][3] = hi.y;
      }
      frag_mul(t, dz2, xhat2);
      colsum_add(t, sCol + V_G2);
      colsum_add(dz2, sCol + V_B2);
      frag_layer_norm_bwd(dz2, xhat2, inv2, sVec + V_G2);
    }
    colsum_add(dz2, sCol + V_C2);
    float* sG = smem + S_G + row0 * LDX;
    frag_store<D / 8, LDX>(dz2, sG);
    __syncthreads();                              // relu(pre) and dz2 of every row

    // ---- feed-forward
    {
      float dh[F / 8][4];
      frag_zero(dh);
      warp_mma<F / 8, D, LDX, LDW_F, false, false>(dh, sG, smem + S_W2T);
      // w2 (F, D): the warp takes 16 of its rows
      wgrad_add<D / 8, LDH, LDX, D>(sPart + O_W2 + row0 * D, smem + S_H + row0, smem + S_G);
      __syncthreads();                            // relu(pre) is read: dpre takes its place
      float h[F / 8][4];
      frag_load<F / 8, LDH>(h, sH);
#pragma unroll
      for (int nt = 0; nt < F / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) dh[nt][j] = h[nt][j] > 0.f ? dh[nt][j] : 0.f;
      frag_store<F / 8, LDH>(dh, sH);
      colsum_add(dh, sCol + V_C1);
    }
    __syncthreads();                              // dpre of every row
    // w1 (D, F): rows 16 * (warp % 2).., columns 32 * (warp / 2)..
    wgrad_add<F / 16, LDX, LDH, F>(sPart + O_W1 + (warp % 2) * 16 * F + (warp / 2) * (F / 2),
                                   smem + S_Y1 + (warp % 2) * 16,
                                   smem + S_H + (warp / 2) * (F / 2));
    float dz1[D / 8][4];
    {   // dy1 = dz2 + dpre W1^T; LN 1's backward
      float t[D / 8][4];
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) dz1[nt][j] = dz2[nt][j];
      warp_mma<D / 8, F, LDH, LDW_D, false, false>(dz1, sH, smem + S_W1T);
      frag_mul(t, dz1, xhat1);
      colsum_add(t, sCol + V_G1);
      colsum_add(dz1, sCol + V_B1);
      frag_layer_norm_bwd(dz1, xhat1, inv1, sVec + V_G1);
    }
    colsum_add(dz1, sCol + V_BO);
    frag_store<D / 8, LDX>(dz1, sG);              // dz2 was last read before the barrier above
    __syncthreads();                              // dz1 of every row; y1 is read

    // ---- output projection
    // wo (D, D): rows 16 * (warp % 2).., columns 16 * (warp / 2)..
    wgrad_add<D / 16, LDX, LDX, D>(sPart + O_WO + (warp % 2) * 16 * D + (warp / 2) * (D / 2),
                                   smem + S_AO + (warp % 2) * 16,
                                   smem + S_G + (warp / 2) * (D / 2));
    float* sDAO = sY1;                            // dao takes y1's place
    {
      float dao[D / 8][4];
      frag_zero(dao);
      warp_mma<D / 8, D, LDX, LDW_D, false, false>(dao, sG, smem + S_WOT);
      frag_store<D / 8, LDX>(dao, sDAO);
    }
    __syncwarp();

    // ---- attention, head by head
    const float* qkv_e = sQKV + e * LP * LDQ;     // the example's slot
    float* sP = smem + S_P;
    float* sDS = smem + S_DS;
#pragma unroll 1
    for (int h = 0; h < H; ++h) {
      {
        float p[LP / 8][4], ds[LP / 8][4];
        frag_zero(p);
        warp_mma<LP / 8, HD, LDQ, LDQ, false, true>(p, sQKV + row0 * LDQ + h * HD,
                                                    qkv_e + D + h * HD);
        frag_softmax(p, sKey + e * LP, scale);
        frag_zero(ds);                            // dp = dao v^T
        warp_mma<LP / 8, HD, LDX, LDQ, false, true>(ds, sDAO + h * HD, qkv_e + 2 * D + h * HD);
#pragma unroll
        for (int half = 0; half < 2; ++half) {    // ds = p (dp - sum dp p) / sqrt(hd)
          float t = 0.f;
#pragma unroll
          for (int nt = 0; nt < LP / 8; ++nt)
            t += ds[nt][2 * half] * p[nt][2 * half] + ds[nt][2 * half + 1] * p[nt][2 * half + 1];
          t = quad_sum(t);
#pragma unroll
          for (int nt = 0; nt < LP / 8; ++nt) {
            const float2 code =
                *reinterpret_cast<const float2*>(sKey + e * LP + 8 * nt + 2 * tig);
            ds[nt][2 * half] =
                code.x > 0.f ? p[nt][2 * half] * (ds[nt][2 * half] - t) * scale : 0.f;
            ds[nt][2 * half + 1] =
                code.y > 0.f ? p[nt][2 * half + 1] * (ds[nt][2 * half + 1] - t) * scale : 0.f;
          }
        }
        frag_store<LP / 8, LDP>(p, sP + row0 * LDP);
        frag_store<LP / 8, LDP>(ds, sDS + row0 * LDP);
      }
      __syncthreads();                            // p and ds of the example's other queries
      float dq[HD / 8][4], dk[HD / 8][4], dv[HD / 8][4];
      frag_zero(dq);
      frag_zero(dk);
      frag_zero(dv);
      warp_mma<HD / 8, LP, LDP, LDQ, false, false>(dq, sDS + row0 * LDP, qkv_e + D + h * HD);
      warp_mma<HD / 8, LP, LDP, LDQ, true, false>(dk, sDS + e * LP * LDP + erow0,
                                                  qkv_e + h * HD);
      warp_mma<HD / 8, LP, LDP, LDX, true, false>(dv, sP + e * LP * LDP + erow0,
                                                  smem + S_Y1 + e * LP * LDX + h * HD);
      __syncthreads();                            // the head's q, k, v, p and ds are read
      frag_store<HD / 8, LDQ>(dq, sQKV + row0 * LDQ + h * HD);
      frag_store<HD / 8, LDQ>(dk, sQKV + row0 * LDQ + D + h * HD);
      frag_store<HD / 8, LDQ>(dv, sQKV + row0 * LDQ + 2 * D + h * HD);
      colsum_add(dq, sCol + V_BQKV + h * HD);
      colsum_add(dk, sCol + V_BQKV + D + h * HD);
      colsum_add(dv, sCol + V_BQKV + 2 * D + h * HD);
    }
    __syncthreads();                              // dq | dk | dv of every row

    // ---- qkv projection and dx
    // wqkv (D, 3D): rows 16 * (warp % 2).., columns 48 * (warp / 2)..
    wgrad_add<3 * D / 16, LDX, LDQ, 3 * D>(
        sPart + O_WQKV + (warp % 2) * 16 * 3 * D + (warp / 2) * (3 * D / 2),
        sX + (warp % 2) * 16, sQKV + (warp / 2) * (3 * D / 2));
    warp_mma<D / 8, 3 * D, LDQ, LDW_D, false, false>(dz1, sQKV + row0 * LDQ, smem + S_WQKVT);
    if (e < nb) {                                 // dx = dz1 + dqkv Wqkv^T
      const int l0 = erow0 + gid;
      float* dst = dx + ((long long)(b0 + e) * L) * D + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        if (l0 < L)
          *reinterpret_cast<float2*>(dst + (long long)l0 * D + 8 * nt) =
              make_float2(dz1[nt][0], dz1[nt][1]);
        if (l0 + 8 < L)
          *reinterpret_cast<float2*>(dst + (long long)(l0 + 8) * D + 8 * nt) =
              make_float2(dz1[nt][2], dz1[nt][3]);
      }
    }
  }

  // ---- the block's partial, once
  __syncthreads();
  for (int v = threadIdx.x; v < V_TOTAL; v += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += smem[S_COL + w * V_TOTAL + v];
    sPart[vec_to_flat(v)] = sum;
  }
  __syncthreads();
  float* dst = partial + (long long)blockIdx.x * O_TOTAL;
  for (int i = threadIdx.x; i < O_TOTAL; i += blockDim.x) dst[i] = sPart[i];
}

constexpr int kReduceWarps = 8, kReduceCols = 32;

// dflat[i] = the sum over the nblk partials: a block takes 32 elements, its
// warp w adds partials w, w + 8, ... in that order, and the warps' sums are
// added in warp order.
__global__ void __launch_bounds__(kReduceWarps * kReduceCols)
reduce_partials_kernel(const float* __restrict__ partial, float* __restrict__ dflat, int nblk,
                       int total) {
  __shared__ float sums[kReduceWarps][kReduceCols];
  const int warp = threadIdx.x / kReduceCols, lane = threadIdx.x % kReduceCols;
  const int i = blockIdx.x * kReduceCols + lane;
  float sum = 0.f;
  if (i < total)
    for (int b = warp; b < nblk; b += kReduceWarps) sum += partial[(long long)b * total + i];
  sums[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && i < total) {
    float all = 0.f;
#pragma unroll
    for (int w = 0; w < kReduceWarps; ++w) all += sums[w][lane];
    dflat[i] = all;
  }
}

}  // namespace

// Bytes of dynamic shared memory a block of the tiled backward takes.
extern "C" long long nrt_fused_block_tiled_bwd_smem_bytes() {
  return (long long)S_TOTAL * sizeof(float);
}

// As nrt_fused_block_tiled_fwd, with dy (B, L, 32) in; dx (B, L, 32) and dflat
// (the 12 parameter gradients, flat, 8,544 floats) out. Scratch: partial,
// nblk * 8,544 floats, written once a block. x 16-byte, dy and dx 8-byte
// aligned. Two launches: the tiles, then the sum of the partials.
extern "C" int nrt_fused_block_tiled_bwd(const float* x, const float* mask, const float* dy,
                                         const float* const* params, float* dx, float* dflat,
                                         float* partial, int B, int L, int nblk,
                                         cudaStream_t stream) {
  if (B <= 0 || L <= LP / 2 || L > LP || nblk <= 0 || nblk > (B + EX - 1) / EX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)S_TOTAL * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tiled_block_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  tiled_block_bwd_kernel<<<nblk, kThreads, bytes, stream>>>(x, mask, dy, make_params(params), dx,
                                                            partial, B, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<(O_TOTAL + kReduceCols - 1) / kReduceCols,
                           kReduceWarps * kReduceCols, 0, stream>>>(partial, dflat, nblk,
                                                                    O_TOTAL);
  return (int)cudaGetLastError();
}
