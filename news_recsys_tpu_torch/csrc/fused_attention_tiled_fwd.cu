// The fused Transformer block's forward, tiled route (see fused_attention.cu
// for the function and the general route, fused_attention_tiled.cuh for the
// tile, the fragment layout and the 3xTF32 products).
//
// Replaces the Pallas kernel news_recsys_tpu/ops/fused_attention.py::
// _fused_fwd_call (body _fwd_kernel) at the attention ranker's widths
// (16 < L <= 32, D 32, F 64, heads of 16).
//
// What bounds it on the H100: at batch 6,400 the bytes (x in, y out: 49 MB,
// 14.7 us at 3.35 TB/s) just above the operations on the tensor cores (3.88
// GFLOP, 7.8 us at the TF32 rate of 495 TFLOP/s); in fact the latency of one
// tile's chain of dependent phases, so the design keeps as many warps on an
// SM as shared memory allows:
//   - a persistent block (three an SM: 73 KB each) stages the 12 parameters
//     in shared memory once (cp.async, padded strides) and then walks tiles
//     of two examples; no weight is read from device memory inside a product;
//   - a warp fetches its own 16 rows of x with cp.async (while the other
//     warps and blocks compute) and asks for the next tile's to be brought to
//     L2; the tile's buffers are reused in place: ao and then y1 take x's
//     rows (x's residual waits in registers), p takes q's columns once the
//     scores of both heads are in registers, relu(pre) takes q | k | v;
//   - every product is mma.sync m16n8k8 in 3xTF32; bias, residual, LayerNorm
//     and ReLU are epilogues on the accumulators;
//   - attention: a warp takes its 16 queries against the 32 keys of its
//     example; the softmax runs on the score fragments in registers;
//   - three block-wide barriers a tile: the tile before has read its
//     relu(pre), k and v of the pair of warps that share an example are
//     written, and they are read.

#include "fused_attention_tiled.cuh"

namespace {

using namespace tiled;

// shared memory, in floats
constexpr int S_WQKV = 0;
constexpr int S_WO = S_WQKV + D * LDW_QKV;
constexpr int S_W1 = S_WO + D * LDW_D;
constexpr int S_W2 = S_W1 + D * LDW_F;
constexpr int S_VEC = S_W2 + F * LDW_D;
constexpr int S_X = S_VEC + V_TOTAL;            // x, then ao, then y1
constexpr int S_QKV = S_X + TM * LDX;           // q | k | v (p in q's place), then relu(pre)
constexpr int S_KEY = S_QKV + TM * LDQ;         // the example's key codes, a copy a warp
constexpr int S_TOTAL = S_KEY + kWarps * LP;
constexpr int kBlocksPerSm = 3;
static_assert(LDH <= LDQ, "relu(pre) takes the place of q | k | v");
static_assert(kBlocksPerSm * (S_TOTAL * sizeof(float) + 1024) <= 228 * 1024, "blocks an SM");

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
tiled_block_fwd_kernel(const float* __restrict__ x, const float* __restrict__ mask, Params P,
                       float* __restrict__ out, int B, int L) {
  extern __shared__ __align__(16) float smem[];
  float* sVec = smem + S_VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int e = warp / (LP / 16);                 // the warp's example in the tile
  const int row0 = 16 * warp, erow0 = row0 % LP;
  float* sXw = smem + S_X + row0 * LDX;           // the warp's rows
  float* sQw = smem + S_QKV + row0 * LDQ;
  float* sHw = smem + S_QKV + row0 * LDH;
  float* sKey = smem + S_KEY + warp * LP;
  const float* qkv_e = smem + S_QKV + e * LP * LDQ;   // the example's slot
  const float scale = 1.0f / sqrtf((float)HD);
  const int tiles = (B + EX - 1) / EX;

  stage_kernel(smem + S_WQKV, LDW_QKV, P.wqkv, D, 3 * D);
  stage_kernel(smem + S_WO, LDW_D, P.wo, D, D);
  stage_kernel(smem + S_W1, LDW_F, P.w1, D, F);
  stage_kernel(smem + S_W2, LDW_D, P.w2, F, D);
  stage_vectors(sVec, P);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile * EX + e;                  // the warp's example
    const bool present = b < B;
    // the warp's 16 rows of x (its rows of the buffer were last read by itself);
    // rows >= L and an example that the batch does not have are zero
    __syncwarp();
    for (int i = lane; i < 16 * (D / 4); i += 32) {
      const int r = i / (D / 4), c = i % (D / 4), l = erow0 + r;
      float* dst = sXw + r * LDX + 4 * c;
      if (present && l < L) cp_async16(dst, x + ((long long)b * L + l) * D + 4 * c);
      else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    cp_async_commit();
    {
      float code = -1.f;                          // see masked_score
      if (lane < L) code = (present && __ldg(mask + (long long)b * L + lane) > 0.f) ? 1.f : 0.f;
      sKey[lane] = code;
      const int nb = tile + gridDim.x;            // the next tile's rows on their way to L2
      if (nb < tiles && nb * EX + e < B && lane < 16 && erow0 + lane < L)
        prefetch_l2(x + ((long long)(nb * EX + e) * L + erow0 + lane) * D);
    }
    cp_async_wait_all();
    __syncwarp();

    float res[D / 8][4];                          // x, for the residual
    {   // q | k | v
      float acc[3 * D / 8][4];
      frag_fill(acc, sVec + V_BQKV);
      warp_mma<3 * D / 8, D, LDX, LDW_QKV, false, false>(acc, sXw, smem + S_WQKV);
      frag_load<D / 8, LDX>(res, sXw);
      __syncthreads();                            // the tile before has read its relu(pre)
      frag_store<3 * D / 8, LDQ>(acc, sQw);
    }
    __syncthreads();                              // the other warp's k and v
    {
      float p[H][LP / 8][4];
#pragma unroll
      for (int h = 0; h < H; ++h) {               // the scores of every head, then q is free
        frag_zero(p[h]);
        warp_mma<LP / 8, HD, LDQ, LDQ, false, true>(p[h], sQw + h * HD, qkv_e + D + h * HD);
        frag_softmax(p[h], sKey, scale);
      }
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float o[HD / 8][4];
        __syncwarp();
        frag_store<LP / 8, LDQ>(p[h], sQw);       // p in the place of the warp's q
        __syncwarp();
        frag_zero(o);
        warp_mma<HD / 8, LP, LDQ, LDQ, false, false>(o, sQw, qkv_e + 2 * D + h * HD);
        frag_store<HD / 8, LDX>(o, sXw + h * HD); // ao in the place of the warp's x
      }
    }
    __syncthreads();                              // k and v are read: relu(pre) may take their place

    float y1[D / 8][4];
    {   // z1 = x + ao Wo + bo; y1 = LN(z1) g1 + b1
      float z[D / 8][4], inv[2];
      frag_fill(z, sVec + V_BO);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] += res[nt][j];
      warp_mma<D / 8, D, LDX, LDW_D, false, false>(z, sXw, smem + S_WO);
      frag_layer_norm(z, inv);
      frag_affine(y1, z, sVec + V_G1, sVec + V_B1);
      __syncwarp();
      frag_store<D / 8, LDX>(y1, sXw);            // ao is read: y1 takes its place
      __syncwarp();
    }
    {   // relu(y1 W1 + c1)
      float acc[F / 8][4];
      frag_fill(acc, sVec + V_C1);
      warp_mma<F / 8, D, LDX, LDW_F, false, false>(acc, sXw, smem + S_W1);
#pragma unroll
      for (int nt = 0; nt < F / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[nt][j] = fmaxf(acc[nt][j], 0.f);
      frag_store<F / 8, LDH>(acc, sHw);
      __syncwarp();
    }
    {   // z2 = y1 + h W2 + c2; y2 = LN(z2) g2 + b2, to device memory
      float z[D / 8][4], y2[D / 8][4], inv[2];
      frag_fill(z, sVec + V_C2);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[nt][j] += y1[nt][j];
      warp_mma<D / 8, F, LDH, LDW_D, false, false>(z, sHw, smem + S_W2);
      frag_layer_norm(z, inv);
      frag_affine(y2, z, sVec + V_G2, sVec + V_B2);
      if (present) {
        const int l0 = erow0 + gid;
        float* dst = out + ((long long)b * L) * D + 2 * tig;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          if (l0 < L)
            *reinterpret_cast<float2*>(dst + (long long)l0 * D + 8 * nt) =
                make_float2(y2[nt][0], y2[nt][1]);
          if (l0 + 8 < L)
            *reinterpret_cast<float2*>(dst + (long long)(l0 + 8) * D + 8 * nt) =
                make_float2(y2[nt][2], y2[nt][3]);
        }
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory a block of the tiled forward takes.
extern "C" long long nrt_fused_block_tiled_fwd_smem_bytes() {
  return (long long)S_TOTAL * sizeof(float);
}

// x (B, L, 32), mask (B, L), params as nrt_fused_block_fwd, out (B, L, 32);
// float32, contiguous, x and out 16-byte aligned; 16 < L <= 32, two heads of
// 16, F 64. 1 <= nblk <= ceil(B / 2) blocks share the tiles of two examples.
// Returns the cudaError_t of the launch.
extern "C" int nrt_fused_block_tiled_fwd(const float* x, const float* mask,
                                         const float* const* params, float* out, int B, int L,
                                         int nblk, cudaStream_t stream) {
  if (B <= 0 || L <= LP / 2 || L > LP || nblk <= 0 || nblk > (B + EX - 1) / EX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)S_TOTAL * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      tiled_block_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  tiled_block_fwd_kernel<<<nblk, kThreads, bytes, stream>>>(x, mask, make_params(params), out,
                                                            B, L);
  return (int)cudaGetLastError();
}
