// Fused embedding lookup + masked mean pool, backward: the table's gradient
//   grad_table[ids[b,l]] += g[b] * w[b,l] / (sum_l w[b,l] + 1e-8),
//   w[b,l] = mask[b,l] * (ids[b,l] != 0),
// a dense (V, D) array, zero wherever no id points. Duplicates of an id,
// inside an example and across examples, add up; id 0 and masked slots
// (w == 0) add nothing; ids outside [0, V) are dropped.
//
// Replaces the backward of news_recsys_tpu/ops/fused_lookup_pool.py (_bwd,
// the custom VJP of the Pallas kernel _pool_pallas; an XLA scatter-add in
// JAX).
//
// What bounds it on the H100: memory. It must write V*D*4 bytes (4.2 MB for
// the item table at D 16) and read B*D gradients and B*L ids and masks;
// the sums are B*L*D adds. Blocks run concurrently, so a scatter-add needs
// either an order or an addition whose result does not depend on the
// order. A sort by id gives the order but costs more than the rest of the
// work at these sizes, and summing a run of one id in order makes the time
// follow the longest run (the first design: 47-157 us on Zipf ids). This
// design takes the other way: every term is added as an exact integer, so
// the order of the additions cannot change a bit of the result.
//   1. scan (a warp an example): the coefficient w / denom of each slot, and
//      for each table row touched, the exponent of its largest term
//      (atomicMax, an integer); the slot that touches a row first lends the
//      row its accumulator row, which the warp clears;
//   2. accumulate (a warp per 8-32 slots, lanes over (slot, column)): each
//      term becomes round(term * 2^(P - e)), e the row's exponent and P = 62
//      - bits(B*L) (the wrapper's fixed_point_bits), so that B*L terms cannot
//      overflow 63 bits; every load of the chunk is in flight before the
//      first term, a run of one row in a lane group's slots is added as one
//      integer, and each add is a 64-bit atomicAdd whose lanes cover a row's
//      columns (one coalesced request);
//   3. write (a block a tile of rows, 16-byte stores): every row of the
//      (V, D) gradient, zeros included, each touched one as sum * 2^(e - P)
//      (no memset of the output, and no float atomics).
// A term is kept to 2^-P of its row's largest term, a finer grain than a
// float32 sum of the same terms rounds to (2^-24 of the running sum), and two
// runs give the same bits whatever the scheduling. A term that is not
// finite (NaN, or +-inf) sets a flag instead; the row's column then reads
// NaN, or +-inf, as an IEEE sum in any order would.
// Launches: one memset of V ints and the three kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                 // warps a block (scan, accumulate)
constexpr int kThreads = kWarps * 32;
constexpr int kWriteThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// emax[row]: 0 untouched; kOnlyNonFinite: touched by terms that are not
// finite only; else frexp's exponent of the row's largest term + kBias
constexpr int kOnlyNonFinite = 1;
constexpr int kBias = 1100;
constexpr int kPosInf = 1, kNegInf = 2, kNaN = 4;

// 2^x as a double (x is an int; a power of two in the normal range is
// built from its bits)
__device__ __forceinline__ double pow2(int x) {
  return (x >= -1022 && x <= 1023) ? __longlong_as_double((long long)(x + 1023) << 52)
                                   : ldexp(1.0, x);
}

// One warp an example: the coefficient of every slot (0 where the slot adds
// nothing), and the touch of every row the example's slots add to.
__global__ void __launch_bounds__(kThreads)
pool_bwd_scan_kernel(const int* __restrict__ ids, const float* __restrict__ mask,
                     const float* __restrict__ g, float* __restrict__ coef,
                     int* __restrict__ emax, int* __restrict__ index,
                     long long* __restrict__ acc, int* __restrict__ flags, int B, int L, int D,
                     int V) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                                    // warp-uniform
  const int* idr = ids + b * L;
  const float* mr = mask + b * L;
  const float* gr = g + b * D;
  float gmax = 0.f, wsum = 0.f;       // the largest finite |g[b]|; sum_l w
  int gbad = 0;                       // a g[b] that is not finite
  for (int d = lane; d < D; d += 32) {
    const float v = gr[d];
    if (isfinite(v)) gmax = fmaxf(gmax, fabsf(v));
    else gbad = 1;
  }
  for (int l = lane; l < L; l += 32) {
    const float m = mr[l];                               // not waiting for the id
    wsum += idr[l] != 0 ? m : 0.f;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gmax = fmaxf(gmax, __shfl_xor_sync(kFull, gmax, o));
    wsum += __shfl_xor_sync(kFull, wsum, o);
  }
  gbad = __any_sync(kFull, gbad);
  const float denom = wsum + 1e-8f;
  for (int l0 = 0; l0 < L; l0 += 32) {                   // warp-uniform
    const int l = l0 + lane;
    const int id = l < L ? idr[l] : 0;
    const float m = l < L ? mr[l] : 0.f;
    const float w = id != 0 ? m : 0.f;
    const bool adds = w != 0.f && id > 0 && id < V;      // NaN != 0: a NaN weight adds
    const float c = adds ? w / denom : 0.f;
    if (l < L) coef[b * L + l] = c;
    // every finite term c * g[b,d] is at most t (rounding is monotonic)
    const double t = fabs((double)c) * (double)gmax;
    int touch = 0;
    if (adds && isfinite(t) && t > 0.0) {
      touch = (int)((__double_as_longlong(t) >> 52) & 0x7ff) - 1022 + kBias;  // t < 2^e
    } else if (adds && (!isfinite(c) || gbad)) {
      touch = kOnlyNonFinite;
    }
    // the row's first touch: its slot's accumulator row becomes the row's,
    // and the warp clears each such row
    const bool first = touch != 0 && atomicMax(emax + id, touch) == 0;
    if (first) index[id] = (int)(b * L + l);
    for (unsigned m = __ballot_sync(kFull, first); m; m &= m - 1) {
      const long long at = (b * L + l0 + __ffs(m) - 1) * D;
      for (int d = lane; d < D; d += 32) {
        acc[at + d] = 0;
        flags[at + d] = 0;
      }
    }
  }
}

__device__ __forceinline__ int nonfinite_flag(float x) {
  return isnan(x) ? kNaN : (x > 0.f ? kPosInf : kNegInf);
}

// A warp per chunk of STEPS * G slots, TD lanes a slot (a power of two, TD
// >= D when D <= 32; columns d, d + 32, ... above), G = 32 / TD slots at
// once (8 slots a warp at D 16: a short chain a warp beats fewer warps). Every id, coefficient, row state and g value of the chunk is loaded
// before the first term is formed; a group walks its slots in order and
// adds the run of its current row as one integer, so a run of one id costs
// one coalesced atomicAdd (TD lanes, one row) however long it is.
template <int TD, int STEPS>
__global__ void __launch_bounds__(kThreads)
pool_bwd_accumulate_kernel(const int* __restrict__ ids, const float* __restrict__ g,
                           const float* __restrict__ coef, const int* __restrict__ emax,
                           const int* __restrict__ index, unsigned long long* __restrict__ acc,
                           int* __restrict__ flags, int S, int L, int D, int V, int P) {
  constexpr int G = 32 / TD;
  const int lane = threadIdx.x & 31, grp = lane / TD, t = lane % TD;
  const long long first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (G * STEPS);
  if (first >= S) return;                                // warp-uniform
  // three rounds of loads, each issued whole: ids and coefficients; then the
  // rows' exponents and accumulator indices beside the first columns of g
  int b[STEPS], row[STEPS];
  float c[STEPS];
  double scale[STEPS];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    const long long s = first + i * G + grp;
    const int si = s < S ? (int)s : 0;
    const int id = s < S ? ids[si] : 0;
    c[i] = s < S ? coef[si] : 0.f;
    b[i] = si / L;
    row[i] = c[i] != 0.f && id > 0 && id < V ? id : -1;
  }
  int st[STEPS], at[STEPS];
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    st[i] = row[i] >= 0 ? emax[row[i]] : 0;
    at[i] = row[i] >= 0 ? index[row[i]] : 0;             // read only where st != 0
  }
  for (int d0 = 0; d0 < D; d0 += TD) {
    const int d = d0 + t;
    const bool col = d < D;
    float gv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) gv[i] = row[i] >= 0 && col ? g[(long long)b[i] * D + d] : 0.f;
    if (d0 == 0) {
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        scale[i] = st[i] > kOnlyNonFinite ? pow2(P - (st[i] - kBias)) : 0.0;
        row[i] = st[i] != 0 ? at[i] : -1;                // the row's accumulator, or none
      }
    }
    long long run = 0;
    int run_row = -1, f = 0;
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      if (row[i] < 0) continue;
      if (row[i] != run_row) {
        if (run_row >= 0 && col) {
          atomicAdd(acc + (long long)run_row * D + d, (unsigned long long)run);
          if (f) atomicOr(flags + (long long)run_row * D + d, f);
        }
        run_row = row[i];
        run = 0;
        f = 0;
      }
      const float term = c[i] * gv[i];
      if (isfinite(term)) run += __double2ll_rn((double)term * scale[i]);   // |.| <= 2^P
      else f |= nonfinite_flag(term);
    }
    if (run_row >= 0 && col) {
      atomicAdd(acc + (long long)run_row * D + d, (unsigned long long)run);
      if (f) atomicOr(flags + (long long)run_row * D + d, f);
    }
  }
}

// Every row of the (V, D) gradient, zeros included: a block a tile of rows,
// a thread W consecutive columns of a row (W = 4, 16-byte stores, when D %
// 4 == 0 and the output is 16-byte aligned; else 1).
template <int W>
__global__ void __launch_bounds__(kWriteThreads)
pool_bwd_write_kernel(const int* __restrict__ emax, const int* __restrict__ index,
                      const long long* __restrict__ acc, const int* __restrict__ flags,
                      float* __restrict__ grad, int V, int D, int P) {
  const int groups = D / W;                              // column groups a row
  const int rows = groups < kWriteThreads ? kWriteThreads / groups : 1;   // rows a block
  for (int k = threadIdx.x; k < rows * groups; k += kWriteThreads) {
    const int dr = k / groups;
    const long long r = (long long)blockIdx.x * rows + dr;
    if (r >= V) break;
    const int d = (k - dr * groups) * W;
    const int st = __ldg(emax + r);
    float out[W];
#pragma unroll
    for (int u = 0; u < W; ++u) out[u] = 0.f;
    const long long at = (long long)__ldg(index + r) * D + d;   // read only where st != 0
    if (st != 0) {
      const double scale = pow2(st - kBias - P);
#pragma unroll
      for (int u = 0; u < W; ++u) {
        const int f = flags[at + u];
        if (f != 0) {
          out[u] = ((f & kNaN) || ((f & kPosInf) && (f & kNegInf))) ? NAN
                   : (f & kPosInf) ? INFINITY : -INFINITY;
        } else if (st != kOnlyNonFinite) {
          out[u] = (float)((double)acc[at + u] * scale);
        }
      }
    }
    float* dst = grad + r * D + d;
    if (W == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(out[0], out[1 % W], out[2 % W], out[3 % W]);
    } else {
#pragma unroll
      for (int u = 0; u < W; ++u) dst[u] = out[u];
    }
  }
}

}  // namespace

// ids (B, L) int32, mask (B, L) float32, g (B, D) float32 -> grad_table (V,
// D) float32. Scratch, uninitialised: state (2V) int32 (the rows' exponents
// and accumulator indices), coef (B*L) float32, acc (B*L * D) int64 and flags
// (the same count) int32, an accumulator row a slot. All
// contiguous, on the device; B*L < 2^31; P = 62 - bits(B*L). Returns the
// cudaError_t of the launches.
extern "C" int nrt_lookup_pool_bwd(const int* ids, const float* mask, const float* g,
                                   float* grad_table, int* state, float* coef, long long* acc,
                                   int* flags, int B, int L, int D, int V, int P,
                                   cudaStream_t stream) {
  if (V <= 0 || D <= 0) return (int)cudaSuccess;
  int* emax = state;
  int* index = state + V;
  cudaError_t err = cudaMemsetAsync(emax, 0, (size_t)V * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int S = B * L;
  if (S > 0) {
    pool_bwd_scan_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        ids, mask, g, coef, emax, index, acc, flags, B, L, D, V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    unsigned long long* acc_u = reinterpret_cast<unsigned long long*>(acc);
#define NRT_ACCUMULATE(TD, STEPS)                                                              \
  pool_bwd_accumulate_kernel<TD, STEPS>                                                        \
      <<<(unsigned)(((long long)S + kWarps * (32 / TD) * STEPS - 1) /                        \
                    (kWarps * (32 / TD) * STEPS)), kThreads, 0, stream>>>(ids, g, coef, emax, index, acc_u, flags, S, L, D, V, P)
    if (D <= 1) NRT_ACCUMULATE(1, 1);
    else if (D <= 2) NRT_ACCUMULATE(2, 2);
    else if (D <= 4) NRT_ACCUMULATE(4, 4);
    else if (D <= 8) NRT_ACCUMULATE(8, 8);
    else if (D <= 16) NRT_ACCUMULATE(16, 4);
    else NRT_ACCUMULATE(32, 4);
#undef NRT_ACCUMULATE
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = D % 4 == 0 && ((uintptr_t)grad_table & 15) == 0;
  const int groups = vec ? D / 4 : D;
  const int rows = groups < kWriteThreads ? kWriteThreads / groups : 1;
  const unsigned blocks = (unsigned)(((long long)V + rows - 1) / rows);
  if (vec) {
    pool_bwd_write_kernel<4><<<blocks, kWriteThreads, 0, stream>>>(emax, index, acc, flags,
                                                                   grad_table, V, D, P);
  } else {
    pool_bwd_write_kernel<1><<<blocks, kWriteThreads, 0, stream>>>(emax, index, acc, flags,
                                                                   grad_table, V, D, P);
  }
  return (int)cudaGetLastError();
}
