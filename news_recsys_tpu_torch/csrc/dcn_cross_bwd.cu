// DCN-v1 cross stack, backward. With g the gradient of the stack's output,
// for l = NL-1 .. 0:
//   ds_l = sum_d g . x0          (per row)
//   dw_l += x_l * ds_l ;  db_l += g      (summed over the batch)
//   dx0_extra += g * s_l
//   g += w_l * ds_l              (the gradient of x_l)
// and finally dx0 = g + dx0_extra. ss (NL, B) holds the forward's s_l
// (dcn_cross.cu); x_l is rebuilt from x0, ss and bs by the forward's own
// recurrence (dcn_cross.cuh::cross_step), bit for bit, so the forward writes
// no (NL, B, D) residual and this kernel reads none.
//
// Replaces the backward of news_recsys_tpu/ops/dcn_kernel.py (_bwd, the
// custom VJP of the Pallas kernel _cross_pallas; XLA code in JAX).
//
// What bounds it on the H100: at B 512, D 112 it moves 0.7 MB, 0.2 us at
// full bandwidth; what it costs is latency: a chain of dependent steps per
// row, and sums over the whole batch for dw and db, which no block holds.
// The design, two launches:
//   - rows (dcn_cross_bwd_rows_kernel): one chunk a lane (dcn_cross.cuh; D
//     112: a float4 on each of 32 lanes), since a lane's chain of steps is
//     what a row waits on when an SM has few warps (with 8 lanes of 4 float4s
//     the one-launch backward took 8.92 us against 7.03 on an NVIDIA H100
//     80GB HBM3, 700 W); every load of a row (x0, g, its NL scalars s_l, one
//     a lane) is issued before its first shuffle, and the weights come in
//     beside them by cp.async. The ds_l are taken top-down (they need only g,
//     x0 and w), then x_l is rebuilt bottom-up for dw_l += x_l ds_l; lane l
//     of a row holds s_l and ds_l and a layer reads them by shuffle, so the
//     layer loops stay loops (NL <= the row's lanes, 32);
//   - batch sums on chip: each warp adds its rows' dw/db terms into its own
//     row of shared memory (the first row stores, so nothing is zeroed), and
//     the block sums its warps' rows in warp order and writes that partial
//     (2*NL*D floats) to device memory, one a block in block order; with one
//     block the partial is the answer and there is no second launch;
//   - sums (dcn_cross_bwd_sum_kernel): kSumBlocks blocks share the columns;
//     in each, the threads split the partials into runs of consecutive
//     blocks, add each run in block order with kBatch loads in flight, and
//     add the runs' sums in run order (split_sum), and write dws/dbs.
// Every sum is taken in an order fixed by the plan, so two runs give the same
// bits and a CUDA-graph replay equals an eager call; nothing is carried from
// one call to the next (no counter, no memset). The sum kernel is launched by
// programmatic dependent launch: the rows kernel lets it start once every
// block has written its partial, and it waits for the rows kernel's memory
// with griddepcontrol.wait, so its launch overlaps the rows kernel's tail.
// On an NVIDIA H100 80GB HBM3 (700 W; chip_profile.py --cross-split, two
// runs) that measured 5.51-5.53 us at B 512 against 5.76-5.87 for a plain
// second launch, bit for bit the same, eager and in a CUDA graph.
//
// A single launch (blocks in clusters summed through distributed shared
// memory, the last cluster at an arrival counter summing the cluster
// partials) was slower than two launches in every run on the same card:
// 6.76-6.79 us at B 512 against these two launches' 5.18-5.21, in turns in
// one run of chip_smoke.py each; each wait on other SMs inside a kernel cost
// about a microsecond, more than the second launch's gap.

#include "dcn_cross.cuh"

namespace {

using namespace dcn;

constexpr int kMaxSharedBytes = 232448;  // a block's shared memory on the H100
constexpr int kBatch = 8;                // loads in flight a thread in the sums
constexpr int kMaxWarps = 16;
constexpr int kSumBlocks = 8;            // the sum kernel's blocks: a share of the columns each
constexpr int kSumThreads = 256;

// v summed over the warp's 32 / G groups (an xor butterfly: every group gets
// the same bits), then stored by group gq for its slots k with k % (32 / G)
// == gq into the warp's accumulator row acc: stored by the warp's first
// rows, added by the next ones
template <int VW, int G, int S>
__device__ __forceinline__ void warp_accumulate(float* acc, const float (&v)[S][VW], int sub,
                                                int gq, int nchunk, bool fresh) {
  float t[S][VW];
#pragma unroll
  for (int k = 0; k < S; ++k) {
#pragma unroll
    for (int j = 0; j < VW; ++j) t[k][j] = v[k][j];
  }
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) t[k][j] += __shfl_xor_sync(kFull, t[k][j], o);
    }
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int c = sub + k * G;
    if (k % (32 / G) != gq || c >= nchunk) continue;
    float* p = acc + c * VW;
    if (!fresh) {
      float o[VW];
      load<VW>(o, p);
#pragma unroll
      for (int j = 0; j < VW; ++j) t[k][j] = __fadd_rn(o[j], t[k][j]);
    }
    store<VW>(p, t[k]);
  }
}

// VW floats at p from L2, past the SM's L1: partials that other SMs wrote
template <int VW>
__device__ __forceinline__ void load_l2(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    r[0] = __ldcg(p);
  }
}

// sum_{q < n} src(q) in q order, kBatch loads in flight at a time
template <int VW, typename Src>
__device__ __forceinline__ void ordered_sum(float (&a)[VW], int n, Src src) {
  for (int q0 = 0; q0 < n; q0 += kBatch) {
    float t[kBatch][VW];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q0 + q < n) src(t[q], q0 + q);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (q0 + q >= n) break;
#pragma unroll
      for (int j = 0; j < VW; ++j) a[j] = q0 + q == 0 ? t[q][j] : __fadd_rn(a[j], t[q][j]);
    }
  }
}

// dst(e, sum_{q < P} src[q*E + e]) for the chunks e of [lo, hi), by the
// whole block: each thread sums a run of partials in q order, and the runs'
// sums are added in run order (a fixed order, so the bits repeat); scratch
// holds blockDim.x * VW floats
template <int VW, typename Dst>
__device__ __forceinline__ void split_sum(const float* src, int P, int E, int lo, int hi,
                                          float* scratch, Dst dst) {
  const int n = (hi - lo) / VW;
  for (int base = 0; base < n; base += blockDim.x) {      // the same trips in every thread
    const int m = min((int)blockDim.x, n - base);
    const int runs = max(1, min(P, (int)blockDim.x / m));
    const int len = (P + runs - 1) / runs;
    const int c = threadIdx.x % m, run = threadIdx.x / m;
    const int e = lo + (base + c) * VW;
    if (run < runs) {
      const int q0 = min(P, run * len), q1 = min(P, q0 + len);
      float a[VW];
#pragma unroll
      for (int j = 0; j < VW; ++j) a[j] = 0.f;
      if (q1 > q0)
        ordered_sum<VW>(a, q1 - q0, [&](float (&t)[VW], int q) {
          load_l2<VW>(t, src + (long long)(q0 + q) * E + e);
        });
      store<VW>(scratch + (run * m + c) * VW, a);
    }
    __syncthreads();
    if (threadIdx.x < m) {
      float a[VW];
      ordered_sum<VW>(a, runs,
                      [&](float (&t)[VW], int r) { load<VW>(t, scratch + (r * m + c) * VW); });
      dst(e, a);
    }
    __syncthreads();
  }
}

// the chunk of dw (NL, D) then db (NL, D) at e into dws or dbs
template <int VW>
__device__ __forceinline__ void store_grads(float* dws, float* dbs, int ND, int e,
                                            const float (&a)[VW]) {
  store<VW>(e < ND ? dws + e : dbs + (e - ND), a);
}

template <int VW, int G, int S>
__global__ void __launch_bounds__(kMaxWarps * 32)
dcn_cross_bwd_rows_kernel(const float* __restrict__ x0, const float* __restrict__ ws,
                          const float* __restrict__ bs, const float* __restrict__ ss,
                          const float* __restrict__ g, float* __restrict__ dx0,
                          float* __restrict__ dws, float* __restrict__ dbs,
                          float* __restrict__ partial, int B, int D, int NL) {
  constexpr int R = 32 / G;                      // rows a warp
  // ws (NL, D) and bs (NL, D), then an accumulator row of E = 2*NL*D floats
  // a warp: dw (NL, D), then db (NL, D)
  extern __shared__ __align__(16) float smem[];
  const int ND = NL * D;
  const int E = 2 * ND;
  const int nchunk = D / VW;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int sub = threadIdx.x & (G - 1);
  const int gq = (threadIdx.x & 31) / G;
  float* sw = smem;
  float* rows = smem + E;
  float* dw_acc = rows + warp * E;
  float* db_acc = dw_acc + ND;

  // group gq of warp w of block b takes rows (b*warps + w)*R + gq + i*stride;
  // a warp runs while any of its groups has a row (its shuffles take all 32
  // lanes); rows past the batch add zeros
  const long long stride = (long long)gridDim.x * warps * R;
  const long long warp_row0 = ((long long)blockIdx.x * warps + warp) * R;
  // a row's scalars live in its own lanes: lane l of the group holds s_l
  // (and, once taken, ds_l), and a layer reads them with a shuffle (G >= NL)
  float a0[S][VW], gg[S][VW], s_mine;
  auto load_inputs = [&](long long row, bool live) {
    const long long base = (live ? row : 0) * D;
    load_row<VW, G, S>(a0, x0 + base, sub, nchunk, live);
    load_row<VW, G, S>(gg, g + base, sub, nchunk, live);
    s_mine = (sub < NL && live) ? ss[(long long)sub * B + row] : 0.f;
  };
  load_inputs(warp_row0 + gq, warp_row0 + gq < B);   // the kernel's first loads
  stage_weights<VW>(sw, ws, bs, ND);
  weights_ready();

  // a row's dx0 is stored while the next row is worked on
  float dx[S][VW];
  long long dx_base = -1;
  auto store_dx = [&]() {
    if (dx_base < 0) return;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (sub + k * G < nchunk) store<VW>(dx0 + dx_base + (sub + k * G) * VW, dx[k]);
  };
  bool fresh = true;
  for (long long i = 0; warp_row0 + i * stride < B; ++i) {
    const long long row = warp_row0 + gq + i * stride;
    const bool live = row < B;
    if (i > 0) {
      load_inputs(row, live);
      store_dx();
    }
    float ex[S][VW], ds_mine = 0.f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) ex[k][j] = 0.f;
    }

    // top-down: ds_l, db_l, dx0's extra term and the gradient of x_l
    for (int l = NL - 1; l >= 0; --l) {            // NL is the same in every lane
      float w[S][VW];
      load_row<VW, G, S>(w, sw + l * D, sub, nchunk, true);
      const float s_l = __shfl_sync(kFull, s_mine, l, G);
      const float d = group_sum<G>(dot<VW, S>(gg, a0));
      if (sub == l) ds_mine = d;
      warp_accumulate<VW, G, S>(db_acc + l * D, gg, sub, gq, nchunk, fresh);
#pragma unroll
      for (int k = 0; k < S; ++k) {
#pragma unroll
        for (int j = 0; j < VW; ++j) {
          ex[k][j] = __fmaf_rn(gg[k][j], s_l, ex[k][j]);
          gg[k][j] = __fmaf_rn(w[k][j], d, gg[k][j]);
        }
      }
    }

    // bottom-up: x_l rebuilt as the forward made it, dw_l += x_l ds_l
    float x[S][VW];
#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) x[k][j] = a0[k][j];
    }
    for (int l = 0; l < NL; ++l) {
      const float d = __shfl_sync(kFull, ds_mine, l, G);
      const float s_l = __shfl_sync(kFull, s_mine, l, G);
      float t[S][VW];
#pragma unroll
      for (int k = 0; k < S; ++k) {
#pragma unroll
        for (int j = 0; j < VW; ++j) t[k][j] = __fmul_rn(x[k][j], d);
      }
      warp_accumulate<VW, G, S>(dw_acc + l * D, t, sub, gq, nchunk, fresh);
      if (l + 1 < NL && live) {                  // a row past the batch keeps x = 0
        float b[S][VW];
        load_row<VW, G, S>(b, sw + ND + l * D, sub, nchunk, true);
        cross_step<VW, S>(x, a0, s_l, b);
      }
    }

#pragma unroll
    for (int k = 0; k < S; ++k) {
#pragma unroll
      for (int j = 0; j < VW; ++j) dx[k][j] = __fadd_rn(gg[k][j], ex[k][j]);
    }
    dx_base = live ? row * D : -1;
    fresh = false;
  }
  store_dx();
  if (fresh) {                                     // a warp that got no row
    const float zero[VW] = {};
    for (int e = (threadIdx.x & 31) * VW; e < E; e += 32 * VW) store<VW>(dw_acc + e, zero);
  }
  __syncthreads();

  // the block's partial, its warps' rows summed in warp order, to device
  // memory in block order (with one block, it is the answer)
  const bool alone = gridDim.x == 1;
  for (int e = threadIdx.x * VW; e < E; e += blockDim.x * VW) {
    float a[VW];
    ordered_sum<VW>(a, warps, [&](float (&t)[VW], int q) { load<VW>(t, rows + q * E + e); });
    if (alone) {
      store_grads<VW>(dws, dbs, ND, e, a);
    } else {
      store<VW>(partial + (long long)blockIdx.x * E + e, a);
    }
  }
  // the sum kernel may start (under programmatic dependent launch); it waits
  // for this grid's memory before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// dws/dbs: the P block partials summed; each block takes a share of the
// columns
template <int VW>
__global__ void __launch_bounds__(kSumThreads)
dcn_cross_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dws,
                         float* __restrict__ dbs, int P, int ND) {
  __shared__ __align__(16) float scratch[kSumThreads * VW];
  // every partial of the rows kernel is written and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int E = 2 * ND;
  const int per = (E / VW + gridDim.x - 1) / gridDim.x * VW;
  const int lo = min(E, (int)blockIdx.x * per), hi = min(E, lo + per);
  split_sum<VW>(partial, P, E, lo, hi, scratch,
                [&](int e, const float (&a)[VW]) { store_grads<VW>(dws, dbs, ND, e, a); });
}

// a launch's error, also where a refused call left it as the runtime's last
// one (taken, so that the next launch does not report it again)
cudaError_t launch_error(cudaError_t err) {
  const cudaError_t last_error = cudaGetLastError();
  return err != cudaSuccess ? err : last_error;
}

template <int VW, int G, int S>
cudaError_t launch(const float* x0, const float* ws, const float* bs, const float* ss,
                   const float* g, float* dx0, float* dws, float* dbs, float* partial, int B,
                   int D, int NL, int warps, int blocks, cudaStream_t stream) {
  const size_t smem = (size_t)(warps + 1) * 2 * NL * D * sizeof(float);
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  auto rows_kernel = dcn_cross_bwd_rows_kernel<VW, G, S>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    rows_kernel<<<blocks, warps * 32, smem, stream>>>(x0, ws, bs, ss, g, dx0, dws, dbs, partial,
                                                      B, D, NL);
  err = launch_error(err);
  if (err != cudaSuccess || blocks == 1) return err;
  const int ND = NL * D;
  // the sum kernel may start while the rows kernel's blocks end
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * ND / VW < kSumBlocks ? 2 * ND / VW : kSumBlocks);
  config.blockDim = dim3(kSumThreads);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return launch_error(cudaLaunchKernelEx(&config, dcn_cross_bwd_sum_kernel<VW>,
                                         (const float*)partial, dws, dbs, blocks, ND));
}

}  // namespace

// x0 (B, D), ws (NL, D), bs (NL, D), ss (NL, B), g (B, D) in; dx0 (B, D), dws
// (NL, D), dbs (NL, D) out; partial (blocks, 2, NL, D) scratch, uninitialised
// (none with one block: ops/dcn_kernel.py::cross_partials). All float32,
// contiguous, on the device. The launch is the wrapper's plan (ops/
// dcn_kernel.py::plan_cross): vector (1: float4 chunks, which needs D % 4 ==
// 0 and x0, ws, bs, g, dx0, dws, dbs, partial 16-byte aligned), group (lanes
// a row) and slots (chunks a lane), one of NRT_CROSS_BWD_LAYOUTS with group *
// slots chunks covering a row, warps a block (1-16) and blocks (any number >=
// 1: rows are spread over them); 1 <= NL <= group, and (warps + 1) * 2*NL*D
// floats of shared memory must fit a block (227 KB). Two launches on stream
// (one with one block). Returns the cudaError_t of the launches.
extern "C" int nrt_dcn_cross_bwd(const float* x0, const float* ws, const float* bs,
                                 const float* ss, const float* g, float* dx0, float* dws,
                                 float* dbs, float* partial, int B, int D, int NL, int vector,
                                 int group, int slots, int warps, int blocks,
                                 cudaStream_t stream) {
  const int vw = vector ? 4 : 1;
  if (D <= 0 || NL < 1 || NL > group || warps < 1 || warps > kMaxWarps || blocks < 1 ||
      (vector && D % 4 != 0) || (long long)group * slots < D / vw)
    return (int)cudaErrorInvalidValue;
#define NRT_CROSS_BWD_CASE(VW_, G_, S_)                                                     \
  if (vw == VW_ && group == G_ && slots == S_)                                              \
    return (int)launch<VW_, G_, S_>(x0, ws, bs, ss, g, dx0, dws, dbs, partial, B, D, NL,    \
                                    warps, blocks, stream);
  NRT_CROSS_BWD_LAYOUTS(NRT_CROSS_BWD_CASE)
#undef NRT_CROSS_BWD_CASE
  return (int)cudaErrorInvalidValue;
}
