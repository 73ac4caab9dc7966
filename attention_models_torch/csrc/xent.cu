// Fused classifier head + softmax cross-entropy, forward and backward.
//
// Replaces attention_models_tpu/ops/xent.py::_head_xent_fwd_kernel (entry
// _head_nll_fwd_call) and ::_head_xent_bwd_kernel (entry _head_nll_bwd),
// bf16 and fp32, with the optional bias of Parti's head. h is (n, d) and
// the head weight W is (V, d), the torch Linear layout (the TPU kernel
// takes its transpose (d, V)).
//
// Forward (kernel 13): per row, logits = h W^T rounded to h's dtype (+ the
// bias, also in the dtype), then in fp32 lse = max + log sum exp(l - max)
// and nll = lse - l[target]; a row whose target lies outside [0, V) picks
// nothing (its nll is lse, masked by the caller). Backward (kernel 14):
// the logits again, p = exp(l - lse), dl = (p - onehot) * coef with coef
// the cotangent of each row's nll, db = sum over rows of dl in fp32, dl
// rounded to the dtype, dh = dl W in the dtype, dW = dl^T h in fp32.
//
// Bound on the H100: operations. At MaskGIT's n 8192, d 768, V 8192 the
// forward is 2 n d V = 103.1 GFLOP (0.104 ms at the bf16 tensor-core peak,
// 1.54 ms at the fp32 FMA peak) and the backward 6 n d V = 309.2 GFLOP
// (0.313 ms / 4.62 ms); h, W and the outputs are ~25 MB (0.008 ms).
//
// Design. The TPU kernel holds a (rows, V) logits tile and the whole W in
// VMEM; here one fp32 row of logits is 32 KB. The forward streams W in
// 128-wide vocab chunks through csrc/gemm.cuh's tile product (both
// operands kK as they lie) and keeps, per thread and row, a running (max,
// sum of exp) over the columns it holds -- the online softmax -- and the
// target's logit when its chunk passes; the threads' partial statistics
// merge at the end of the block. The vocab is split into up to 4 ranges,
// one block each, so 8192 rows fill the card; a small kernel merges the
// ranges' statistics in order. The (n, V) logits never reach device memory.
// The backward writes dl once, as an (n, V) scratch in the dtype (134 MB at
// these shapes in bf16), then runs the two products dh = dl W and dW =
// dl^T h from it; recomputing the logits per (d, V) tile of dW instead
// would skip the scratch at the price of a third product. In bf16 its three
// products are csrc/gemm_sm90.cuh's TMA/wgmma tile product:
//   1. logits = h W^T (both K-major), the epilogue forming dl in registers
//      and writing it in bf16 with, given a bias, the fp32 column sums of
//      dl (before the rounding, as the TPU kernel sums db) per 64 rows;
//   2. dh = dl W, W read MN-major, bf16 out;
//   3. dW = dl^T h, both operands MN-major, fp32 out (K = n split into
//      ordered partials where the plan says so);
// the host plan (ops/xent.py::xent_bwd_plan) holds the three products'
// maps, grids and tile widths. In fp32 the products stay csrc/gemm.cuh's
// exact FMA tiles (dl^T read as its kR operands). Deterministic, no
// atomics: the db partials and any split of dW are summed in order.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kMaxSplits = 4;  // vocab ranges of the forward (ops/xent.py)

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The logit as the TPU kernel forms it: the product rounded to the dtype,
// plus the bias in the dtype (rounded again).
template <typename T>
__device__ __forceinline__ float logit(float acc, const T* bias, int col) {
  const float l = round_to<T>(acc);
  return bias != nullptr ? round_to<T>(l + to_f32<T>(bias[col])) : l;
}

// Online-softmax merge of (m, s) with (om, os).
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  s = s * expf(m - mm) + os * expf(om - mm);
  m = mm;
}

// part: (3, splits, n) fp32 = running max, sum of exp and target logit of
// each row over each vocab range.
__global__ void xent_combine_kernel(const float* __restrict__ part, float* __restrict__ nll,
                                    float* __restrict__ lse, int n, int splits) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* pm = part;
  const float* ps = part + (int64_t)splits * n;
  const float* pt = part + (int64_t)2 * splits * n;
  float m = pm[r], s = ps[r], tl = pt[r];
  for (int k = 1; k < splits; ++k) {
    merge(m, s, pm[(int64_t)k * n + r], ps[(int64_t)k * n + r]);
    tl += pt[(int64_t)k * n + r];
  }
  const float l = m + logf(s);
  lse[r] = l;
  nll[r] = l - tl;
}

// Forward, bf16: block (range, row tile of 128); each thread holds 8 rows
// (mt, half) and, per chunk, 8 of their columns.
__global__ __launch_bounds__(kThreads) void xent_fwd_bf16_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w, const bf16* __restrict__ bias,
    const int* __restrict__ tgt, float* __restrict__ part, int n, int d, int V,
    int span) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int m0 = blockIdx.y * kBM, v0 = blockIdx.x * span;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  int tg[4][2];
  float mx[4][2], sm[4][2], tl[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      tg[mt][half] = row < n ? tgt[row] : -1;
      mx[mt][half] = -INFINITY;
      sm[mt][half] = 0.f;
      tl[mt][half] = 0.f;
    }
  for (int n0 = v0; n0 < v0 + span; n0 += kBN) {
    float acc[4][4][4];
    mma_tile<kK, kK>(h, d, n, w, d, V, d, m0, n0, smem, acc);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float l[8];
        float cm = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int col = n0 + wn * 32 + nt * 8 + 2 * t + u;
            const float v = logit<bf16>(acc[mt][nt][2 * half + u], bias, col);
            l[nt * 2 + u] = v;
            cm = fmaxf(cm, v);
            if (col == tg[mt][half]) tl[mt][half] = v;
          }
        const float mm = fmaxf(mx[mt][half], cm);
        float s = sm[mt][half] * expf(mx[mt][half] - mm);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += expf(l[e] - mm);
        sm[mt][half] = s;
        mx[mt][half] = mm;
      }
  }
  // merge across the 4 lanes of a quad, then across the 4 column warps
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, mx[mt][half], o);
        const float os = __shfl_xor_sync(0xffffffffu, sm[mt][half], o);
        tl[mt][half] += __shfl_xor_sync(0xffffffffu, tl[mt][half], o);
        merge(mx[mt][half], sm[mt][half], om, os);
      }
  __syncthreads();  // the tile product's shared memory is free
  float* red = reinterpret_cast<float*>(smem_raw);  // [3][4 wn][kBM]
  if (t == 0) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 64 + mt * 16 + g + half * 8;
        red[(0 * 4 + wn) * kBM + r] = mx[mt][half];
        red[(1 * 4 + wn) * kBM + r] = sm[mt][half];
        red[(2 * 4 + wn) * kBM + r] = tl[mt][half];
      }
  }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + threadIdx.x < n) {
    const int r = threadIdx.x;
    float m = red[r], s = red[4 * kBM + r], tsum = red[8 * kBM + r];
    for (int q = 1; q < 4; ++q) {
      merge(m, s, red[q * kBM + r], red[(4 + q) * kBM + r]);
      tsum += red[(8 + q) * kBM + r];
    }
    const int64_t at = (int64_t)blockIdx.x * n + m0 + r;
    const int64_t plane = (int64_t)gridDim.x * n;
    part[at] = m;
    part[plane + at] = s;
    part[2 * plane + at] = tsum;
  }
}

// Forward, fp32: 64-row tiles of exact FMA products, 64-wide chunks; each
// thread holds rows ty + 16 i and, per chunk, columns tx + 16 j.
__global__ __launch_bounds__(kThreads) void xent_fwd_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ tgt, float* __restrict__ part, int n, int d, int V,
    int span) {
  __shared__ __align__(16) FTile as, bs;
  const int m0 = blockIdx.y * kFM, v0 = blockIdx.x * span;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int tg[4];
  float mx[4], sm[4], tl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    tg[i] = row < n ? tgt[row] : -1;
    mx[i] = -INFINITY;
    sm[i] = 0.f;
    tl[i] = 0.f;
  }
  for (int n0 = v0; n0 < v0 + span; n0 += kFN) {
    float acc[4][4];
    fma_tile<kK, kK>(h, d, n, w, d, V, d, m0, n0, as, bs, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float l[4];
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        l[j] = logit<float>(acc[i][j], bias, col);
        cm = fmaxf(cm, l[j]);
        if (col == tg[i]) tl[i] = l[j];
      }
      const float mm = fmaxf(mx[i], cm);
      float s = sm[i] * expf(mx[i] - mm);
#pragma unroll
      for (int j = 0; j < 4; ++j) s += expf(l[j] - mm);
      sm[i] = s;
      mx[i] = mm;
    }
  }
  // merge across the 16 lanes that share ty
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int o = 1; o <= 8; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[i], o);
      const float os = __shfl_xor_sync(0xffffffffu, sm[i], o);
      tl[i] += __shfl_xor_sync(0xffffffffu, tl[i], o);
      merge(mx[i], sm[i], om, os);
    }
  if (tx == 0) {
    const int64_t plane = (int64_t)gridDim.x * n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row >= n) continue;
      const int64_t at = (int64_t)blockIdx.x * n + row;
      part[at] = mx[i];
      part[plane + at] = sm[i];
      part[2 * plane + at] = tl[i];
    }
  }
}

// Backward, the logits product's epilogue in bf16: acc = h W^T of a
// warpgroup's 64 x BN tile (rows m0r.., vocab columns n0..) becomes dl in
// bf16 and, given a bias, the fp32 column sums of dl over its 64 rows.
struct XentDl {
  struct Args {
    const bf16* bias;   // (V,) or null
    const int* tgt;     // (n,)
    const float* lse;   // (n,)
    const float* coef;  // (n,)
    bf16* dl;           // (n, V), rows ld elements apart
    float* dbpart;      // (2 * row tiles, V), or null without a bias
    int m, n, ld;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t* ring,
                                             int m0r, int n0, int c) {
    using S = sm90::Staged<BN, bf16>;
    uint8_t* st = ring + c * S::kBytes;
    float* red = reinterpret_cast<float*>(ring + 2 * S::kBytes) + c * 4 * BN;
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    const int r0 = m0r + rl, r1 = r0 + 8;
    const bool ok[2] = {r0 < a.m, r1 < a.m};
    const int tg[2] = {ok[0] ? a.tgt[r0] : -1, ok[1] ? a.tgt[r1] : -1};
    const float ls[2] = {ok[0] ? a.lse[r0] : 0.f, ok[1] ? a.lse[r1] : 0.f};
    const float cf[2] = {ok[0] ? a.coef[r0] : 0.f, ok[1] ? a.coef[r1] : 0.f};
    float cs[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = n0 + cl;
      float bb[2] = {0.f, 0.f};
      if (a.bias != nullptr && col < a.n) {
        const float2 b2 = sm90::bias_pair(a.bias, col);
        bb[0] = b2.x;
        bb[1] = b2.y;
      }
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, u = e % 2;
        float l = round_to<bf16>(acc[4 * i + e]);
        if (a.bias != nullptr) l = round_to<bf16>(l + bb[u]);
        const float p = expf(l - ls[h]);
        // a row past n has coef 0 and no target: nothing, even where p is inf
        v[e] = ok[h] ? (p - (col + u == tg[h] ? 1.f : 0.f)) * cf[h] : 0.f;
      }
      S::put(st, rl, cl, v[0], v[1]);
      S::put(st, rl + 8, cl, v[2], v[3]);
      cs[2 * i] = v[0] + v[2];
      cs[2 * i + 1] = v[1] + v[3];
    }
    if (a.dbpart != nullptr)
      sm90::colsum_rows<BN>(cs, red, a.dbpart + (int64_t)(2 * blockIdx.y + c) * a.n,
                            n0, a.n, c);
    else
      hopper::named_barrier_sync(2 + c, 128);
    S::flush(st, a.dl, a.ld, m0r, n0, a.m, a.n);
  }
};

// Backward, first pass, fp32: 64 x 64 tiles; dbpart rows are 64-row tiles.
__global__ __launch_bounds__(kThreads) void xent_dl_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ w, const float* __restrict__ bias,
    const int* __restrict__ tgt, const float* __restrict__ lse,
    const float* __restrict__ coef, float* __restrict__ dl, float* __restrict__ dbpart,
    int n, int d, int V) {
  __shared__ __align__(16) FTile as, bs;
  __shared__ float red[kThreads / 32][kFN];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN;
  float acc[4][4];
  fma_tile<kK, kK>(h, d, n, w, d, V, d, m0, n0, as, bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    const bool ok = row < n;
    const int tg = ok ? tgt[row] : -1;
    const float ls = ok ? lse[row] : 0.f, cf = ok ? coef[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      const float p = expf(logit<float>(acc[i][j], bias, col) - ls);
      const float v = (p - (col == tg ? 1.f : 0.f)) * cf;
      cs[j] += v;
      if (ok) dl[(int64_t)row * V + col] = v;
    }
  }
  if (dbpart == nullptr) return;
  // the two ty of a warp, then the 8 warps in order
#pragma unroll
  for (int j = 0; j < 4; ++j) cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
  if ((threadIdx.x % 32) < 16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[threadIdx.x / 32][tx + 16 * j] = cs[j];
  }
  __syncthreads();
  if (threadIdx.x < kFN) {
    float s = 0.f;
    for (int q = 0; q < kThreads / 32; ++q) s += red[q][threadIdx.x];
    dbpart[(int64_t)blockIdx.y * V + n0 + threadIdx.x] = s;
  }
}

int vocab_splits(int V, int chunk) {
  const int chunks = V / chunk;
  for (int k = kMaxSplits; k > 1; k /= 2)
    if (chunks % k == 0) return k;
  return 1;
}

}  // namespace

// part: fp32 scratch of 3 * 4 * n; nll, lse: fp32 (n,). bias may be null.
AMT_EXPORT int amt_head_xent_fwd(const void* h, const void* w, const void* bias,
                                 const void* tgt, void* part, void* nll, void* lse, int n,
                                 int d, int V, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d % 8 != 0 || V % kBN != 0) return cudaErrorInvalidValue;
  const auto* tg = static_cast<const int*>(tgt);
  auto* pp = static_cast<float*>(part);
  cudaError_t err;
  int splits;
  if (dtype == AMT_BF16) {
    splits = vocab_splits(V, kBN);
    if ((err = cudaFuncSetAttribute(xent_fwd_bf16_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kTileSmem)) != cudaSuccess)
      return err;
    const dim3 grid(splits, (n + kBM - 1) / kBM);
    xent_fwd_bf16_kernel<<<grid, kThreads, kTileSmem, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w),
        static_cast<const bf16*>(bias), tg, pp, n, d, V, V / splits);
  } else if (dtype == AMT_F32) {
    splits = vocab_splits(V, kFN);
    const dim3 grid(splits, (n + kFM - 1) / kFM);
    xent_fwd_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w),
        static_cast<const float*>(bias), tg, pp, n, d, V, V / splits);
  } else {
    return cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  xent_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(pp, static_cast<float*>(nll),
                                                     static_cast<float*>(lse), n, splits);
  return cudaGetLastError();
}

// dl: (n, V) scratch in the dtype; dbpart: fp32 partial column sums of dl
// when the bias is given (else unused, may be null): (2 ceil(n / 128), V) in
// bf16, (ceil(n / 64), V) in fp32; dh (n, d) in the dtype; dw (V, d) and db
// (V,) in fp32. bf16 only: plan, ops/xent.py::XentBwdPlan (3 GemmPlans:
// logits, dh, dW), and wpart, the fp32 partials of dW where its plan splits
// K (else unused).
AMT_EXPORT int amt_head_xent_bwd(const void* h, const void* w, const void* bias,
                                 const void* tgt, const void* lse, const void* coef,
                                 void* dl, void* dbpart, void* dh, void* dw, void* db,
                                 void* wpart, const int64_t* plan, int n, int d, int V,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 8 != 0 || d % 8 != 0 || V % kBN != 0) return cudaErrorInvalidValue;
  const bool has_bias = bias != nullptr;
  const auto* tg = static_cast<const int*>(tgt);
  const auto* ls = static_cast<const float*>(lse);
  const auto* cf = static_cast<const float*>(coef);
  auto* dbp = has_bias ? static_cast<float*>(dbpart) : nullptr;
  auto* dwf = static_cast<float*>(dw);
  cudaError_t err;
  if (dtype == AMT_BF16) {
    using sm90::Form;
    using sm90::kK;
    using sm90::kMN;
    constexpr int P = sm90::kPlanValues;
    if (plan == nullptr) return cudaErrorInvalidValue;
    const auto* hi = static_cast<const bf16*>(h);
    const auto* wi = static_cast<const bf16*>(w);
    auto* dli = static_cast<bf16*>(dl);
    const XentDl::Args xa{static_cast<const bf16*>(bias), tg, ls, cf, dli, dbp, n, V, V};
    const sm90::StoreBf16::Args ha{static_cast<bf16*>(dh), n, d, d, 0};
    if ((err = sm90::gemm_from_plan<Form<kK, kK>, XentDl, 128>(
             plan, nullptr, hi, wi, nullptr, nullptr, xa, n, V, d, V, s)) != cudaSuccess ||
        (has_bias && (err = colsum(dbp, static_cast<float*>(db),
                                   2 * ((n + sm90::kBM - 1) / sm90::kBM), V, s)) !=
                         cudaSuccess) ||
        (err = sm90::gemm_from_plan<Form<kK, kMN>, sm90::StoreBf16, 128>(
             plan + P, nullptr, dli, wi, nullptr, nullptr, ha, n, d, V, d, s)) !=
            cudaSuccess)
      return err;
    return sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(
        plan + 2 * P, dli, hi, dwf, static_cast<float*>(wpart), V, d, n, d, s);
  }
  if (dtype == AMT_F32) {
    const auto* hi = static_cast<const float*>(h);
    const auto* wi = static_cast<const float*>(w);
    auto* dli = static_cast<float*>(dl);
    const int tiles = (n + kFM - 1) / kFM;
    xent_dl_f32_kernel<<<dim3(V / kFN, tiles), kThreads, 0, s>>>(
        hi, wi, static_cast<const float*>(bias), tg, ls, cf, dli, dbp, n, d, V);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (has_bias && (err = colsum(dbp, static_cast<float*>(db), tiles, V, s)) != cudaSuccess) ||
        (err = gemm_f32<kK, kR>(dli, V, wi, d, static_cast<float*>(dh), d, n, d, V, s)) !=
            cudaSuccess)
      return err;
    return gemm_f32<kR, kR>(dli, V, hi, d, dwf, d, V, d, n, s);
  }
  return cudaErrorInvalidValue;
}
