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
// VMEM; here one fp32 row of logits is 32 KB, and the (n, V) logits never
// reach device memory in the forward. Both products of logits = h W^T run
// on tiles of 128 rows x 128 vocab columns, both operands K-major as they
// lie:
//   - bf16: csrc/gemm_sm90.cuh's TMA/wgmma tile product (planned on the
//     host: ops/xent.py::xent_fwd_plan and the first product of
//     xent_bwd_plan);
//   - fp32: csrc/gemm.cuh's register-tiled FMA product (reg_product; no
//     plan), each thread holding 8 rows x 8 columns.
// The forward's epilogue (XentStats; xent_stats_f32_kernel) forms each
// logit as the TPU kernel rounds it and never stores one: per row it keeps
// the (max, sum of exp) over the tile's columns the thread holds, merges
// them across the lanes that share the row in a fixed order (a quad of the
// wgmma layout; the 16 lanes of a register-tile row), and picks the
// target's logit where the target lies in the tile. It writes one
// (max, sum, target logit) triple per row and column tile into an fp32
// partial scratch (3, V / 128, n); xent_combine_kernel merges a row's
// partials in column order (lse = max + log sum, nll = lse - target
// logit). V is a multiple of 128 (the C entries check it), so no tile
// reaches past V.
// The backward writes dl once, as an (n, V) scratch in the dtype (134 MB at
// these shapes in bf16), then runs the two products dh = dl W and dW =
// dl^T h from it; recomputing the logits per (d, V) tile of dW instead
// would skip the scratch at the price of a third product:
//   1. logits = h W^T, the epilogue (XentDl; xent_grad_f32_kernel) forming
//      dl in registers and writing it in the dtype with, given a bias, the
//      fp32 column sums of dl (before the rounding, as the TPU kernel sums
//      db): bf16 one partial row per 64 rows (a warpgroup), fp32 one per
//      128-row tile;
//   2. dh = dl W (bf16: W read MN-major; fp32: gemm_f32, dl kK and W kR);
//   3. dW = dl^T h (bf16: both operands MN-major, K = n split into ordered
//      partials where the plan says so; fp32: gemm_f32, both kR).
// Deterministic, no atomics: the statistics, the db partials and any split
// of dW are merged or summed in one fixed order, so a repeat call gives
// the same bits.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kTile = 128;  // rows and vocab columns of a logits tile

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// The logit as the TPU kernel forms it: the product rounded to the dtype,
// plus the bias b (already in the dtype) when there is one, rounded again.
template <typename T>
__device__ __forceinline__ float logit(float acc, bool has_bias, float b) {
  const float l = round_to<T>(acc);
  return has_bias ? round_to<T>(l + b) : l;
}

// Online-softmax merge of (m, s) with (om, os).
__device__ __forceinline__ void merge(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  s = s * expf(m - mm) + os * expf(om - mm);
  m = mm;
}

// part: (3, tiles, n) fp32 = max, sum of exp and target logit of each row
// over each column tile; merged in column order.
__global__ void xent_combine_kernel(const float* __restrict__ part, float* __restrict__ nll,
                                    float* __restrict__ lse, int n, int tiles) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* pm = part;
  const float* ps = part + (int64_t)tiles * n;
  const float* pt = part + (int64_t)2 * tiles * n;
  float m = pm[r], s = ps[r], tl = pt[r];
  for (int k = 1; k < tiles; ++k) {
    merge(m, s, pm[(int64_t)k * n + r], ps[(int64_t)k * n + r]);
    tl += pt[(int64_t)k * n + r];
  }
  const float l = m + logf(s);
  lse[r] = l;
  nll[r] = l - tl;
}

// The forward's epilogue in bf16: acc = h W^T of a warpgroup's 64 x BN tile
// (rows m0r.., vocab columns n0..); each thread's two rows (rl, rl + 8)
// over its BN / 4 columns, merged over the quad (t), written as the row's
// partial for column tile blockIdx.x. The logits take the accumulators'
// registers (two blocks an SM leave a thread 96).
struct XentStats {
  struct Args {
    const bf16* bias;  // (V,) or null
    const int* tgt;    // (n,)
    float* part;       // (3, gridDim.x, n)
    int m, n;
  };
  template <int BN>
  static __device__ __forceinline__ void run(const float (&acc)[BN / 2],
                                             const Args& a, uint8_t*, int m0r,
                                             int n0, int) {
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int rl = 16 * (tid / 32) + lane / 4, t = lane % 4;
    const int r0 = m0r + rl, r1 = r0 + 8;
    const int tg[2] = {r0 < a.m ? a.tgt[r0] : -1, r1 < a.m ? a.tgt[r1] : -1};
    const bool has_bias = a.bias != nullptr;
    // the logits in place of the accumulators (l[4i + e]: row e / 2,
    // column 8i + 2t + e % 2; every column lies below V, a multiple of the
    // tile width), then each row's max, sum of exp and target logit
    float l[BN / 2];
    float m[2] = {-INFINITY, -INFINITY}, s[2] = {0.f, 0.f}, tl[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * t;
      const float2 bb = has_bias ? sm90::bias_pair(a.bias, col)
                                 : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e / 2, u = e % 2;
        l[4 * i + e] = logit<bf16>(acc[4 * i + e], has_bias, u ? bb.y : bb.x);
        m[hr] = fmaxf(m[hr], l[4 * i + e]);
        if (col + u == tg[hr]) tl[hr] = l[4 * i + e];
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e / 2] += expf(l[4 * i + e] - m[e / 2]);
    // the quad's four lanes hold the row's other columns
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m[hr], o);
        const float os = __shfl_xor_sync(0xffffffffu, s[hr], o);
        tl[hr] += __shfl_xor_sync(0xffffffffu, tl[hr], o);
        merge(m[hr], s[hr], om, os);
      }
    if (t != 0) return;
    const int64_t plane = (int64_t)gridDim.x * a.m;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr ? r1 : r0;
      if (row >= a.m) continue;
      const int64_t at = (int64_t)blockIdx.x * a.m + row;
      a.part[at] = m[hr];
      a.part[plane + at] = s[hr];
      a.part[2 * plane + at] = tl[hr];
    }
  }
};

// The fp32 logits of a 128 x 128 tile on the register-tiled FMA product:
// acc[i][4 cg + j] is (h W^T)[row i][n0 + 64 cg + 4 tx + j], rows 4 ty + i
// (i < 4) and 64 + 4 ty + i - 4 (i >= 4) of the tile.
__device__ __forceinline__ void f32_logits(const float* h, const float* w, int n,
                                           int d, int V, int m0, int n0,
                                           RTiles<kTile>& sm, float (&acc)[8][8]) {
  reg_product<kTile>(plain_piece<kK, kRM>(h, d, n, m0),
                     plain_piece<kK, kTile>(w, d, V, n0), d, sm, acc);
}

// The tile row of f32_logits' accumulator row i.
__device__ __forceinline__ int f32_row(int i) {
  const int ty = threadIdx.x / 16;
  return i < 4 ? 4 * ty + i : 60 + 4 * ty + i;
}

// Forward, fp32: block (column tile, row tile of 128); each row's 128
// columns lie with the 16 lanes that share ty, merged by shuffles (xor 1 ..
// 8), then written as the row's partial for this column tile.
__global__ __launch_bounds__(kRThreads, 2) void xent_stats_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ tgt,
    float* __restrict__ part, int n, int d, int V) {
  __shared__ __align__(16) RTiles<kTile> sm;
  const int m0 = blockIdx.y * kRM, n0 = blockIdx.x * kTile;
  float acc[8][8];
  f32_logits(h, w, n, d, V, m0, n0, sm, acc);
  const int tx = threadIdx.x % 16;
  const bool has_bias = bias != nullptr;
  int col[8];
  float bb[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    col[j] = n0 + 64 * (j / 4) + 4 * tx + j % 4;
    bb[j] = has_bias ? bias[col[j]] : 0.f;
  }
  const int64_t plane = (int64_t)gridDim.x * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + f32_row(i);
    const int tg = row < n ? tgt[row] : -1;
    float l[8], m = -INFINITY, s = 0.f, tl = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      l[j] = logit<float>(acc[i][j], has_bias, bb[j]);
      m = fmaxf(m, l[j]);
      if (col[j] == tg) tl = l[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) s += expf(l[j] - m);
#pragma unroll
    for (int o = 1; o <= 8; o <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, o);
      const float os = __shfl_xor_sync(0xffffffffu, s, o);
      tl += __shfl_xor_sync(0xffffffffu, tl, o);
      merge(m, s, om, os);
    }
    if (tx == 0 && row < n) {
      const int64_t at = (int64_t)blockIdx.x * n + row;
      part[at] = m;
      part[plane + at] = s;
      part[2 * plane + at] = tl;
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
    const bool has_bias = a.bias != nullptr;
    float cs[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int cl = 8 * i + 2 * t, col = n0 + cl;
      const float2 bb = has_bias && col < a.n ? sm90::bias_pair(a.bias, col)
                                              : make_float2(0.f, 0.f);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2, u = e % 2;
        const float p =
            expf(logit<bf16>(acc[4 * i + e], has_bias, u ? bb.y : bb.x) - ls[h]);
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

// Backward, first pass, fp32: dl of a 128 x 128 tile on the register-tiled
// FMA product, written in fp32; given dbpart, the tile's column sums of dl
// (a thread's 8 rows, the warp's two ty, then the 8 warps in order) as
// row blockIdx.y of dbpart.
__global__ __launch_bounds__(kRThreads, 2) void xent_grad_f32_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ bias, const int* __restrict__ tgt,
    const float* __restrict__ lse, const float* __restrict__ coef,
    float* __restrict__ dl, float* __restrict__ dbpart, int n, int d, int V) {
  __shared__ __align__(16) RTiles<kTile> sm;
  const int m0 = blockIdx.y * kRM, n0 = blockIdx.x * kTile;
  float acc[8][8];
  f32_logits(h, w, n, d, V, m0, n0, sm, acc);
  const int tx = threadIdx.x % 16;
  const bool has_bias = bias != nullptr;
  float bb[8], cs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bb[j] = has_bias ? bias[n0 + 64 * (j / 4) + 4 * tx + j % 4] : 0.f;
    cs[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + f32_row(i);
    const bool ok = row < n;
    const int tg = ok ? tgt[row] : -1;
    const float ls = ok ? lse[row] : 0.f, cf = ok ? coef[row] : 0.f;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 64 * (j / 4) + 4 * tx + j % 4;
      const float p = expf(logit<float>(acc[i][j], has_bias, bb[j]) - ls);
      v[j] = ok ? (p - (col == tg ? 1.f : 0.f)) * cf : 0.f;
      cs[j] += v[j];
    }
    if (ok) {
#pragma unroll
      for (int cg = 0; cg < 2; ++cg)
        store4(dl + (int64_t)row * V + n0 + 64 * cg + 4 * tx, v[4 * cg],
               v[4 * cg + 1], v[4 * cg + 2], v[4 * cg + 3]);
    }
  }
  if (dbpart == nullptr) return;
  // the product's stages are free (its last barrier follows its last read)
  float* red = reinterpret_cast<float*>(&sm);  // [8 warps][kTile]
#pragma unroll
  for (int j = 0; j < 8; ++j) cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
  if ((threadIdx.x % 32) < 16) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[(threadIdx.x / 32) * kTile + 64 * (j / 4) + 4 * tx + j % 4] = cs[j];
  }
  __syncthreads();
  if (threadIdx.x < kTile) {
    float s = 0.f;
    for (int q = 0; q < kRThreads / 32; ++q) s += red[q * kTile + threadIdx.x];
    dbpart[(int64_t)blockIdx.y * V + n0 + threadIdx.x] = s;
  }
}

}  // namespace

// part: fp32 scratch (3, V / 128, n); nll, lse: fp32 (n,). bias may be
// null. bf16 only: plan, ops/xent.py::XentFwdPlan (the logits product's
// GemmPlan, BN 128).
AMT_EXPORT int amt_head_xent_fwd(const void* h, const void* w, const void* bias,
                                 const void* tgt, void* part, void* nll, void* lse,
                                 const int64_t* plan, int n, int d, int V, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || d % 8 != 0 || V % kTile != 0) return cudaErrorInvalidValue;
  const auto* tg = static_cast<const int*>(tgt);
  auto* pp = static_cast<float*>(part);
  const int tiles = V / kTile;
  cudaError_t err;
  if (dtype == AMT_BF16) {
    using sm90::Form;
    using sm90::kK;
    if (plan == nullptr || plan[13] != tiles) return cudaErrorInvalidValue;
    const XentStats::Args xa{static_cast<const bf16*>(bias), tg, pp, n, V};
    err = sm90::gemm_from_plan<Form<kK, kK>, XentStats, kTile>(
        plan, nullptr, h, w, nullptr, nullptr, xa, n, V, d, V, s);
  } else if (dtype == AMT_F32) {
    xent_stats_f32_kernel<<<dim3(tiles, (n + kRM - 1) / kRM), kRThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w),
        static_cast<const float*>(bias), tg, pp, n, d, V);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  xent_combine_kernel<<<(n + 255) / 256, 256, 0, s>>>(pp, static_cast<float*>(nll),
                                                     static_cast<float*>(lse), n, tiles);
  return cudaGetLastError();
}

// dl: (n, V) scratch in the dtype; dbpart: fp32 partial column sums of dl
// when the bias is given (else unused, may be null): (2 ceil(n / 128), V) in
// bf16, (ceil(n / 128), V) in fp32; dh (n, d) in the dtype; dw (V, d) and db
// (V,) in fp32. bf16 only: plan, ops/xent.py::XentBwdPlan (3 GemmPlans:
// logits, dh, dW), and wpart, the fp32 partials of dW where its plan splits
// K (else unused).
AMT_EXPORT int amt_head_xent_bwd(const void* h, const void* w, const void* bias,
                                 const void* tgt, const void* lse, const void* coef,
                                 void* dl, void* dbpart, void* dh, void* dw, void* db,
                                 void* wpart, const int64_t* plan, int n, int d, int V,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 8 != 0 || d % 8 != 0 || V % kTile != 0) return cudaErrorInvalidValue;
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
    const int tiles = (n + kRM - 1) / kRM;
    xent_grad_f32_kernel<<<dim3(V / kTile, tiles), kRThreads, 0, s>>>(
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
