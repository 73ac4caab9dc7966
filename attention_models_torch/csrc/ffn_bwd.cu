// Backward of the fused GEGLU feed-forward out = LN_gamma(gate * gelu(a)) W2^T
// with [a | gate] = x W1^T (csrc/ffn.cu is its forward).
//
// Replaces attention_models_tpu/ops/ffn.py::_ffn_bwd_kernel (entry
// _ffn_bwd_pallas), bf16 and fp32. From x (n, d), W1 (2i, d), gamma (i,),
// W2 (d, i) -- the torch Linear layout -- and the cotangent dy (n, d) it
// returns dx (n, d) in x's dtype and dW1 (2i, d), dgamma (i,), dW2 (d, i)
// in fp32, with the TPU kernel's formulas and rounding points: a and gate
// in fp32 from the dtype's operands, g = gate * gelu(a) and its two-pass
// LN statistics in fp32, y = ghat * gamma rounded to the dtype before
// dW2 = dy^T y, dy_ln = dy W2 in fp32, dgamma = sum over rows of
// dy_ln * ghat, the row-wise LN backward dg = rstd (dghat - mean(dghat)
// - ghat mean(dghat ghat)), then dgate = dg gelu(a) and da = dg gate
// (Phi(a) + a phi(a)) rounded to the dtype before dx = [da | dgate] W1 and
// dW1 = [da | dgate]^T x. gelu uses the true erff, as the forward kernel
// does (the TPU kernel's A&S polynomial differs by at most 1.5e-7).
//
// Bound on the H100: operations. Five products of 2 n d i or 4 n d i
// flops each -- the recompute x W1^T, dy W2, dW2, dx and dW1 -- are
// 16 n d i: at MaskGIT's n 8192, d 768, i 4096 that is 412.3 GFLOP,
// 0.417 ms at the bf16 tensor-core peak and 6.15 ms at the fp32 FMA peak;
// x, dy, dx, the weights and their gradients are ~99 MB (0.030 ms).
//
// Design. The TPU kernel walks row tiles in order and keeps three fp32
// weight-gradient accumulators (37.7 MB at these widths) resident across
// its grid. No SM holds them, and blocks run in parallel, so the work is
// split into passes, each deterministic and without atomics (as
// csrc/ln_mlp_bwd.cu splits the ln_mlp backward):
//   1. H = x W1^T into an fp32 scratch (n, 2i), in W1's own row order
//      (a columns, then gate columns);
//   2. dy_ln = dy W2 into an fp32 scratch (n, i);
//   3. rows (ffn_bwd_rows_kernel): one block walks kRowsPerBlock rows with
//      each row in registers, every scratch read once in 16-byte pieces (a
//      row wider than kRowsMax in chunks, read again for each step):
//      g from H, the two-pass mean and variance, y (to a scratch in the
//      dtype), the two row means of dghat and dghat ghat, and [da | dgate]
//      (to a scratch (n, 2i) in the dtype, in W1's row order, so dW1 comes
//      out in the parameter's own (2i, d) order); each block also writes
//      its column sums of dy_ln ghat over its rows;
//   4. dgamma: the block partials summed in order;
//   5. dW2 = dy^T y, dx = [da | dgate] W1 and dW1 = [da | dgate]^T x.
// bf16 runs the products on csrc/gemm_sm90.cuh's TMA/wgmma tile product:
// H and dy_ln with fp32 stores (W2 read MN-major), dx with the bf16 store
// (W1 read MN-major), the weight gradients with both operands MN-major and
// K = n split into ordered fp32 partials where the plan says so. fp32 runs
// them on csrc/gemm.cuh's register-tiled FMA product, K split into ordered
// partials where a product's last wave would run half empty. The host
// plan (ops/ffn.py::ffn_bwd_plan, 105 int64: the five GemmPlans) holds the
// maps, grids, splits and the scratches' row pitches. The LN backward
// needs two row-wide means over the full inner width between the products,
// so the scratches stay: H and dy_ln 403 MB in fp32, y and [da | dgate]
// 201 MB in bf16 at n 8192, each written once and read once (~0.18 ms at
// the memory rate beside the 0.417 ms bound).
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int kRowsPerBlock = 16;  // ops/ffn.py FFN_BWD_ROWS
using sm90::kInvSqrt2;
using sm90::kInvSqrt2Pi;

__device__ __forceinline__ float phi_cdf(float a) {
  return 0.5f * (1.f + erff(a * kInvSqrt2));
}

__device__ __forceinline__ float4 ld4(const float* p, int c) {
  return reinterpret_cast<const float4*>(p)[c];
}

// Pass 3: rows row0 .. row0 + kRowsPerBlock - 1 of the block. A row of at
// most blockDim.x * NV 16-byte pieces is held in registers (a, gate, g and
// dy_ln: the pieces csrc/gemm.cuh's row_threads layout gives this thread)
// and each scratch is read once; a wider row is walked in chunks of that
// many pieces, each of the four steps reading its chunks again (12 inner
// bytes a row, from L2). gpart[block] = this block's column sums of
// dy_ln * ghat over its rows, in row order: in registers, or for a wide row
// in gpart itself, each column read and written by one thread only.
template <typename T, int NV>
__global__ __launch_bounds__(256) void ffn_bwd_rows_kernel(
    const float* __restrict__ hs, int ldh, const float* __restrict__ dyln, int ldl,
    const float* __restrict__ gamma, T* __restrict__ y, int ldy, T* __restrict__ dh,
    int lddh, float* __restrict__ gpart, int n, int inner, float eps) {
  __shared__ float red[32 * 2];
  const int n4 = inner / 4, nt = blockDim.x, step = nt * NV;
  // NV 4 serves rows of at most kRowsNV4 columns only, which it holds
  const bool held = NV == 4 || n4 <= step;
  const int chunks = held ? 1 : (n4 + step - 1) / step;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* gp = reinterpret_cast<float4*>(gpart + (int64_t)blockIdx.x * inner);
  float4 dgp[NV];
#pragma unroll
  for (int u = 0; u < NV; ++u) dgp[u] = zero;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rend = min(row0 + kRowsPerBlock, n);
  for (int r = row0; r < rend; ++r) {
    const float* ar = hs + (int64_t)r * ldh;
    const float* lr = dyln + (int64_t)r * ldl;
    float a[NV][4], gt[NV][4], g[NV][4], dl[NV][4];
    const auto load = [&](int c0) {
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + threadIdx.x + nt * u;
        const bool in = c < n4;
        const float4 av = in ? ld4(ar, c) : zero;
        const float4 gv = in ? ld4(ar + inner, c) : zero;
        const float4 lv = in ? ld4(lr, c) : zero;
        a[u][0] = av.x, a[u][1] = av.y, a[u][2] = av.z, a[u][3] = av.w;
        gt[u][0] = gv.x, gt[u][1] = gv.y, gt[u][2] = gv.z, gt[u][3] = gv.w;
        dl[u][0] = lv.x, dl[u][1] = lv.y, dl[u][2] = lv.z, dl[u][3] = lv.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) g[u][e] = gt[u][e] * (a[u][e] * phi_cdf(a[u][e]));
      }
    };
    float s[1] = {0.f};
    for (int k = 0; k < chunks; ++k) {
      const int c0 = k * step;
      load(c0);
#pragma unroll
      for (int u = 0; u < NV; ++u) s[0] += (g[u][0] + g[u][1]) + (g[u][2] + g[u][3]);
    }
    block_sums(s, red);
    const float mean = s[0] / inner;
    float q[1] = {0.f};
    for (int k = 0; k < chunks; ++k) {
      const int c0 = k * step;
      if (!held) load(c0);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        if (c0 + threadIdx.x + nt * u >= n4) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) q[0] += (g[u][e] - mean) * (g[u][e] - mean);
      }
    }
    block_sums(q, red);
    const float rstd = rsqrtf(q[0] / inner + eps);
    // y, the row sums of dghat and dghat * ghat, the dgamma partial
    float m[2] = {0.f, 0.f};
    T* yr = y + (int64_t)r * ldy;
    for (int k = 0; k < chunks; ++k) {
      const int c0 = k * step;
      if (!held) load(c0);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + threadIdx.x + nt * u;
        if (c >= n4) continue;
        const float4 gm4 = ld4(gamma, c);
        const float gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w};
        float h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = (g[u][e] - mean) * rstd;
          const float ev = dl[u][e] * gm[e];
          m[0] += ev;
          m[1] += ev * h[e];
        }
        store4(yr + 4 * c, h[0] * gm[0], h[1] * gm[1], h[2] * gm[2], h[3] * gm[3]);
        float4 p = held ? dgp[u] : (r == row0 ? zero : gp[c]);
        p.x += dl[u][0] * h[0];
        p.y += dl[u][1] * h[1];
        p.z += dl[u][2] * h[2];
        p.w += dl[u][3] * h[3];
        if (held)
          dgp[u] = p;
        else
          gp[c] = p;
      }
    }
    block_sums(m, red);
    const float m1 = m[0] / inner, m2 = m[1] / inner;
    // dg, then da and dgate in W1's row order
    T* dr = dh + (int64_t)r * lddh;
    for (int k = 0; k < chunks; ++k) {
      const int c0 = k * step;
      if (!held) load(c0);
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int c = c0 + threadIdx.x + nt * u;
        if (c >= n4) continue;
        const float4 gm4 = ld4(gamma, c);
        const float gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w};
        float da[4], dgt[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h = (g[u][e] - mean) * rstd;
          const float dg = rstd * (dl[u][e] * gm[e] - m1 - h * m2);
          const float av = a[u][e], ph = phi_cdf(av);
          const float pdf = expf(-0.5f * av * av) * kInvSqrt2Pi;
          dgt[e] = dg * (av * ph);
          da[e] = dg * gt[u][e] * (ph + av * pdf);
        }
        store4(dr + 4 * c, da[0], da[1], da[2], da[3]);
        store4(dr + inner + 4 * c, dgt[0], dgt[1], dgt[2], dgt[3]);
      }
    }
  }
  if (!held) return;
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    const int c = threadIdx.x + nt * u;
    if (c < n4) gp[c] = dgp[u];
  }
}

template <typename T>
cudaError_t rows_pass(const float* hs, int ldh, const float* dyln, int ldl,
                      const float* gamma, T* y, int ldy, T* dh, int lddh, float* gpart,
                      int n, int inner, float eps, cudaStream_t s) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  if (inner <= kRowsNV4)
    ffn_bwd_rows_kernel<T, 4><<<blocks, row_threads(inner, 4), 0, s>>>(
        hs, ldh, dyln, ldl, gamma, y, ldy, dh, lddh, gpart, n, inner, eps);
  else
    ffn_bwd_rows_kernel<T, 8><<<blocks, row_threads(min(inner, kRowsMax), 8), 0, s>>>(
        hs, ldh, dyln, ldl, gamma, y, ldy, dh, lddh, gpart, n, inner, eps);
  return cudaGetLastError();
}

}  // namespace

// plan: ops/ffn.py::FfnBwdPlan (bf16: 5 GemmPlans, H, dy_ln, dW2, dx, dW1;
// fp32 takes none). Scratch: h fp32 (n, 2i) and dyln fp32 (n, i); y (n, i)
// and dh (n, 2i) in the dtype; at the plans' row pitches (bf16) or 2i / i
// elements a row (fp32); gpart fp32 (ceil(n / 16), i); wpart fp32: bf16,
// (splits, 2i, d) where a weight gradient's plan splits K (else unused);
// fp32, 2 max(n d, 2i d) floats for the products' split partials.
AMT_EXPORT int amt_ffn_bwd(const int64_t* plan, const void* x, const void* w1,
                           const void* gamma, const void* w2, const void* dy,
                           void* h_scratch, void* dyln_scratch, void* y_scratch,
                           void* dh_scratch, void* gpart, void* wpart, void* dx, void* dw1,
                           void* dgamma, void* dw2, int n, int d, int inner, float eps,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 8 != 0 || d % 128 != 0 || inner % 128 != 0)
    return cudaErrorInvalidValue;
  const int i2 = 2 * inner;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  auto* hs = static_cast<float*>(h_scratch);
  auto* dls = static_cast<float*>(dyln_scratch);
  auto* gp = static_cast<float*>(gpart);
  const auto* gm = static_cast<const float*>(gamma);
  auto* dw1f = static_cast<float*>(dw1);
  auto* dw2f = static_cast<float*>(dw2);
  cudaError_t err;
  if (dtype == AMT_BF16) {
    using sm90::Form;
    using sm90::kMN;
    constexpr int kKM = sm90::kK;
    constexpr int P = sm90::kPlanValues;
    if (plan == nullptr) return cudaErrorInvalidValue;
    const int ldh = (int)plan[19], ldl = (int)plan[P + 19];
    const int ldy = (int)(plan[2 * P + 8] / 2);   // y: dW2's B map
    const int lddh = (int)(plan[3 * P + 2] / 2);  // dh: dx's A map
    auto* ys = static_cast<bf16*>(y_scratch);
    auto* dhs = static_cast<bf16*>(dh_scratch);
    auto* wp = static_cast<float*>(wpart);
    const sm90::StoreBf16::Args xa{static_cast<bf16*>(dx), n, d, d, 0};
    if ((err = sm90::gemm_f32_from_plan<Form<kKM, kKM>, 128>(plan, x, w1, hs, nullptr, n,
                                                             i2, d, ldh, s)) != cudaSuccess ||
        (err = sm90::gemm_f32_from_plan<Form<kKM, kMN>, 128>(plan + P, dy, w2, dls, nullptr,
                                                             n, inner, d, ldl, s)) !=
            cudaSuccess ||
        (err = rows_pass<bf16>(hs, ldh, dls, ldl, gm, ys, ldy, dhs, lddh, gp, n, inner, eps,
                               s)) != cudaSuccess ||
        (err = colsum(gp, static_cast<float*>(dgamma), blocks, inner, s)) != cudaSuccess ||
        (err = sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(plan + 2 * P, dy, ys, dw2f, wp,
                                                             d, inner, n, inner, s)) !=
            cudaSuccess ||
        (err = sm90::gemm_from_plan<Form<kKM, kMN>, sm90::StoreBf16, 128>(
             plan + 3 * P, nullptr, dhs, w1, nullptr, nullptr, xa, n, d, i2, d, s)) !=
            cudaSuccess)
      return err;
    return sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(plan + 4 * P, dhs, x, dw1f, wp, i2,
                                                         d, n, d, s);
  }
  if (dtype == AMT_F32) {
    const auto* xi = static_cast<const float*>(x);
    const auto* w1i = static_cast<const float*>(w1);
    const auto* w2i = static_cast<const float*>(w2);
    const auto* dyi = static_cast<const float*>(dy);
    auto* ys = static_cast<float*>(y_scratch);
    auto* dhs = static_cast<float*>(dh_scratch);
    auto* wp = static_cast<float*>(wpart);
    const int64_t cap = 2 * (int64_t)d * (n > i2 ? n : i2);
    if ((err = gemm_f32_split<kK, kK>(xi, d, w1i, d, hs, i2, n, i2, d, wp, cap, s)) !=
            cudaSuccess ||
        (err = gemm_f32_split<kK, kR>(dyi, d, w2i, inner, dls, inner, n, inner, d, wp, cap,
                                      s)) != cudaSuccess ||
        (err = rows_pass<float>(hs, i2, dls, inner, gm, ys, inner, dhs, i2, gp, n, inner,
                                eps, s)) != cudaSuccess ||
        (err = colsum(gp, static_cast<float*>(dgamma), blocks, inner, s)) != cudaSuccess ||
        (err = gemm_f32_split<kR, kR>(dyi, d, ys, inner, dw2f, inner, d, inner, n, wp, cap,
                                      s)) != cudaSuccess ||
        (err = gemm_f32_split<kK, kR>(dhs, i2, w1i, d, static_cast<float*>(dx), d, n, d, i2,
                                      wp, cap, s)) != cudaSuccess)
      return err;
    return gemm_f32_split<kR, kR>(dhs, i2, xi, d, dw1f, d, i2, d, n, wp, cap, s);
  }
  return cudaErrorInvalidValue;
}
