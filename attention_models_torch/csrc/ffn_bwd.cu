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
// split into passes, each a plain kernel, deterministic and without
// atomics (as csrc/ln_mlp_bwd.cu splits the ln_mlp backward):
//   1. H = x W1^T into an fp32 scratch (n, 2i), in W1's own row order
//      (a columns, then gate columns);
//   2. dy_ln = dy W2 into an fp32 scratch (n, i);
//   3. rows: one block of 256 threads walks 16 rows; per row it forms g
//      from H (kept in shared memory), the two-pass mean and variance,
//      y (to a scratch in the dtype), the two row means of dghat and
//      dghat ghat, and [da | dgate] (to a scratch (n, 2i) in the dtype, in
//      W1's row order, so dW1 comes out in the parameter's own (2i, d)
//      order and the forward's interleaved tiles never show); each block
//      also writes its partial column sums of dy_ln ghat;
//   4. dgamma: the block partials summed in order;
//   5. dW2 = dy^T y, dx = [da | dgate] W1 and dW1 = [da | dgate]^T x, tile
//      products of csrc/gemm.cuh (the A^T B ones reduce over all n rows in
//      order inside each block).
// The LN backward needs two row-wide means over the full inner width
// between the products, the problem the forward met; this takes the
// forward's answer, the global scratch, because it keeps every rounding
// point of the TPU kernel exactly and each pass stays a plain kernel. The
// price is the scratch traffic: H and dy_ln are 403 MB in fp32, y and
// [da | dgate] 201 MB in bf16 at n 8192 (written once, read one to three
// times: ~0.3 ms at the memory rate beside the 0.417 ms bound).
#include "gemm.cuh"

namespace {

constexpr int kRowsPerBlock = 16;  // ops/ffn.py FFN_BWD_ROWS
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__device__ __forceinline__ float phi_cdf(float a) {
  return 0.5f * (1.f + erff(a * kInvSqrt2));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d) {
  p[0] = from_f32<T>(a);
  p[1] = from_f32<T>(b);
  p[2] = from_f32<T>(c);
  p[3] = from_f32<T>(d);
}

// Pass 3. Thread j owns the float4 column groups j, j + 256, ...: the g row
// and the dgamma partial live in shared memory at those columns, touched by
// their owner only.
template <typename T>
__global__ __launch_bounds__(kThreads) void ffn_bwd_rows_kernel(
    const float* __restrict__ hs, const float* __restrict__ dyln,
    const float* __restrict__ gamma, T* __restrict__ y, T* __restrict__ dh,
    float* __restrict__ gpart, int n, int inner, float eps) {
  extern __shared__ __align__(16) float rows_smem[];
  float4* grow = reinterpret_cast<float4*>(rows_smem);           // [inner / 4]
  float4* dgp = reinterpret_cast<float4*>(rows_smem + inner);    // [inner / 4]
  __shared__ float red[kThreads / 32];
  const int n4 = inner / 4;
  const float4* gm4 = reinterpret_cast<const float4*>(gamma);
  for (int c = threadIdx.x; c < n4; c += kThreads) dgp[c] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int row0 = blockIdx.x * kRowsPerBlock;
  const int rend = min(row0 + kRowsPerBlock, n);
  for (int r = row0; r < rend; ++r) {
    const float4* a4 = reinterpret_cast<const float4*>(hs + (int64_t)r * 2 * inner);
    const float4* gt4 = a4 + n4;
    const float4* dl4 = reinterpret_cast<const float4*>(dyln + (int64_t)r * inner);
    // g = gate * gelu(a), its mean
    float s = 0.f;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const float4 a = a4[c], gt = gt4[c];
      const float4 g = make_float4(gt.x * (a.x * phi_cdf(a.x)), gt.y * (a.y * phi_cdf(a.y)),
                                   gt.z * (a.z * phi_cdf(a.z)), gt.w * (a.w * phi_cdf(a.w)));
      grow[c] = g;
      s += (g.x + g.y) + (g.z + g.w);
    }
    const float mean = block_sum(s, red) / inner;
    float q = 0.f;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const float4 g = grow[c];
      const float d0 = g.x - mean, d1 = g.y - mean, d2 = g.z - mean, d3 = g.w - mean;
      q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
    const float rstd = rsqrtf(block_sum(q, red) / inner + eps);
    // y, the row means of dghat and dghat * ghat, the dgamma partial
    float s1 = 0.f, s2 = 0.f;
    T* yr = y + (int64_t)r * inner;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const float4 g = grow[c], gm = gm4[c], dl = dl4[c];
      const float h0 = (g.x - mean) * rstd, h1 = (g.y - mean) * rstd;
      const float h2 = (g.z - mean) * rstd, h3 = (g.w - mean) * rstd;
      store4(yr + 4 * c, h0 * gm.x, h1 * gm.y, h2 * gm.z, h3 * gm.w);
      const float e0 = dl.x * gm.x, e1 = dl.y * gm.y, e2 = dl.z * gm.z, e3 = dl.w * gm.w;
      s1 += (e0 + e1) + (e2 + e3);
      s2 += (e0 * h0 + e1 * h1) + (e2 * h2 + e3 * h3);
      float4 p = dgp[c];
      p.x += dl.x * h0;
      p.y += dl.y * h1;
      p.z += dl.z * h2;
      p.w += dl.w * h3;
      dgp[c] = p;
    }
    const float m1 = block_sum(s1, red) / inner;
    const float m2 = block_sum(s2, red) / inner;
    // dg, then da and dgate in W1's row order
    T* dr = dh + (int64_t)r * 2 * inner;
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      const float4 g = grow[c], gm = gm4[c], dl = dl4[c];
      const float4 a4v = a4[c], gt = gt4[c];
      const float av[4] = {a4v.x, a4v.y, a4v.z, a4v.w};
      const float gv[4] = {gt.x, gt.y, gt.z, gt.w};
      const float hv[4] = {(g.x - mean) * rstd, (g.y - mean) * rstd, (g.z - mean) * rstd,
                           (g.w - mean) * rstd};
      const float ev[4] = {dl.x * gm.x, dl.y * gm.y, dl.z * gm.z, dl.w * gm.w};
      float da[4], dgt[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dg = rstd * (ev[e] - m1 - hv[e] * m2);
        const float ph = phi_cdf(av[e]);
        const float pdf = expf(-0.5f * av[e] * av[e]) * kInvSqrt2Pi;
        dgt[e] = dg * (av[e] * ph);
        da[e] = dg * gv[e] * (ph + av[e] * pdf);
      }
      store4(dr + 4 * c, da[0], da[1], da[2], da[3]);
      store4(dr + inner + 4 * c, dgt[0], dgt[1], dgt[2], dgt[3]);
    }
  }
  float4* out = reinterpret_cast<float4*>(gpart + (int64_t)blockIdx.x * inner);
  for (int c = threadIdx.x; c < n4; c += kThreads) out[c] = dgp[c];
}

template <typename T>
cudaError_t rows_pass(const float* hs, const float* dyln, const float* gamma, T* y, T* dh,
                      float* gpart, int n, int inner, float eps, cudaStream_t s) {
  const size_t bytes = sizeof(float) * 2 * (size_t)inner;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  ffn_bwd_rows_kernel<T><<<blocks, kThreads, bytes, s>>>(hs, dyln, gamma, y, dh, gpart, n,
                                                         inner, eps);
  return cudaGetLastError();
}

}  // namespace

// h_scratch: fp32 (n, 2i); dyln_scratch: fp32 (n, i); y_scratch: (n, i) and
// dh_scratch: (n, 2i) in the dtype; gpart: fp32 (ceil(n / 16), i).
AMT_EXPORT int amt_ffn_bwd(const void* x, const void* w1, const void* gamma,
                           const void* w2, const void* dy, void* h_scratch,
                           void* dyln_scratch, void* y_scratch, void* dh_scratch,
                           void* gpart, void* dx, void* dw1, void* dgamma, void* dw2,
                           int n, int d, int inner, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n % 8 != 0 || d % 8 != 0 || inner % 8 != 0) return cudaErrorInvalidValue;
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
    const auto* xi = static_cast<const bf16*>(x);
    const auto* w1i = static_cast<const bf16*>(w1);
    const auto* w2i = static_cast<const bf16*>(w2);
    const auto* dyi = static_cast<const bf16*>(dy);
    auto* ys = static_cast<bf16*>(y_scratch);
    auto* dhs = static_cast<bf16*>(dh_scratch);
    if ((err = gemm_bf16<kK, kK, float>(xi, d, w1i, d, hs, i2, n, i2, d, s)) != cudaSuccess ||
        (err = gemm_bf16<kK, kR, float>(dyi, d, w2i, inner, dls, inner, n, inner, d, s)) !=
            cudaSuccess ||
        (err = rows_pass<bf16>(hs, dls, gm, ys, dhs, gp, n, inner, eps, s)) != cudaSuccess ||
        (err = colsum(gp, static_cast<float*>(dgamma), blocks, inner, s)) != cudaSuccess ||
        (err = gemm_bf16<kR, kR, float>(dyi, d, ys, inner, dw2f, inner, d, inner, n, s)) !=
            cudaSuccess ||
        (err = gemm_bf16<kK, kR, bf16>(dhs, i2, w1i, d, static_cast<bf16*>(dx), d, n, d, i2,
                                       s)) != cudaSuccess)
      return err;
    return gemm_bf16<kR, kR, float>(dhs, i2, xi, d, dw1f, d, i2, d, n, s);
  }
  if (dtype == AMT_F32) {
    const auto* xi = static_cast<const float*>(x);
    const auto* w1i = static_cast<const float*>(w1);
    const auto* w2i = static_cast<const float*>(w2);
    const auto* dyi = static_cast<const float*>(dy);
    auto* ys = static_cast<float*>(y_scratch);
    auto* dhs = static_cast<float*>(dh_scratch);
    if ((err = gemm_f32<kK, kK>(xi, d, w1i, d, hs, i2, n, i2, d, s)) != cudaSuccess ||
        (err = gemm_f32<kK, kR>(dyi, d, w2i, inner, dls, inner, n, inner, d, s)) !=
            cudaSuccess ||
        (err = rows_pass<float>(hs, dls, gm, ys, dhs, gp, n, inner, eps, s)) != cudaSuccess ||
        (err = colsum(gp, static_cast<float*>(dgamma), blocks, inner, s)) != cudaSuccess ||
        (err = gemm_f32<kR, kR>(dyi, d, ys, inner, dw2f, inner, d, inner, n, s)) !=
            cudaSuccess ||
        (err = gemm_f32<kK, kR>(dhs, i2, w1i, d, static_cast<float*>(dx), d, n, d, i2, s)) !=
            cudaSuccess)
      return err;
    return gemm_f32<kR, kR>(dhs, i2, xi, d, dw1f, d, i2, d, n, s);
  }
  return cudaErrorInvalidValue;
}
