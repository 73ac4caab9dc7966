// Backward of the fused pre-LN MLP block out = x + gelu(LN(x) W1^T + b1) W2^T + b2.
//
// Replaces attention_models_tpu/ops/ffn.py::_ln_mlp_bwd_kernel (entry
// _ln_mlp_bwd), bf16 as there, at every width the gate sends (d % 128 ==
// 0). From x, the LN affine, W1 (hid, d), b1, W2 (d, hid) and the cotangent
// dy it recomputes LN -> W1 -> gelu and produces dx (with the residual and
// the LN backward) in bf16 and dlng, dlnb, dW1, db1, dW2, db2 in fp32. gelu
// uses the true erff (the TPU kernel used the A&S 7.1.26 polynomial, at
// most 1.5e-7 away). The rounding points are the TPU kernel's: yc, G and dH
// in bf16, db1 over the fp32 dH, dy_ln in fp32.
//
// Bound on the H100: operations. Its five products (the H recompute, dG,
// dy_ln, dW1, dW2) are 10*n*d*hid flops: at the main path's n 8192, d 512,
// hid 1368 that is 58 us at the bf16 tensor-core peak, against ~33 MB of
// inputs and outputs (10 us).
//
// Design. The TPU kernel adds the weight gradients over a sequential grid
// into resident outputs; on the H100 blocks run in parallel, so the work is
// a pipeline of csrc/gemm_sm90.cuh's TMA/wgmma tile products (no atomics,
// every sum in one fixed order):
//   1. LayerNorm (csrc/layernorm.cu, kernel 3's pass): yc = bf16(LN(x)), as
//      kernel 2's forward writes it;
//   2. one dual product over each (128 rows x 128 hidden) tile: H = yc
//      W1^T (both K-major) and dG = dy W2 (W2 read MN-major), both over K =
//      d, so one ring stage carries the four tiles; the epilogue forms
//      G = bf16(gelu(H + b1)) and dH = dG gelu'(H + b1) with the true erff,
//      writes G and bf16(dH) to scratches with 64-byte aligned rows and the
//      fp32 column sums of dH (before the rounding) per 64 rows, for db1
//      (sm90::GeluBwd, csrc/gemm_sm90.cuh, which kernel 8 shares);
//   3. dy_ln = dH W1 (W1 read MN-major), fp32;
//   4. dW1 = dH^T yc and dW2 = dy^T G (both operands MN-major), fp32, K = n
//      split into the plan's ranges whose partials are summed in order (the
//      two gradients are 2 x 44 tiles at the main path's shape, fewer than
//      the SMs);
//   5. the LN backward (ln_bwd_rows_kernel): a warp a row for the row
//      statistics, then 16-byte row pieces for dx = dy + rstd (dxhat -
//      mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dy_ln * lng, and the
//      block's column sums of dy_ln * xhat, dy_ln and dy, summed in order
//      into dlng, dlnb and db2.
// The host plan (ops/ffn.py::ln_mlp_bwd_plan) holds the five products'
// maps, grids, splits, tile widths and shared memory, and the scratches'
// pitches. The scratch (yc, G, dH, dy_ln: 56 MB at the main path) is the
// price of products that each run at the tensor cores' rate.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

extern "C" int amt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int64_t n, int d, float eps, int dtype, void* stream);
const void* stage_rows(const int64_t* plan, const void* w, void* stage, int rows,
                       int64_t row_bytes, cudaStream_t s);

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kRows = 32;  // rows per block of the LN backward

// The LN backward over a block of kRows rows, 256 threads. Phase 1, a warp
// a row: the two-pass fp32 statistics of x (mean, rstd) and the row means
// m1 of dxhat = dy_ln * lng and m2 of dxhat * xhat, by shuffles. Phase 2,
// a thread an 8-column piece of a row group (rows g, g + groups, ... of
// the block, 16-byte loads): dx = dy + rstd (dxhat - m1 - xhat m2), and
// the piece's column sums of dy_ln * xhat, dy_ln and dy (for dlng, dlnb and
// db2) over its rows in order; the row groups' sums then add in order
// through shared memory into part (gridDim.x, 3, d).
__global__ __launch_bounds__(kThreads) void ln_bwd_rows_kernel(
    const bf16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ dyln, const bf16* __restrict__ dy,
    bf16* __restrict__ dx, float* __restrict__ part, int n, int d, float eps) {
  __shared__ float stats[kRows][4];       // mean, rstd, m1, m2
  __shared__ float red[3][kThreads * 8];  // [kind][row group][piece column]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, n - row0);
  for (int rr = warp; rr < rows; rr += kThreads / 32) {
    const __nv_bfloat162* xr =
        reinterpret_cast<const __nv_bfloat162*>(x + (int64_t)(row0 + rr) * d);
    const float2* gr = reinterpret_cast<const float2*>(dyln + (int64_t)(row0 + rr) * d);
    const float2* lg = reinterpret_cast<const float2*>(lng);
    float s = 0.f;
    for (int c = lane; c < d / 2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      s += v.x + v.y;
    }
    const float mean = warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d / 2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      q += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float rstd = rsqrtf(warp_sum(q) / d + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d / 2; c += 32) {
      const float2 v = __bfloat1622float2(xr[c]);
      const float2 g = gr[c], l = lg[c];
      const float d0 = g.x * l.x, d1 = g.y * l.y;
      s1 += d0 + d1;
      s2 += d0 * ((v.x - mean) * rstd) + d1 * ((v.y - mean) * rstd);
    }
    const float m1 = warp_sum(s1) / d, m2 = warp_sum(s2) / d;
    if (lane == 0) {
      stats[rr][0] = mean;
      stats[rr][1] = rstd;
      stats[rr][2] = m1;
      stats[rr][3] = m2;
    }
  }
  __syncthreads();
  // phase 2: `span` pieces of 8 columns side by side, `groups` row groups
  // (d > 2048: several passes of 256 pieces, one group)
  const int pieces = d / 8, span = min(pieces, kThreads);
  const int groups = kThreads / span;
  const int rg = threadIdx.x / span, pc = threadIdx.x % span;
  for (int p0 = 0; p0 < pieces; p0 += span) {
    const int col = (p0 + pc) * 8;
    float acc[3][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[0][j] = acc[1][j] = acc[2][j] = 0.f;
    if (rg < groups && col < d) {
      float l[8];
      *reinterpret_cast<float4*>(l) = *reinterpret_cast<const float4*>(lng + col);
      *reinterpret_cast<float4*>(l + 4) = *reinterpret_cast<const float4*>(lng + col + 4);
      for (int rr = rg; rr < rows; rr += groups) {
        const int64_t at = (int64_t)(row0 + rr) * d + col;
        const uint4 xv = *reinterpret_cast<const uint4*>(x + at);
        const uint4 yv = *reinterpret_cast<const uint4*>(dy + at);
        float g[8];
        *reinterpret_cast<float4*>(g) = *reinterpret_cast<const float4*>(dyln + at);
        *reinterpret_cast<float4*>(g + 4) = *reinterpret_cast<const float4*>(dyln + at + 4);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
        const bf16* ye = reinterpret_cast<const bf16*>(&yv);
        const float mean = stats[rr][0], rstd = stats[rr][1];
        const float m1 = stats[rr][2], m2 = stats[rr][3];
        uint4 out;
        uint32_t* o = reinterpret_cast<uint32_t*>(&out);
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = (__bfloat162float(xe[j]) - mean) * rstd;
          const float yj = __bfloat162float(ye[j]);
          v[j] = yj + rstd * (g[j] * l[j] - m1 - xh * m2);
          acc[0][j] += g[j] * xh;
          acc[1][j] += g[j];
          acc[2][j] += yj;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
        *reinterpret_cast<uint4*>(dx + at) = out;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[k][threadIdx.x * 8 + j] = acc[k][j];
    __syncthreads();
    for (int c = threadIdx.x; c < span * 8; c += kThreads) {
      if (p0 * 8 + c >= d) continue;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float sum = 0.f;
        for (int gi = 0; gi < groups; ++gi) sum += red[k][gi * span * 8 + c];
        part[((int64_t)blockIdx.x * 3 + k) * d + p0 * 8 + c] = sum;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// plan: ops/ffn.py::GeluBwdPlan, 5 GemmPlans (H, dG, dy_ln, dW1, dW2). x,
// dy, dx (n, d) and W1 (hid, d), W2 (d, hid) contiguous bf16; lng, lnb,
// b1 fp32. Outputs in fp32: dw1 (hid, d), db1 (hid,), dw2 (d, hid) and
// lnbias (3, d): the rows dlng, dlnb, db2. Scratch: yc (n, d) bf16; g and
// dh (n, hid) bf16 at the H plan's row stride; w2s (d, pitch) bf16 where
// the dG plan stages W2 (else unused); dyln (n, d) fp32; dhpart
// (2 ceil(n / 128), hid) and part (ceil(n / 32), 3, d) fp32; wpart
// (splits, hid, d) fp32 for the weight gradients' split partials.
AMT_EXPORT int amt_ln_mlp_bwd(const int64_t* plan, const void* x, const void* lng,
                              const void* lnb, const void* w1, const void* b1,
                              const void* w2, const void* dy, void* dx, void* dw1,
                              void* db1, void* dw2, void* lnbias, void* yc, void* g,
                              void* dh, void* w2s, void* dyln, void* dhpart, void* part,
                              void* wpart, int n, int d, int hid, float eps,
                              void* stream) {
  using sm90::Form;
  using sm90::kK;
  using sm90::kMN;
  constexpr int P = sm90::kPlanValues;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || hid % 8 != 0 || d % 128 != 0 || plan == nullptr)
    return cudaErrorInvalidValue;
  const auto* xi = static_cast<const bf16*>(x);
  const auto* dyi = static_cast<const bf16*>(dy);
  const auto* w1i = static_cast<const bf16*>(w1);
  auto* yci = static_cast<bf16*>(yc);
  auto* gs = static_cast<bf16*>(g);
  auto* dhs = static_cast<bf16*>(dh);
  auto* dyl = static_cast<float*>(dyln);
  auto* wp = static_cast<float*>(wpart);
  auto* parti = static_cast<float*>(part);
  const int ld = (int)plan[19];  // G's and dH's row stride
  cudaError_t err = static_cast<cudaError_t>(
      amt_layernorm(x, lng, lnb, yc, n, d, eps, AMT_BF16, stream));
  if (err != cudaSuccess) return err;
  const void* w2r = stage_rows(plan + P, w2, w2s, d, 2 * (int64_t)hid, s);
  if (w2r == nullptr) return cudaErrorInvalidValue;
  const sm90::GeluBwd::Args ga{static_cast<const float*>(b1), gs, dhs,
                         static_cast<float*>(dhpart), n, hid, ld};
  if ((err = sm90::gemm_from_plan<Form<kK, kK, kK, kMN>, sm90::GeluBwd, 128>(
           plan, plan + P, yci, w1i, dyi, w2r, ga, n, hid, d, ld, s)) != cudaSuccess ||
      (err = sm90::gemm_f32_from_plan<Form<kK, kMN>, 128>(plan + 2 * P, dhs, w1i, dyl, wp, n,
                                                           d, hid, d, s)) != cudaSuccess ||
      (err = sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(
           plan + 3 * P, dhs, yci, static_cast<float*>(dw1), wp, hid, d, n, d, s)) !=
          cudaSuccess ||
      (err = sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(
           plan + 4 * P, dyi, gs, static_cast<float*>(dw2), wp, d, hid, n, hid, s)) !=
          cudaSuccess ||
      // db1 over the fp32 dH, one partial row per 64 rows, in order
      (err = colsum(static_cast<const float*>(dhpart), static_cast<float*>(db1),
                    2 * ((n + sm90::kBM - 1) / sm90::kBM), hid, s)) != cudaSuccess)
    return err;
  // the LN backward into dx; dlng, dlnb and db2 from its blocks' partials,
  // in order: part's (blocks, 3 d) rows summed into lnbias (3 d)
  const int blocks = (n + kRows - 1) / kRows;
  ln_bwd_rows_kernel<<<blocks, kThreads, 0, s>>>(
      xi, static_cast<const float*>(lng), dyl, dyi, static_cast<bf16*>(dx), parti, n, d,
      eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return colsum(parti, static_cast<float*>(lnbias), blocks, 3 * d, s);
}
