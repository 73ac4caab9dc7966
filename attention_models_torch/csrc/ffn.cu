// Fused GEGLU feed-forward: out = LN_gamma(gate * gelu(a)) W2^T with
// [a | gate] = x W1^T, no biases, gelu on the first half, a gamma-only
// LayerNorm (fp32 statistics, biased variance) over the inner width.
//
// Replaces attention_models_tpu/ops/ffn.py::_ffn_kernel (entry fused_ffn /
// _ffn_forward), bf16 and fp32. W1 is (2i, d) and W2 (d, i): the torch
// Linear layout, whose rows are the K-major B operand as they stand.
//
// Bound on the H100: operations. At the MaskGIT decode shape (n = 8192
// rows, d 768, i 4096) the two products are 6*n*d*i = 154.6 GFLOP: 0.156 ms
// at the bf16 tensor-core peak, 2.31 ms at the fp32 FMA peak; x, out and
// the weights are ~44 MB (0.013 ms).
//
// Design. The LayerNorm sits between the two products over the full inner
// width, so a row's W2 product cannot start before all of its g is known.
// The TPU kernel holds a row tile's whole g and both weight matrices in
// VMEM; here a 64-row fp32 g alone is 1 MB. So g goes through a global
// scratch, which keeps the TPU kernel's rounding points exactly (a, gate,
// g and its two-pass statistics in fp32, y = ghat * gamma rounded to the
// dtype before the W2 product), in three launches:
//   1. the GEGLU product. bf16: csrc/gemm_sm90.cuh's TMA/wgmma tile product
//      in its paired-column form (Paired): a block's B tile is two TMA
//      boxes of W1, BN/2 "a" rows and the BN/2 matching "gate" rows, so
//      accumulator columns j and j + BN/2 of a thread are a and gate of one
//      inner column, and the epilogue (sm90::GegluF32, which kernel 20's
//      bf16 up-projection shares) writes g = gate * gelu(a)
//      (true erff; the TPU kernel's A&S polynomial differs by <= 1.5e-7) to
//      an fp32 scratch through the freed ring; W1 is read as it lies, x
//      once for every BN/2 inner columns. fp32: geglu_f32_kernel, the
//      register-tiled FMA product of csrc/gemm.cuh with the B tile's
//      columns 0-63 on W1's "a" rows and 64-127 on the matching "gate"
//      rows, which a thread's two column groups pair;
//   2. ffn_ln_rows_kernel: one block a row, the row read once into
//      registers (16-byte pieces; a row wider than kRowsMax in chunks read
//      again for each step), the two-pass fp32 mean and variance from them,
//      y = (g - mean) * rsqrt(var + eps) * gamma written once in the dtype
//      (64-byte aligned rows);
//   3. out = y W2^T: the tile product with the StoreBf16 epilogue (bf16),
//      csrc/gemm.cuh's FMA product with K split into ordered partials where
//      its last wave would run half empty (fp32).
// The host plan (ops/ffn.py::ffn_plan, 42 int64: the GEGLU product's and
// the W2 product's GemmPlans) holds the maps (W1's B boxes BN/2 rows), the
// tile widths, grids, shared memory and the scratches' row pitches. The
// scratch traffic, g (fp32) written and read once and y written and read
// once, is ~0.06 ms at n 8192 beside the products.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

namespace {

using sm90::gelu_exact;

// fp32 GEGLU product: g (M, inner; rows ldg apart) = gate * gelu(a) of
// x W1^T, one 128 x 64 block of g a block: tile columns 0-63 read W1 rows
// c0 .. c0 + 63 ("a"), 64-127 rows inner + c0 .. ("gate"), so a thread's
// accumulators j and j + 4 are a and gate of g column c0 + 4 tx + j.
__global__ __launch_bounds__(kRThreads, 2) void geglu_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w1,
    float* __restrict__ g, int ldg, int M, int K, int inner) {
  __shared__ __align__(16) RTiles<128> sm;
  const int m0 = blockIdx.y * kRM, c0 = blockIdx.x * 64;
  const int tr = Piece<kK, 128>::tile_row(threadIdx.x);
  const int brow = c0 + tr + (tr < 64 ? 0 : inner - 64);
  float acc[8][8];
  reg_product<128>(plain_piece<kK, kRM>(x, K, M, m0),
                   Piece<kK, 128>(w1, K, brow, true, threadIdx.x), K, sm, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? 4 * ty + i : 60 + 4 * ty + i);
    if (row < M)
      store4(g + (int64_t)row * ldg + c0 + 4 * tx,
             acc[i][4] * gelu_exact(acc[i][0]), acc[i][5] * gelu_exact(acc[i][1]),
             acc[i][6] * gelu_exact(acc[i][2]), acc[i][7] * gelu_exact(acc[i][3]));
  }
}

// y = (g - mean) * rsqrt(var + eps) * gamma for one row of the fp32 scratch
// g a block (row_threads(min(inner, kRowsMax), NV) threads): the mean, then
// the variance over (g - mean), each a fixed-order block sum. A row of at
// most blockDim.x * NV 16-byte pieces is read once and held in registers; a
// wider one is walked in chunks of that many pieces, each of the three
// steps reading its chunks again (4 inner bytes a row, from L2).
template <typename T, int NV>
__global__ __launch_bounds__(256) void ffn_ln_rows_kernel(
    const float* __restrict__ g, int ldg, const float* __restrict__ gamma,
    T* __restrict__ y, int ldy, int inner, float eps) {
  __shared__ float red[32];
  const int n4 = inner / 4, nt = blockDim.x, step = nt * NV;
  // NV 4 serves rows of at most kRowsNV4 columns only, which it holds
  const bool held = NV == 4 || n4 <= step;
  const int chunks = held ? 1 : (n4 + step - 1) / step;
  const float4* gr = reinterpret_cast<const float4*>(g + (int64_t)blockIdx.x * ldg);
  float4 v[NV];
  const auto load = [&](int c0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + threadIdx.x + nt * u;
      v[u] = c < n4 ? gr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float s[1] = {0.f};
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * step;
    load(c0);
#pragma unroll
    for (int u = 0; u < NV; ++u) s[0] += (v[u].x + v[u].y) + (v[u].z + v[u].w);
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
      const float d0 = v[u].x - mean, d1 = v[u].y - mean;
      const float d2 = v[u].z - mean, d3 = v[u].w - mean;
      q[0] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
    }
  }
  block_sums(q, red);
  const float rstd = rsqrtf(q[0] / inner + eps);
  T* out = y + (int64_t)blockIdx.x * ldy;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = k * step;
    if (!held) load(c0);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int c = c0 + threadIdx.x + nt * u;
      if (c >= n4) continue;
      const float4 gm = reinterpret_cast<const float4*>(gamma)[c];
      store4(out + 4 * c, (v[u].x - mean) * rstd * gm.x, (v[u].y - mean) * rstd * gm.y,
             (v[u].z - mean) * rstd * gm.z, (v[u].w - mean) * rstd * gm.w);
    }
  }
}

template <typename T>
cudaError_t ln_rows(const float* g, int ldg, const float* gamma, T* y, int ldy, int n,
                    int inner, float eps, cudaStream_t s) {
  if (inner <= kRowsNV4)
    ffn_ln_rows_kernel<T, 4><<<n, row_threads(inner, 4), 0, s>>>(g, ldg, gamma, y, ldy,
                                                               inner, eps);
  else
    ffn_ln_rows_kernel<T, 8><<<n, row_threads(min(inner, kRowsMax), 8), 0, s>>>(
        g, ldg, gamma, y, ldy, inner, eps);
  return cudaGetLastError();
}

}  // namespace

// plan: ops/ffn.py::FfnPlan (bf16: the GEGLU and W2 products, 42 int64; fp32
// takes none). g_scratch: fp32 (n, inner) and y_scratch: (n, inner) in the
// dtype, at the plan's row pitches (bf16) or inner elements a row (fp32);
// part (fp32 only): 2 n d floats for the W2 product's split partials.
AMT_EXPORT int amt_ffn(const int64_t* plan, const void* x, const void* w1,
                       const void* gamma, const void* w2, void* g_scratch,
                       void* y_scratch, void* part, void* out, int n, int d, int inner,
                       float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (n < 0 || d % 128 != 0 || inner % 128 != 0)
    return cudaErrorInvalidValue;
  const auto* gm = static_cast<const float*>(gamma);
  float* gs = static_cast<float*>(g_scratch);
  cudaError_t err;
  if (dtype == AMT_BF16) {
    constexpr int P = sm90::kPlanValues;
    if (plan == nullptr) return cudaErrorInvalidValue;
    const int ldg = (int)plan[19];         // g's pitch (fp32 elements)
    const int ldy = (int)(plan[P + 2] / 2);  // y's: the W2 product's A map
    auto* ys = static_cast<bf16*>(y_scratch);
    const sm90::GegluF32::Args ga{gs, n, inner, ldg};
    if ((err = sm90::gemm_from_plan<sm90::Paired, sm90::GegluF32, 256>(
             plan, nullptr, x, w1, nullptr, nullptr, ga, n, 2 * inner, d, ldg, s)) !=
            cudaSuccess ||
        (err = ln_rows<bf16>(gs, ldg, gm, ys, ldy, n, inner, eps, s)) != cudaSuccess)
      return err;
    const sm90::StoreBf16::Args oa{static_cast<bf16*>(out), n, d, d, 0};
    return sm90::gemm_from_plan<sm90::Form<sm90::kK, sm90::kK>, sm90::StoreBf16, 128, 256>(
        plan + P, nullptr, ys, w2, nullptr, nullptr, oa, n, d, inner, d, s);
  }
  if (dtype == AMT_F32) {
    auto* ys = static_cast<float*>(y_scratch);
    geglu_f32_kernel<<<dim3(inner / 64, (n + kRM - 1) / kRM), kRThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1), gs, inner, n, d,
        inner);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = ln_rows<float>(gs, inner, gm, ys, inner, n, inner, eps, s)) != cudaSuccess)
      return err;
    return gemm_f32_split<kK, kK>(ys, inner, static_cast<const float*>(w2), inner,
                                  static_cast<float*>(out), d, n, d, inner,
                                  static_cast<float*>(part), 2 * (int64_t)n * d, s);
  }
  return cudaErrorInvalidValue;
}
