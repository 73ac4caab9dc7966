// Backward of the fused GELU MLP out = gelu(x W1^T + b1) W2^T + b2 (kernel 8;
// csrc/mlp.cu is its forward).
//
// Replaces attention_models_tpu/ops/ffn.py::_mlp_bwd_kernel (entry
// _mlp_bwd), bf16 as there. From x (n, d), W1 (hid, d), b1 (fp32), W2
// (d, hid) -- the torch Linear layout -- and the cotangent dy (n, d) it
// returns dx (n, d) in bf16 and dW1 (hid, d), db1, dW2 (d, hid), db2 in
// fp32, with the TPU kernel's formulas and rounding points: h = x W1^T + b1
// recomputed in fp32, g = bf16(gelu(h)), db2 = sum of dy, dW2 = dy^T g,
// dg = dy W2 in fp32, dh = dg (Phi(h) + h phi(h)), db1 = sum of the fp32
// dh, then dx = bf16(dh) W1 (rounded to bf16) and dW1 = bf16(dh)^T x. gelu
// uses the true erff.
//
// Bound on the H100: operations. Five products of 2 n d hid flops -- the
// recompute x W1^T, dy W2, dW2, dx and dW1 -- are 10 n d hid (PERF.md's
// convention for the ln_mlp backward): at ViT's n 4160, d 1024, hid 2048
// that is 87.2 GFLOP, 0.088 ms at the bf16 tensor-core peak; x, dy, dx,
// the weights and their fp32 gradients are ~43 MB (0.013 ms).
//
// Design. The TPU kernel walks row tiles in order and accumulates the four
// weight and bias gradients in resident fp32 outputs. Blocks run in
// parallel here and no SM holds a 16 MB fp32 partial, so the work is
// kernel 6's passes (csrc/ln_mlp_bwd.cu) on x in place of LN(x), on
// csrc/gemm_sm90.cuh's TMA/wgmma tile product, without atomics (every sum
// in one fixed order, so two calls on the same inputs are bit-equal):
//   1. one dual product over each (128 rows x 128 hidden) tile: H = x W1^T
//      (both K-major) and dG = dy W2 (W2 read MN-major, staged at a 64-byte
//      pitch at every call where hid is not a multiple of 32), both over
//      K = d; the GeluBwd epilogue writes G = bf16(gelu(H + b1)) and
//      bf16(dH) to scratches with 64-byte aligned rows and the fp32 column
//      sums of dH per 64 rows;
//   2. dx = bf16(dH) W1 (W1 read MN-major), rounded to bf16 (StoreBf16);
//   3. dW1 = dH^T x and dW2 = dy^T G (every operand MN-major), fp32, K = n
//      split, where the tiles leave SMs idle, into the plan's ranges whose
//      partials are summed in order (at ViT's shape each is 16 x 8 = 128
//      tiles, one an SM: K whole);
//   4. db1: step 1's partials in order; db2: per-32-row column sums of dy
//      (8 columns a thread), then those partials in order.
// The host plan (ops/ffn.py::mlp_bwd_plan) holds the five products' maps,
// grids, splits, tile widths and shared memory, and the scratches'
// pitches. The scratch (G and dH, 34 MB in bf16 at ViT's shape) is the
// price of products that each run at the tensor cores' rate.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

const void* stage_rows(const int64_t* plan, const void* w, void* stage, int rows,
                       int64_t row_bytes, cudaStream_t s);

namespace {

constexpr int kColRows = 32;   // rows per partial of the db2 column sums
constexpr int kColThreads = 128;

// part[y][c .. c + 7] = the sums of a[r][c .. c + 7] over rows y kColRows ..
// in order: a thread 8 columns, one 16-byte load a row (cols % 8 == 0).
__global__ __launch_bounds__(kColThreads) void colsum_rows_bf16_kernel(
    const bf16* __restrict__ a, float* __restrict__ part, int rows, int cols) {
  const int c = 8 * (blockIdx.x * kColThreads + threadIdx.x);
  if (c >= cols) return;
  const int r0 = blockIdx.y * kColRows, r1 = min(r0 + kColRows, rows);
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = r0; r < r1; ++r) {
    const uint4 u = *reinterpret_cast<const uint4*>(a + (int64_t)r * cols + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] += __bfloat162float(e[j]);
  }
  float4* out = reinterpret_cast<float4*>(part + (int64_t)blockIdx.y * cols + c);
  out[0] = make_float4(s[0], s[1], s[2], s[3]);
  out[1] = make_float4(s[4], s[5], s[6], s[7]);
}

}  // namespace

// plan: ops/ffn.py::GeluBwdPlan, 5 GemmPlans (H, dG, dx, dW1, dW2). x, dy and
// dx (n, d), W1 (hid, d) and W2 (d, hid) contiguous bf16; b1 fp32. Outputs
// in fp32: dw1 (hid, d), db1 (hid,), dw2 (d, hid), db2 (d,). Scratch: g and
// dh (n, hid) bf16 at the H plan's row stride; w2s (d, pitch) bf16 where
// the dG plan stages W2 (else unused); dhpart (2 ceil(n / 128), hid),
// dypart (ceil(n / 32), d) and wpart (splits, hid, d) fp32, the last for
// the weight gradients' split partials.
AMT_EXPORT int amt_mlp_bwd(const int64_t* plan, const void* x, const void* w1,
                           const void* b1, const void* w2, const void* dy, void* dx,
                           void* dw1, void* db1, void* dw2, void* db2, void* g, void* dh,
                           void* w2s, void* dhpart, void* dypart, void* wpart, int n,
                           int d, int hid, void* stream) {
  using sm90::Form;
  using sm90::kK;
  using sm90::kMN;
  constexpr int P = sm90::kPlanValues;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || hid % 8 != 0 || d % 128 != 0 || plan == nullptr)
    return cudaErrorInvalidValue;
  const auto* dyi = static_cast<const bf16*>(dy);
  const auto* w1i = static_cast<const bf16*>(w1);
  auto* gs = static_cast<bf16*>(g);
  auto* dhs = static_cast<bf16*>(dh);
  auto* wp = static_cast<float*>(wpart);
  auto* dyp = static_cast<float*>(dypart);
  const int ld = (int)plan[19];  // G's and dH's row stride
  const void* w2r = stage_rows(plan + P, w2, w2s, d, 2 * (int64_t)hid, s);
  if (w2r == nullptr) return cudaErrorInvalidValue;
  const sm90::GeluBwd::Args ga{static_cast<const float*>(b1), gs, dhs,
                               static_cast<float*>(dhpart), n, hid, ld};
  const sm90::StoreBf16::Args xa{static_cast<bf16*>(dx), n, d, d, 0};
  cudaError_t err;
  if ((err = sm90::gemm_from_plan<Form<kK, kK, kK, kMN>, sm90::GeluBwd, 128>(
           plan, plan + P, x, w1i, dyi, w2r, ga, n, hid, d, ld, s)) != cudaSuccess ||
      (err = sm90::gemm_from_plan<Form<kK, kMN>, sm90::StoreBf16, 128>(
           plan + 2 * P, nullptr, dhs, w1i, nullptr, nullptr, xa, n, d, hid, d, s)) !=
          cudaSuccess ||
      (err = sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(
           plan + 3 * P, dhs, x, static_cast<float*>(dw1), wp, hid, d, n, d, s)) !=
          cudaSuccess ||
      (err = sm90::gemm_f32_from_plan<Form<kMN, kMN>, 128>(
           plan + 4 * P, dyi, gs, static_cast<float*>(dw2), wp, d, hid, n, hid, s)) !=
          cudaSuccess ||
      // db1 over the fp32 dH, one partial row per 64 rows, in order
      (err = colsum(static_cast<const float*>(dhpart), static_cast<float*>(db1),
                    2 * ((n + sm90::kBM - 1) / sm90::kBM), hid, s)) != cudaSuccess)
    return err;
  const int dy_parts = (n + kColRows - 1) / kColRows;
  colsum_rows_bf16_kernel<<<dim3((d / 8 + kColThreads - 1) / kColThreads, dy_parts),
                            kColThreads, 0, s>>>(dyi, dyp, n, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return colsum(dyp, static_cast<float*>(db2), dy_parts, d, s);
}
