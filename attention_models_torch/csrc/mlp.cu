// Fused GELU MLP: out = gelu(x W1^T + b1) W2^T + b2 (kernel 7), and the two
// products of the pre-LN MLP block (kernel 2, csrc/ln_mlp.cu).
//
// Replaces attention_models_tpu/ops/ffn.py::_mlp_kernel (entry fused_mlp /
// _mlp_forward), bf16 only as there. W1 is (hid, d) and W2 (d, hid): the
// torch Linear layout, whose rows are wgmma's K-major B operand as they
// stand. b1 and b2 are fp32 or bf16. The TPU kernel's rounding points are
// kept: h = x W1^T + b1 and its gelu in fp32 (the true erff; the TPU
// kernel's A&S polynomial differs by at most 1.5e-7), g rounded to bf16
// before the W2 product, b2 (and the residual) added to the fp32 sum, one
// rounding at the end.
//
// Bound on the H100: operations. At ViT's n 4160 (64 images x 65 tokens),
// d 1024, hid 2048 the two products are 4*n*d*hid = 34.9 GFLOP, 0.035 ms at
// the bf16 tensor-core peak; x, out and the weights are ~25 MB (0.0075 ms).
//
// Design. The TPU kernel keeps both weight matrices resident in VMEM and a
// row tile's h on chip. On Hopper a block that kept a (rows, d) fp32 output
// in registers would need 64 * d / 128 registers a thread per 64-row
// warpgroup (512 at d 1024), so the on-chip fusion either re-streams the
// weights for every 64 rows or idles half the SMs. This takes two launches
// of csrc/gemm_sm90.cuh's TMA/wgmma tile product instead:
//   1. g = bf16(gelu(x W1^T + b1)) into a bf16 (n, hid) scratch;
//   2. out = bf16(g W2^T + b2 (+ residual)).
// The scratch (17 MB at ViT's shape) stays in the 50 MB L2 between them; its
// rows, and those of W2, are what the second product's TMA reads. Where the
// hidden width is not a multiple of 32, W2's rows would start only 16-byte
// aligned: each call first copies W2 into a scratch with 64-byte aligned
// rows (one cudaMemcpy2DAsync on the stream, 1.4 MB at ViTVQGAN's shape),
// so the products read the weight they are given at this call, never a
// copy held from an earlier one. The residual of the second epilogue serves
// the pre-LN block (csrc/ln_mlp.cu). The host plan (ops/ffn.py::mlp_plan,
// 42 int64: the two products' GemmPlans) holds both products' maps, tile
// widths, grids, shared memory and output row strides.
#include "gemm_sm90.cuh"

using bf16 = __nv_bfloat16;

// A weight of `rows` rows of `row_bytes` (W2, bf16 or int8) as the B map of
// `plan` reads it: the weight itself when the map's row pitch is its own,
// else `stage` after copying it to the map's pitch; null if the plan's pitch
// needs a stage that is missing. Called at every launch: the products read
// the weight they are given at this call.
const void* stage_rows(const int64_t* plan, const void* w, void* stage,
                       int rows, int64_t row_bytes, cudaStream_t s) {
  const int64_t pitch = plan[8];  // the B map's row bytes
  if (pitch == row_bytes) return w;
  if (stage == nullptr || pitch < row_bytes) return nullptr;
  if (cudaMemcpy2DAsync(stage, pitch, w, (size_t)row_bytes, (size_t)row_bytes,
                        rows, cudaMemcpyDeviceToDevice, s) != cudaSuccess)
    return nullptr;
  return stage;
}

// The two products from an MLP plan: x (n, d) and W1 (hid, d) with d
// elements a row; g_scratch at the row stride of the plan; W2 (d, hid)
// contiguous, staged into w2_stage at the plan's pitch where it differs;
// b1 and b2 fp32 or, with bias_dtype AMT_BF16, bf16; res (n, d) or null.
cudaError_t amt_mlp_sm90(const int64_t* plan, const bf16* x, const bf16* w1,
                         const void* b1, const bf16* w2, const void* b2,
                         const bf16* res, bf16* g_scratch, bf16* w2_stage,
                         bf16* out, int n, int d, int hid, int bias_dtype,
                         cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  using namespace sm90;
  // the first product writes g with the row stride the second reads it at
  if (n < 0 || plan == nullptr || d % 8 != 0 || hid % 8 != 0 ||
      plan[kPlanValues + 2] != 2 * plan[19] ||
      (bias_dtype != AMT_F32 && bias_dtype != AMT_BF16))
    return cudaErrorInvalidValue;
  const int bf = bias_dtype == AMT_BF16;
  const GemmArgs up{b1, nullptr, g_scratch, n, hid, d, (int)plan[19], bf};
  cudaError_t err = gemm_from_plan<Form<kK, kK>, BiasGelu, 128, 256>(
      plan, nullptr, x, w1, nullptr, nullptr, up, n, hid, d, up.ldc, s);
  if (err != cudaSuccess) return err;
  const void* w2r = stage_rows(plan + kPlanValues, w2, w2_stage, d, 2 * (int64_t)hid, s);
  if (w2r == nullptr) return cudaErrorInvalidValue;
  const GemmArgs down{b2, res, out, n, d, hid, d, bf};
  return gemm_from_plan<Form<kK, kK>, BiasResidual, 128, 256>(
      plan + kPlanValues, nullptr, g_scratch, w2r, nullptr, nullptr, down, n,
      d, hid, d, s);
}

// Kernel 7's two launches: g_scratch (n, hid) bf16 at the plan's row stride;
// w2_stage (d, pitch) or null where W2 needs no stage; res (n, d) or null.
AMT_EXPORT int amt_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* res, void* g_scratch,
                       void* w2_stage, void* out, const int64_t* plan, int n, int d,
                       int hid, int bias_dtype, void* stream) {
  return amt_mlp_sm90(plan, static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                      b1, static_cast<const bf16*>(w2), b2, static_cast<const bf16*>(res),
                      static_cast<bf16*>(g_scratch), static_cast<bf16*>(w2_stage),
                      static_cast<bf16*>(out), n, d, hid, bias_dtype,
                      static_cast<cudaStream_t>(stream));
}
