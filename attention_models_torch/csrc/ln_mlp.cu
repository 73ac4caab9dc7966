// Fused pre-LN MLP block: out = x + gelu(LN(x) * g + b @ W1^T + b1) @ W2^T + b2.
//
// Replaces attention_models_tpu/ops/ffn.py::_ln_mlp_kernel (entry
// fused_ln_mlp / _ln_mlp_forward), bf16 only as there, at every width the
// gate sends (d % 128 == 0). W1 is (hid, d) and W2 (d, hid), the torch
// Linear layout.
//
// Bound on the H100: operations. At the main path's 8192 rows, d 512 and hid
// 1368 the two products are 4*n*d*hid = 22.9 GFLOP against 19 MB of x, out
// and weights, about 23 us at the bf16 tensor-core peak.
//
// Design: the LayerNorm kernel (csrc/layernorm.cu: fp32 statistics, biased
// variance, Y = bf16((x - mean) * rstd * gamma + beta) rounded once, the TPU
// kernel's rounding point) writes Y into a bf16 (n, d) scratch, then kernel
// 7's two tile products (csrc/mlp.cu on csrc/gemm_sm90.cuh) run on it with
// the residual x added in the second product's epilogue to the fp32 sum:
// three launches, one rounding at the end. Y (8 MB) and g (22 MB) stay in L2
// at the main path's shape. The TPU kernel's single pass keeps the weights
// resident in VMEM and h on chip; on an SM a (64, d) fp32 output tile does
// not fit a warpgroup's registers above d 256, so a single pass would
// re-stream the weights from L2 for every 64 rows (the mma.sync single pass
// this replaces read 358 MB of L2 a call against 19 MB of unique bytes).
// Tried and left out (one H100): folding the LayerNorm into the first
// product, a statistics pass and each consumer normalising its rows of every
// A stage in shared memory before its wgmma, was slower than this pass at
// every width measured: the normalisation sits on each K slice's critical
// path and is repeated for every column tile of the product.
#include "common.cuh"

using bf16 = __nv_bfloat16;

extern "C" int amt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int64_t n, int d, float eps, int dtype, void* stream);
cudaError_t amt_mlp_sm90(const int64_t* plan, const bf16* x, const bf16* w1,
                         const void* b1, const bf16* w2, const void* b2,
                         const bf16* res, bf16* g_scratch, bf16* w2_stage,
                         bf16* out, int n, int d, int hid, int bias_dtype,
                         cudaStream_t s);

// y_scratch (n, d) and g_scratch (n, hid), bf16; w2_stage (d, pitch) or
// null (csrc/mlp.cu); plan: the MLP plan of y, W1 and W2 (ops/ffn.py::
// mlp_plan, 42 int64); lng and lnb fp32, b1 and b2 fp32 or (bias_dtype
// AMT_BF16) bf16.
AMT_EXPORT int amt_ln_mlp(const void* x, const void* lng, const void* lnb,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, void* y_scratch,
                          void* g_scratch, void* w2_stage, const int64_t* plan,
                          int n, int d, int hid, float eps, int bias_dtype,
                          void* stream) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || hid % 8 != 0 || d % 128 != 0 || y_scratch == nullptr ||
      g_scratch == nullptr)
    return cudaErrorInvalidValue;
  const int err = amt_layernorm(x, lng, lnb, y_scratch, n, d, eps, AMT_BF16, stream);
  if (err != cudaSuccess) return err;
  return amt_mlp_sm90(plan, static_cast<const bf16*>(y_scratch),
                      static_cast<const bf16*>(w1), b1, static_cast<const bf16*>(w2), b2,
                      static_cast<const bf16*>(x), static_cast<bf16*>(g_scratch),
                      static_cast<bf16*>(w2_stage), static_cast<bf16*>(out), n, d,
                      hid, bias_dtype,
                      static_cast<cudaStream_t>(stream));
}
