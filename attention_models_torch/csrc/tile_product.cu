// The tile products alone, in each operand form, with an fp32 result:
//   amt_tile_product:     csrc/gemm_sm90.cuh's TMA/wgmma product of bf16
//                         operands, C (M, N) = A B^T with A and B each
//                         K-major or MN-major (form = 2 * A's majorness +
//                         B's: 0 both K-major, 1 B MN-major, 2 A MN-major,
//                         3 both), K split into ordered fp32 partials where
//                         the plan says so;
//   amt_tile_product_f32: csrc/gemm.cuh's register-tiled FMA product
//                         (gemm_f32) of fp32 operands, A and B each kK or kR
//                         (form alike: 2 * A's layout + B's), at tile width
//                         tn (128 or 64; 0: gemm_f32's own choice).
//   amt_tile_product_s8:  the int8 form (sm90::S8) with the DequantStore
//                         epilogue: C = (float(A B^T) * s_row) * s_col in
//                         fp32, A (M, K) and B (N, K) int8, K-major.
// No model path calls them: chip_smoke.py holds each form against
// torch.matmul of the same views on the card (the int8 form against
// torch._int_mm, bit for bit, with unit scales) before the kernels built on
// those forms (6, 11, 12, 14 and 20) are checked, so a wrong descriptor or
// layout shows by form.
#include "gemm.cuh"
#include "gemm_sm90.cuh"

AMT_EXPORT int amt_tile_product(const int64_t* plan, const void* a, const void* b,
                                void* c, void* part, int m, int n, int k, int ldc,
                                int form, void* stream) {
  using sm90::Form;
  using sm90::gemm_f32_from_plan;
  using sm90::kMN;
  constexpr int kKM = sm90::kK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  float* pp = static_cast<float*>(part);
  switch (form) {
    case 0:
      return gemm_f32_from_plan<Form<kKM, kKM>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 1:
      return gemm_f32_from_plan<Form<kKM, kMN>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 2:
      return gemm_f32_from_plan<Form<kMN, kKM>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 3:
      return gemm_f32_from_plan<Form<kMN, kMN>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
  }
  return cudaErrorInvalidValue;
}

// A (M, K) at lda, B (N, K) at ldb, in the layouts of `form`; C (M, N)
// contiguous.
AMT_EXPORT int amt_tile_product_f32(const void* a, int lda, const void* b, int ldb,
                                    void* c, int m, int n, int k, int form, int tn,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(a);
  const auto* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  switch (form) {
    case 0:
      return gemm_f32_tn<kK, kK>(A, lda, B, ldb, C, n, m, n, k, tn, s);
    case 1:
      return gemm_f32_tn<kK, kR>(A, lda, B, ldb, C, n, m, n, k, tn, s);
    case 2:
      return gemm_f32_tn<kR, kK>(A, lda, B, ldb, C, n, m, n, k, tn, s);
    case 3:
      return gemm_f32_tn<kR, kR>(A, lda, B, ldb, C, n, m, n, k, tn, s);
  }
  return cudaErrorInvalidValue;
}

// plan: one GemmPlan of the int8 form at tile width 128; C (M, N) fp32,
// rows ldc apart.
AMT_EXPORT int amt_tile_product_s8(const int64_t* plan, const void* a, const void* b,
                                   const void* s_row, const void* s_col, void* c,
                                   int m, int n, int k, int ldc, void* stream) {
  const sm90::DequantStore<float>::Args args{static_cast<float*>(c),
                                             static_cast<const float*>(s_row),
                                             static_cast<const float*>(s_col), m, n,
                                             ldc};
  return sm90::gemm_from_plan<sm90::S8, sm90::DequantStore<float>, 128>(
      plan, nullptr, a, b, nullptr, nullptr, args, m, n, k, ldc,
      static_cast<cudaStream_t>(stream));
}
