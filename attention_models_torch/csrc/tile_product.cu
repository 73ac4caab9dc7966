// csrc/gemm_sm90.cuh's tile product in each operand form, alone: C (M, N)
// = A B^T in fp32 with A and B each K-major or MN-major (form = 2 * A's
// majorness + B's: 0 both K-major, 1 B MN-major, 2 A MN-major, 3 both), K
// split into ordered fp32 partials where the plan says so. No model path
// calls it: chip_smoke.py holds each form against torch.matmul of the same
// views on the card before the kernels built on those forms (kernels 6 and
// 14) are checked, so a wrong descriptor shows by form.
#include "gemm_sm90.cuh"

AMT_EXPORT int amt_tile_product(const int64_t* plan, const void* a, const void* b,
                                void* c, void* part, int m, int n, int k, int ldc,
                                int form, void* stream) {
  using namespace sm90;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(c);
  float* pp = static_cast<float*>(part);
  switch (form) {
    case 0:
      return gemm_f32_from_plan<Form<kK, kK>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 1:
      return gemm_f32_from_plan<Form<kK, kMN>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 2:
      return gemm_f32_from_plan<Form<kMN, kK>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
    case 3:
      return gemm_f32_from_plan<Form<kMN, kMN>, 128>(plan, a, b, out, pp, m, n, k, ldc, s);
  }
  return cudaErrorInvalidValue;
}
