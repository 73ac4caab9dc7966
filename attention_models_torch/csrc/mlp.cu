// Fused GELU MLP: out = gelu(x W1^T + b1) W2^T + b2 (kernel 7).
//
// Replaces attention_models_tpu/ops/ffn.py::_mlp_kernel (entry fused_mlp /
// _mlp_forward), bf16 only as there. W1 is (hid, d) and W2 (d, hid): the
// torch Linear layout, whose rows are the B operand of csrc/gemm.cuh's kK
// tiles as they stand. b1 and b2 are fp32. The TPU kernel's rounding points
// are kept: h = x W1^T + b1 and its gelu in fp32 (the true erff; the TPU
// kernel's A&S polynomial differs by at most 1.5e-7), g rounded to bf16
// before the W2 product, b2 added to the fp32 sum, one rounding at the end.
//
// Bound on the H100: operations. At ViT's n 4160 (64 images x 65 tokens),
// d 1024, hid 2048 the two products are 4*n*d*hid = 34.9 GFLOP, 0.035 ms at
// the bf16 tensor-core peak; x, out and the weights are ~25 MB (0.0075 ms).
//
// Design. The TPU kernel keeps both weight matrices resident in VMEM and a
// row tile's h on chip. A (64, d) fp32 accumulator and the weight chunks do
// not fit one SM's shared memory at d 1024 (csrc/ln_mlp.cu's single pass
// stops at d 512), so this takes two launches of csrc/gemm.cuh's tile
// product (128 x 128 tiles, mma.sync m16n8k16, three cp.async stages):
//   1. g = bf16(gelu(x W1^T + b1)) into a bf16 (n, hid) scratch;
//   2. out = bf16(g W2^T + b2 (+ residual)).
// The scratch costs one write and one read per output column tile of g
// (17 MB at ViT's shape, mostly from L2). The optional residual of the
// second epilogue serves the wide pre-LN block (csrc/ln_mlp.cu at d > 512).
// wgmma, TMA and keeping g on chip are what later PRs tune.
#include "gemm.cuh"

namespace {

enum Epilogue { kBiasGelu = 0, kBias = 1 };

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// C (M, N) = epilogue(A B^T + bias) for A (M, K) and B (N, K), both
// row-major; kBias adds res (M, N) when it is not null.
template <int E>
__global__ __launch_bounds__(kThreads) void mlp_tile_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, const float* __restrict__ bias,
    const bf16* __restrict__ res, bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  float acc[4][4][4];
  mma_tile<kK, kK>(A, K, M, B, K, N, K, m0, n0, reinterpret_cast<bf16*>(smem_raw), acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * t;
        if (col >= N) continue;
        float v0 = acc[mt][nt][2 * half] + bias[col];
        float v1 = acc[mt][nt][2 * half + 1] + bias[col + 1];
        if (E == kBiasGelu) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
        } else if (res != nullptr) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(res + (int64_t)row * N + col);
          v0 += __bfloat162float(r.x);
          v1 += __bfloat162float(r.y);
        }
        store2(C + (int64_t)row * N + col, v0, v1);
      }
    }
}

template <int E>
cudaError_t mlp_tile(const bf16* A, const bf16* B, const float* bias, const bf16* res,
                     bf16* C, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_tile_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  mlp_tile_kernel<E><<<grid, kThreads, kTileSmem, s>>>(A, B, bias, res, C, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// Kernel 7's two launches, g_scratch (n, hid) bf16; res (n, d) or null.
// csrc/ln_mlp.cu's wide path calls it with the residual x.
cudaError_t amt_mlp_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1, const float* b1,
                         const __nv_bfloat16* w2, const float* b2, const __nv_bfloat16* res,
                         __nv_bfloat16* g_scratch, __nv_bfloat16* out, int n, int d, int hid,
                         cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  if (n < 0 || d % 8 != 0 || hid % 8 != 0) return cudaErrorInvalidValue;
  cudaError_t err = mlp_tile<kBiasGelu>(x, w1, b1, nullptr, g_scratch, n, hid, d, s);
  if (err != cudaSuccess) return err;
  return mlp_tile<kBias>(g_scratch, w2, b2, res, out, n, d, hid, s);
}

AMT_EXPORT int amt_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* g_scratch, void* out, int n, int d, int hid,
                       void* stream) {
  return amt_mlp_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
                      static_cast<const float*>(b2), nullptr, static_cast<bf16*>(g_scratch),
                      static_cast<bf16*>(out), n, d, hid, static_cast<cudaStream_t>(stream));
}
