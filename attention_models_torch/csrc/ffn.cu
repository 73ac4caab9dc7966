// Fused GEGLU feed-forward: out = LN_gamma(gate * gelu(a)) W2^T with
// [a | gate] = x W1^T, no biases, gelu on the first half, a gamma-only
// LayerNorm (fp32 statistics, biased variance) over the inner width.
//
// Replaces attention_models_tpu/ops/ffn.py::_ffn_kernel (entry fused_ffn /
// _ffn_forward), bf16 and fp32. W1 is (2i, d) and W2 (d, i): the torch
// Linear layout, whose rows are the "col" B operand of mma.sync as they
// stand.
//
// Bound on the H100: operations. At the MaskGIT decode shape (n = 8192
// rows, d 768, i 4096) the two products are 6*n*d*i = 154.6 GFLOP: 0.156 ms
// at the bf16 tensor-core peak, 2.31 ms at the fp32 FMA peak; x, out and
// the weights are ~44 MB (0.013 ms).
//
// Design. The LayerNorm sits between the two products over the full inner
// width 4096, so a row's W2 product cannot start before all of its g is
// known. The TPU kernel holds a row tile's whole g and both weight matrices
// in 100 MB of VMEM; here a 64-row fp32 g alone is 1 MB. Of the three ways
// (a small row tile's g in shared memory; accumulating (g*gamma) W2 per
// chunk beside sum(g), sum(g^2) and correcting at the end; a global g
// scratch) this takes the third, because it keeps the TPU kernel's rounding
// points exactly -- g and its statistics in fp32, the variance over
// (g - mean) in a second pass, y = ghat * gamma rounded to the tower dtype
// before the W2 product -- and each of its three launches is a simple
// kernel:
//   1. gemm_geglu: H = x W1^T in 128 x 128 tiles (mma.sync m16n8k16 bf16,
//      fp32 accumulators; an exact FMA tile in fp32) whose B rows interleave
//      8 "a" rows of W1 with their 8 "gate" rows, so each thread holds a and
//      gate of the same (row, column) and writes g = gate * gelu(a) (true
//      erff; the TPU kernel's A&S polynomial differs by <= 1.5e-7) to an
//      fp32 scratch (n, i). H never reaches device memory.
//   2. ln_rows: one block a row, two-pass fp32 mean and variance of g, then
//      y = (g - mean) * rsqrt(var + eps) * gamma in the tower dtype.
//   3. out = y W2^T: the same tiles, csrc/gemm.cuh's plain product.
// The cost is the scratch: g is written once and read three times (fp32,
// 134 MB at n 8192) and y is written once and read once per 128-column
// output tile -- ~0.1 ms of traffic beside the 0.156 ms bound. The weights
// (19 MB in bf16) are streamed through shared memory by cp.async in 32-deep
// K slices (three stages) and stay in the 50 MB L2 across the tiles.
// mma.sync in place of wgmma, and the scratch, are what later PRs tune.
#include "gemm.cuh"

namespace {

constexpr int kLds = kLdK;  // shared row stride (bf16) of the A and B tiles

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// H = x W1^T for bf16 x (M, K) and W1 (2 * inner, K), both row-major: tile
// column c of block column bx reads W1 row bx*64 + (c/16)*8 + c%8, plus
// inner when (c/8) is odd; the block writes g = gate * gelu(a) for inner
// columns bx*64 .. bx*64+63 to fp32 C (M, inner).
__global__ __launch_bounds__(kThreads) void gemm_geglu_bf16_kernel(
    const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
    float* __restrict__ c, int M, int K, int inner) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][kBM][kLds]
  __nv_bfloat16* bs = as + kStages * kBM * kLds;                   // [kStages][kBN][kLds]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4;  // rows wm*64 .. +63 of the tile
  const int wn = warp % 4;  // columns wn*32 .. +31 of the tile
  const int m0 = blockIdx.y * kBM;

  // each thread copies two 16-byte pieces of A and two of B per stage
  const __nv_bfloat16* a_src[2];
  const __nv_bfloat16* b_src[2];
  bool a_ok[2];
  int s_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kThreads;
    const int r = id >> 2, kc = (id & 3) * 8;
    a_ok[i] = m0 + r < M;
    a_src[i] = a + (int64_t)(a_ok[i] ? m0 + r : 0) * K + kc;
    const int brow = blockIdx.x * 64 + (r >> 4) * 8 + (r & 7) + ((r >> 3) & 1) * inner;
    b_src[i] = b + (int64_t)brow * K + kc;
    s_off[i] = r * kLds + kc;
  }
  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cp_async16(as + stage * kBM * kLds + s_off[i], a_src[i] + k0, a_ok[i]);
      cp_async16(bs + stage * kBN * kLds + s_off[i], b_src[i] + k0, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int KT = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // slice kt has landed for this thread
    __syncthreads();               // ... for every thread; slice kt-1 is done
    const int nk = kt + kStages - 1;
    if (nk < KT) load_stage(nk % kStages, nk * kBK);
    cp_async_commit();
    const __nv_bfloat16* at = as + (kt % kStages) * kBM * kLds;
    const __nv_bfloat16* bt = bs + (kt % kStages) * kBN * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const __nv_bfloat16* p = at + (wm * 64 + mt * 16 + g) * kLds + kk + 2 * t;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* p = bt + (wn * 32 + nt * 8 + g) * kLds + kk + 2 * t;
        bf[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16_16816(acc[mt][nt], af[mt], bf[nt]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mt * 16 + g + half * 8;
      if (row >= M) continue;
      // tiles nt = 0, 1 (and 2, 3) hold a and gate of the same 8 columns
      float* out = c + (int64_t)row * inner;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int col = blockIdx.x * 64 + (wn * 2 + p) * 8 + 2 * t;
        *reinterpret_cast<float2*>(out + col) = make_float2(
            acc[mt][2 * p + 1][2 * half] * gelu_exact(acc[mt][2 * p][2 * half]),
            acc[mt][2 * p + 1][2 * half + 1] * gelu_exact(acc[mt][2 * p][2 * half + 1]));
      }
    }
  }
}

// The fp32 twin with exact FMA products, 64 x 64 tiles, 16-deep K slices,
// each thread rows ty + 16 i and columns tx + 16 j: tile columns 0..31 are
// W1 rows bx*32 + c ("a") and 32..63 the matching "gate" rows
// bx*32 + c - 32 + inner, so a thread's columns j and j + 2 pair up.
__global__ __launch_bounds__(kThreads) void gemm_geglu_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
    int M, int K, int inner) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFM;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // this thread's float4 of each tile
  const bool a_ok = m0 + lr < M;
  const float* a_src = a + (int64_t)(a_ok ? m0 + lr : 0) * K + lk;
  const int brow = blockIdx.x * 32 + (lr & 31) + (lr >> 5) * inner;
  const float* b_src = b + (int64_t)brow * K + lk;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFK) {
    const float4 av = a_ok ? *reinterpret_cast<const float4*>(a_src + k0)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bv = *reinterpret_cast<const float4*>(b_src + k0);
    __syncthreads();  // the previous slice is consumed
    as[lk][lr] = av.x; as[lk + 1][lr] = av.y; as[lk + 2][lr] = av.z; as[lk + 3][lr] = av.w;
    bs[lk][lr] = bv.x; bs[lk + 1][lr] = bv.y; bs[lk + 2][lr] = bv.z; bs[lk + 3][lr] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ar[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) br[j] = bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      c[(int64_t)row * inner + blockIdx.x * 32 + tx + 16 * j] =
          acc[i][j + 2] * gelu_exact(acc[i][j]);
  }
}

// y = (g - mean) * rsqrt(var + eps) * gamma per row of the fp32 scratch g,
// two passes for the statistics; one block a row, float4 accesses.
template <typename T>
__global__ __launch_bounds__(kThreads) void ln_rows_kernel(
    const float* __restrict__ gsc, const float* __restrict__ gamma, T* __restrict__ y,
    int inner, float eps) {
  __shared__ float red[kThreads / 32];
  const float4* row = reinterpret_cast<const float4*>(gsc + (int64_t)blockIdx.x * inner);
  const int n4 = inner / 4;
  float s = 0.f;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = row[i];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = block_sum(s, red) / inner;
  float q = 0.f;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = row[i];
    const float d0 = v.x - mean, d1 = v.y - mean, d2 = v.z - mean, d3 = v.w - mean;
    q += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
  }
  const float rstd = rsqrtf(block_sum(q, red) / inner + eps);
  T* out = y + (int64_t)blockIdx.x * inner;
  for (int i = threadIdx.x; i < n4; i += kThreads) {
    const float4 v = row[i];
    const float4 gm = reinterpret_cast<const float4*>(gamma)[i];
    out[4 * i] = from_f32<T>((v.x - mean) * rstd * gm.x);
    out[4 * i + 1] = from_f32<T>((v.y - mean) * rstd * gm.y);
    out[4 * i + 2] = from_f32<T>((v.z - mean) * rstd * gm.z);
    out[4 * i + 3] = from_f32<T>((v.w - mean) * rstd * gm.w);
  }
}

}  // namespace

// The first launch of the bf16 forward: g = gate * gelu(a) of x W1^T into
// fp32 g (n, inner). csrc/quant.cu's wide int8 FFN takes it as it stands.
cudaError_t amt_geglu_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1, float* g,
                           int n, int d, int inner, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_geglu_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
  if (err != cudaSuccess) return err;
  gemm_geglu_bf16_kernel<<<dim3(inner / 64, (n + kBM - 1) / kBM), kThreads, kTileSmem, s>>>(
      x, w1, g, n, d, inner);
  return cudaGetLastError();
}

// g_scratch: fp32 (n, inner); y_scratch: (n, inner) in the tower dtype.
AMT_EXPORT int amt_ffn(const void* x, const void* w1, const void* gamma, const void* w2,
                       void* g_scratch, void* y_scratch, void* out, int n, int d,
                       int inner, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (d % kBN != 0 || inner % 64 != 0) return cudaErrorInvalidValue;
  const auto* gm = static_cast<const float*>(gamma);
  float* gs = static_cast<float*>(g_scratch);
  if (dtype == AMT_BF16) {
    const auto* xi = static_cast<const __nv_bfloat16*>(x);
    const auto* w1i = static_cast<const __nv_bfloat16*>(w1);
    const auto* w2i = static_cast<const __nv_bfloat16*>(w2);
    auto* ys = static_cast<__nv_bfloat16*>(y_scratch);
    cudaError_t err = amt_geglu_bf16(xi, w1i, gs, n, d, inner, s);
    if (err != cudaSuccess) return err;
    ln_rows_kernel<__nv_bfloat16><<<n, kThreads, 0, s>>>(gs, gm, ys, inner, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return gemm_bf16<kK, kK, __nv_bfloat16>(ys, inner, w2i, inner,
                                           static_cast<__nv_bfloat16*>(out), d, n, d,
                                           inner, s);
  }
  if (dtype == AMT_F32) {
    const auto* xi = static_cast<const float*>(x);
    const auto* w1i = static_cast<const float*>(w1);
    const auto* w2i = static_cast<const float*>(w2);
    auto* ys = static_cast<float*>(y_scratch);
    cudaError_t err;
    gemm_geglu_f32_kernel<<<dim3(inner / 32, (n + kFM - 1) / kFM), kThreads, 0, s>>>(
        xi, w1i, gs, n, d, inner);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ln_rows_kernel<float><<<n, kThreads, 0, s>>>(gs, gm, ys, inner, eps);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    return gemm_f32<kK, kK>(ys, inner, w2i, inner, static_cast<float*>(out), d, n, d, inner, s);
  }
  return cudaErrorInvalidValue;
}
