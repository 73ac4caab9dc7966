// Row LayerNorm: y = (x - mean) / sqrt(var + eps) * gamma (+ beta).
//
// Replaces attention_models_tpu/ops/layernorm.py::_ln_kernel and
// _ln_kernel_nobeta (entry fused_layernorm).
//
// Bound on the H100: bytes. Each row is read once and written once; at the
// main path's (8192, 512) bf16 that is 16.8 MB, about 5 us at 3.35 TB/s,
// against some 20 flops per element.
//
// Design: one warp per row. The row is loaded once with 16-byte vector loads
// (8 bf16 or 4 fp32 per load, scalar loads when d is not a multiple of the
// vector width) into registers; mean and the biased variance are two fp32
// passes over those registers, so x is read from device memory exactly once.
// gamma and beta are fp32; beta may be null. Any d up to 32 * VEC * NCHUNK
// (4096 for the vector path, 1024 for the scalar one) is taken this way,
// including the patch-embed norm1 at d = 192 that the TPU kernel could not
// tile. A wider row (or one past 1024 that is not 16-byte aligned) goes to
// layernorm_rows_kernel: one block of 256 threads a row, looping over the
// row in 256-wide steps for each of the three passes (sum, centred squares,
// output), so every width is taken; the row is read three times, the last
// two mostly from L1/L2.
#include "gemm.cuh"  // block_sum

namespace {

template <typename T, int VEC>
struct Vec;
template <>
struct Vec<__nv_bfloat16, 8> {
  using type = uint4;
};
template <>
struct Vec<float, 4> {
  using type = uint4;
};
template <typename T>
struct Vec<T, 1> {
  using type = T;
};

template <typename T, int VEC, int NCHUNK>
__global__ __launch_bounds__(128) void layernorm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, int64_t n, int d,
    float eps) {
  using V = typename Vec<T, VEC>::type;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const int nvec = d / VEC;
  const V* xr = reinterpret_cast<const V*>(x + row * d);
  V* yr = reinterpret_cast<V*>(y + row * d);

  float v[NCHUNK][VEC];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    const int i = lane + c * 32;
    if (i < nvec) {
      V raw = xr[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[c][j] = to_f32<T>(e[j]);
        sum += v[c][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[c][j] = 0.f;
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    if (lane + c * 32 < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float t = v[c][j] - mean;
        sq += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    const int i = lane + c * 32;
    if (i < nvec) {
      V out;
      T* e = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int col = i * VEC + j;
        float t = (v[c][j] - mean) * rstd * gamma[col];
        if (beta != nullptr) t += beta[col];
        e[j] = from_f32<T>(t);
      }
      yr[i] = out;
    }
  }
}

template <typename T, int VEC, int NC>
cudaError_t launch_nc(const T* x, const float* gamma, const float* beta, T* y,
                      int64_t n, int d, float eps, cudaStream_t stream) {
  const int rows_per_block = 4;
  const dim3 grid((unsigned)((n + rows_per_block - 1) / rows_per_block));
  layernorm_kernel<T, VEC, NC><<<grid, 32 * rows_per_block, 0, stream>>>(
      x, gamma, beta, y, n, d, eps);
  return cudaGetLastError();
}

// Picks the smallest register array that holds the row: at most 128 fp32
// values a lane, so d <= 4096 on the vector path and d <= 1024 on the scalar
// one (the Python wrapper checks the same limits).
template <typename T, int VEC>
cudaError_t launch(const T* x, const float* gamma, const float* beta, T* y,
                   int64_t n, int d, float eps, cudaStream_t stream) {
  const int per_lane = (d / VEC + 31) / 32;
  if (per_lane <= 1) return launch_nc<T, VEC, 1>(x, gamma, beta, y, n, d, eps, stream);
  if (per_lane <= 2) return launch_nc<T, VEC, 2>(x, gamma, beta, y, n, d, eps, stream);
  if (per_lane <= 4) return launch_nc<T, VEC, 4>(x, gamma, beta, y, n, d, eps, stream);
  if (per_lane <= 8) return launch_nc<T, VEC, 8>(x, gamma, beta, y, n, d, eps, stream);
  if constexpr (VEC <= 8) {
    if (per_lane <= 16) return launch_nc<T, VEC, 16>(x, gamma, beta, y, n, d, eps, stream);
  }
  if constexpr (VEC <= 4) {
    if (per_lane <= 32) return launch_nc<T, VEC, 32>(x, gamma, beta, y, n, d, eps, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
__global__ __launch_bounds__(kThreads) void layernorm_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, int d, float eps) {
  __shared__ float red[kThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * d;
  T* yr = y + (int64_t)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) s += to_f32<T>(xr[i]);
  const float mean = block_sum(s, red) / d;
  float q = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float t = to_f32<T>(xr[i]) - mean;
    q += t * t;
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    float t = (to_f32<T>(xr[i]) - mean) * rstd * gamma[i];
    if (beta != nullptr) t += beta[i];
    yr[i] = from_f32<T>(t);
  }
}

template <typename T>
cudaError_t launch_rows(const T* x, const float* gamma, const float* beta, T* y,
                        int64_t n, int d, float eps, cudaStream_t stream) {
  layernorm_rows_kernel<T><<<(unsigned)n, kThreads, 0, stream>>>(x, gamma, beta, y, d,
                                                                    eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

AMT_EXPORT int amt_layernorm(const void* x, const void* gamma, const void* beta,
                             void* y, int64_t n, int d, float eps, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (n == 0) return cudaSuccess;
  const bool vec_ok = aligned16(x) && aligned16(y);
  if (dtype == AMT_BF16) {
    const auto* xi = static_cast<const __nv_bfloat16*>(x);
    auto* yo = static_cast<__nv_bfloat16*>(y);
    if (vec_ok && d % 8 == 0 && d <= 4096)
      return launch<__nv_bfloat16, 8>(xi, g, b, yo, n, d, eps, s);
    if (d <= 1024) return launch<__nv_bfloat16, 1>(xi, g, b, yo, n, d, eps, s);
    return launch_rows<__nv_bfloat16>(xi, g, b, yo, n, d, eps, s);
  }
  if (dtype == AMT_F32) {
    const auto* xi = static_cast<const float*>(x);
    auto* yo = static_cast<float*>(y);
    if (vec_ok && d % 4 == 0 && d <= 4096) return launch<float, 4>(xi, g, b, yo, n, d, eps, s);
    if (d <= 1024) return launch<float, 1>(xi, g, b, yo, n, d, eps, s);
    return launch_rows<float>(xi, g, b, yo, n, d, eps, s);
  }
  return cudaErrorInvalidValue;
}
