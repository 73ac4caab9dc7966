// Row LayerNorm: y = (x - mean) / sqrt(var + eps) * gamma (+ beta).
//
// Replaces attention_models_tpu/ops/layernorm.py::_ln_kernel and
// _ln_kernel_nobeta (entry fused_layernorm).
//
// Bound on the H100: bytes. Each row is read once and written once; at the
// main path's (8192, 512) bf16 that is 16.8 MB, about 5 us at 3.35 TB/s,
// against some 20 flops per element.
//
// Design. A warp normalises rows r, r + W, r + 2W, ..., where W, the warps
// of the grid, is sized so that every warp of one wave (kBlocksPerSM blocks
// of kLnThreads on each SM, or as many as fit) takes the same number of
// rows. Lane l owns the 16-byte pieces l + 32c (c < NCHUNK: 8 bf16 or 4
// fp32 each; single elements when d is not a multiple of the vector width
// or x / y is not 16-byte aligned) of every row, so its gamma and beta
// columns are the same in each row: they are read once per warp, 16 bytes
// at a time, and held in registers up to kHoldCols columns in bf16 and a
// quarter of that in fp32, and read again with 16-byte loads at each row
// (L1 hits) where wider. Up to kHoldCols the warp keeps two rows in flight,
// as they lie in memory (row r + W's x loads while row r is reduced and
// written); wider rows (up to 4096) hold one. The arithmetic is a contract
// with kernels 2 and 6, which call amt_layernorm for their LayerNorm pass,
// and with the bits of the kernel's first, one-row-a-warp form: each lane
// sums its values chunk by chunk in column order, warp_sum's butterfly gives the
// mean, the centred squares are summed the same way (an FMA a value), rstd
// = rsqrtf(var + eps), y = (v - mean) * rstd * gamma (+ beta, fused into
// the gamma product); bf16 is converted in pairs, again for each pass. A
// row wider than 4096 (or one past 1024 that is not 16-byte aligned) goes
// to layernorm_rows_kernel: one block of 256 threads a row, looping over
// the row in 256-wide steps for each of the three passes (sum, centred
// squares, output), so every width is taken; the row is read three times,
// the last two mostly from L1/L2.
#include "gemm.cuh"  // block_sum, sm_count

namespace {

constexpr int kLnThreads = 128;  // 4 warps a block
constexpr int kBlocksPerSM = 4;  // blocks of a wave on each SM
constexpr int kHoldCols = 1024;  // widest row a warp keeps two of

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

// The centred square's step and the output of one value, each rounding
// spelled out so that the compiler cannot move the bits: the square fused
// into the sum, and the gamma product into the beta add, except for a
// lane's first value where the row is one 16-byte piece a lane (NCHUNK 1,
// VEC > 1), whose product is rounded apart, as the compiler formed them in
// the one-row-a-warp form (its SASS; bench_q8.py bits holds the two
// libraries equal).
__device__ __forceinline__ float sq_step(float sq, float t) {
  return __fmaf_rn(t, t, sq);
}
template <bool kFused>
__device__ __forceinline__ float ln_out(float v, float mean, float rstd, float g,
                                        float b, bool has_beta) {
  const float u = __fmul_rn(__fsub_rn(v, mean), rstd);
  if (!has_beta) return __fmul_rn(u, g);
  return kFused ? __fmaf_rn(u, g, b) : __fadd_rn(__fmul_rn(u, g), b);
}

// VEC values of T from one piece into fp32 (bf16 in pairs)
template <typename T, int VEC>
__device__ __forceinline__ void unpack(const typename Vec<T, VEC>::type& raw,
                                       float (&v)[VEC]) {
  if constexpr (VEC == 8) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32<T>(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ typename Vec<T, VEC>::type pack(const float (&v)[VEC]) {
  typename Vec<T, VEC>::type out;
  if constexpr (VEC == 8) {
    uint32_t* h = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = pack_bf16x2(v[2 * j], v[2 * j + 1]);
  } else {
    T* e = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
  }
  return out;
}

// VEC fp32 values of a gamma / beta piece (16-byte loads where VEC >= 4 and
// the vector is 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC],
                                         bool aligned) {
  if constexpr (VEC % 4 == 0) {
    if (!aligned) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = p[j];
      return;
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + j);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

template <typename T, int VEC, int NCHUNK>
__global__ __launch_bounds__(kLnThreads) void layernorm_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y, int64_t n, int d,
    float eps) {
  using V = typename Vec<T, VEC>::type;
  // registers: two rows held as they lie (unpacked again for each pass) up
  // to kHoldCols; gamma and beta held too up to kHoldCols in bf16 and a
  // quarter of it in fp32, whose rows take twice the registers
  constexpr bool kTwo = NCHUNK * VEC <= kHoldCols / 32;
  constexpr bool kHold =
      VEC > 1 && NCHUNK * VEC <= (sizeof(T) == 2 ? kHoldCols : kHoldCols / 4) / 32;
  constexpr int kH = kHold ? NCHUNK : 1;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (kLnThreads / 32);
  int64_t row = (int64_t)blockIdx.x * (kLnThreads / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const int nvec = d / VEC;
  const bool has_beta = beta != nullptr;
  const bool gb16 = (reinterpret_cast<uintptr_t>(gamma) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(beta) & 15) == 0;

  float gm[kH][VEC], bt[kH][VEC];
  if constexpr (kHold) {
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      const int i = lane + c * 32;
#pragma unroll
      for (int j = 0; j < VEC; ++j) gm[c][j] = bt[c][j] = 0.f;
      if (i < nvec) {
        load_f32<VEC>(gamma + i * VEC, gm[c], gb16);
        if (has_beta) load_f32<VEC>(beta + i * VEC, bt[c], gb16);
      }
    }
  }
  V cur[NCHUNK], nxt[kTwo ? NCHUNK : 1];
  const auto load = [&](V (&dst)[NCHUNK], int64_t r) {
    const V* xr = reinterpret_cast<const V*>(x + r * d);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c)
      if (lane + c * 32 < nvec) dst[c] = xr[lane + c * 32];
  };
  load(cur, row);
  for (; row < n; row += warps) {
    if constexpr (kTwo) {
      if (row + warps < n) load(nxt, row + warps);
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (lane + c * 32 < nvec) {
        float v[VEC];
        unpack<T, VEC>(cur[c], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) sum += v[j];
      }
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (lane + c * 32 < nvec) {
        float v[VEC];
        unpack<T, VEC>(cur[c], v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) sq = sq_step(sq, v[j] - mean);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    V* yr = reinterpret_cast<V*>(y + row * d);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      const int i = lane + c * 32;
      if (i < nvec) {
        float v[VEC], g[VEC], b[VEC] = {};
        unpack<T, VEC>(cur[c], v);
        if constexpr (kHold) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            g[j] = gm[c][j];
            b[j] = bt[c][j];
          }
        } else {
          load_f32<VEC>(gamma + i * VEC, g, gb16);
          if (has_beta) load_f32<VEC>(beta + i * VEC, b, gb16);
        }
        float o[VEC];
        o[0] = NCHUNK == 1 && VEC > 1
                   ? ln_out<false>(v[0], mean, rstd, g[0], b[0], has_beta)
                   : ln_out<true>(v[0], mean, rstd, g[0], b[0], has_beta);
#pragma unroll
        for (int j = 1; j < VEC; ++j)
          o[j] = ln_out<true>(v[j], mean, rstd, g[j], b[j], has_beta);
        yr[i] = pack<T, VEC>(o);
      }
    }
    if constexpr (kTwo) {
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) cur[c] = nxt[c];
    } else if (row + warps < n) {
      load(cur, row + warps);
    }
  }
}

template <typename T, int VEC, int NC>
cudaError_t launch_nc(const T* x, const float* gamma, const float* beta, T* y,
                      int64_t n, int d, float eps, cudaStream_t stream) {
  // one wave of warps at most (kBlocksPerSM blocks an SM, or as many as its
  // registers allow), each taking the same number of rows
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layernorm_kernel<T, VEC, NC>, kLnThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm > kBlocksPerSM ? kBlocksPerSM : per_sm;
  }
  constexpr int kWarpsPerBlock = kLnThreads / 32;
  const int64_t wave = (int64_t)sm_count() * per_sm * kWarpsPerBlock;
  const int64_t rows_per_warp = (n + wave - 1) / wave;
  const int64_t warps = (n + rows_per_warp - 1) / rows_per_warp;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  layernorm_kernel<T, VEC, NC><<<grid, kLnThreads, 0, stream>>>(x, gamma, beta, y, n,
                                                               d, eps);
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
