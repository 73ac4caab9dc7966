// Fused decode-step sampling epilogue, one block per row of C logits:
//   x     = null + gs * (cond - null)        (classifier-free guidance, optional)
//   kth   = 16-step counting bisection for the k-th largest value of x
//   pred  = argmax(where(x >= kth, x + T * gumbel, -inf)), first index on ties
//   score = exp(x[pred] - (max + log sum exp(x - max)))
// all in fp32 from bf16 or fp32 logits.
//
// Replaces attention_models_tpu/ops/sampling.py::_sample_epilogue_kernel
// (entry sample_epilogue_fused). The TPU kernel draws its noise from
// pltpu.prng_*; here the bits are Philox4x32-10 keyed by (the row's seed,
// the decode step) with (column / 4, position of the row under its seed) as
// the counter, so a row's noise depends on its seed, step and position
// only, never on the rest of the batch. A test hook takes the bits from an
// int32 tensor instead. u = (bits >>> 8) * 2^-24 + 2^-25 and
// g = -log(-log(u)) with logf (no fast math), as the TPU kernel and the
// plain version compute them; the products and sums that the plain version
// rounds separately are written with __fmul_rn / __fadd_rn so nvcc does not
// contract them into FMAs.
//
// Bound on the H100: bytes. At the decode shape (8192 rows of 8192 logits)
// the logits are read once: 134 MB in bf16 (0.040 ms), 268 MB in fp32.
//
// Design. Each bisection step is a row-wide count; the TPU kernel keeps its
// row tile in VMEM across the 16 steps. Here the block's 256 threads hold
// the row in registers (C <= 8192: 8 groups of 4 consecutive columns a
// thread, group j at column 4 * (thread + 256 j)), so the row is read from
// device memory once and the 16 counts, the noise, the argmax and the
// logsumexp run on registers with block reductions through shared memory.
// Noise is drawn only for the groups of 4 that hold a kept column (about
// 1 - p of them): the two logf per column and the Philox rounds are what
// bound the kernel beside its bytes, and a column below the threshold
// cannot be picked whatever its noise.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
  }
  return ctr;
}

__device__ __forceinline__ float gumbel_of_bits(uint32_t bits) {
  const float u = __fadd_rn(__fmul_rn((float)(bits >> 8), 5.9604644775390625e-8f),
                            2.98023223876953125e-8f);  // 2^-24, 2^-25
  return -logf(-logf(u));
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// Block-wide reductions; every thread gets the result. red holds kWarps
// entries and may be reused right after a call returns.
template <typename Op, typename V>
__device__ __forceinline__ V block_reduce(V v, V* red, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  V r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  return r;
}

struct Pick {
  float noised;  // the value compared
  int idx;       // its column
  float x;       // the (guided) logit there
};

__device__ __forceinline__ bool better(const Pick& a, const Pick& b) {
  return a.noised > b.noised || (a.noised == b.noised && a.idx < b.idx);
}

template <typename T, bool kNull, bool kBits>
__global__ __launch_bounds__(kThreads) void sample_epilogue_kernel(
    const T* __restrict__ cond, const T* __restrict__ null,
    const int32_t* __restrict__ bits, const int64_t* __restrict__ seeds,
    int rows_per_seed, uint32_t step, int32_t* __restrict__ pred,
    float* __restrict__ score, int C, int k, int iters, float gs, float temperature) {
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];
  __shared__ Pick redp[kWarps];
  const int row = blockIdx.x;
  const int64_t base = (int64_t)row * C;

  float v[kGroups][4];
  float vmax = -INFINITY, vmin = INFINITY;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = 4 * (threadIdx.x + j * kThreads);
    if (col < C) {
      load4(cond + base + col, v[j]);
      if (kNull) {
        float nv[4];
        load4(null + base + col, nv);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          v[j][w] = __fadd_rn(nv[w], __fmul_rn(gs, __fsub_rn(v[j][w], nv[w])));
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        vmax = fmaxf(vmax, v[j][w]);
        vmin = fminf(vmin, v[j][w]);
      }
    }
  }
  const float rmax = block_reduce(vmax, redf, [](float a, float b) { return fmaxf(a, b); });
  float lo = block_reduce(vmin, redf, [](float a, float b) { return fminf(a, b); });
  float hi = rmax;

  // the largest threshold found with count(x >= t) >= k
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      if (4 * (threadIdx.x + j * kThreads) < C)
#pragma unroll
        for (int w = 0; w < 4; ++w) cnt += v[j][w] >= mid;
    cnt = block_reduce(cnt, redi, [](int a, int b) { return a + b; });
    if (cnt >= k) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float kth = lo;

  Pick best{-INFINITY, INT_MAX, 0.f};
  float esum = 0.f;
  const uint2 key = kBits ? make_uint2(0u, 0u)
                          : make_uint2((uint32_t)seeds[row / rows_per_seed], step);
  const uint32_t pos = (uint32_t)(row % rows_per_seed);
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int col = 4 * (threadIdx.x + j * kThreads);
    if (col < C) {
#pragma unroll
      for (int w = 0; w < 4; ++w) esum += expf(v[j][w] - rmax);
      // only kept columns (~(1 - p) of them) need their noise
      if (v[j][0] >= kth || v[j][1] >= kth || v[j][2] >= kth || v[j][3] >= kth) {
        uint32_t b[4];
        if (kBits) {
          const int4 q = *reinterpret_cast<const int4*>(bits + base + col);
          b[0] = (uint32_t)q.x; b[1] = (uint32_t)q.y; b[2] = (uint32_t)q.z; b[3] = (uint32_t)q.w;
        } else {
          const uint4 q = philox4x32_10(make_uint4((uint32_t)(col / 4), pos, 0u, 0u), key);
          b[0] = q.x; b[1] = q.y; b[2] = q.z; b[3] = q.w;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float x = v[j][w];
          if (x >= kth) {
            const Pick cand{__fadd_rn(x, __fmul_rn(temperature, gumbel_of_bits(b[w]))),
                            col + w, x};
            if (better(cand, best)) best = cand;
          }
        }
      }
    }
  }
  const float total = block_reduce(esum, redf, [](float a, float b) { return a + b; });
  // argmax: shuffle the (noised, idx, x) triples, first index on ties
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Pick other;
    other.noised = __shfl_xor_sync(0xffffffffu, best.noised, o);
    other.idx = __shfl_xor_sync(0xffffffffu, best.idx, o);
    other.x = __shfl_xor_sync(0xffffffffu, best.x, o);
    if (better(other, best)) best = other;
  }
  if (threadIdx.x % 32 == 0) redp[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    Pick r = redp[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      if (better(redp[w], r)) r = redp[w];
    const float lse = rmax + logf(total);
    pred[row] = r.idx;
    score[row] = expf(r.x - lse);
  }
}

template <typename T>
cudaError_t launch(const void* cond, const void* null, const int32_t* bits,
                   const int64_t* seeds, int rows_per_seed, uint32_t step, int32_t* pred,
                   float* score, int rows, int C, int k, int iters, float gs, float temp,
                   cudaStream_t s) {
  const T* c = static_cast<const T*>(cond);
  const T* nl = static_cast<const T*>(null);
#define AMT_SAMPLE(NULL_, BITS_)                                                       \
  sample_epilogue_kernel<T, NULL_, BITS_><<<rows, kThreads, 0, s>>>(                   \
      c, nl, bits, seeds, rows_per_seed, step, pred, score, C, k, iters, gs, temp)
  if (nl && bits) AMT_SAMPLE(true, true);
  else if (nl) AMT_SAMPLE(true, false);
  else if (bits) AMT_SAMPLE(false, true);
  else AMT_SAMPLE(false, false);
#undef AMT_SAMPLE
  return cudaGetLastError();
}

}  // namespace

// null and bits may be null pointers; seeds is read only without bits.
AMT_EXPORT int amt_sample_epilogue(const void* cond, const void* null, const void* bits,
                                   const void* seeds, int rows_per_seed, int step,
                                   void* pred, void* score, int rows, int C, int k,
                                   int iters, float gs, float temperature, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (C % 4 != 0 || C > 4 * kGroups * kThreads || rows_per_seed <= 0)
    return cudaErrorInvalidValue;
  const auto* b = static_cast<const int32_t*>(bits);
  const auto* sd = static_cast<const int64_t*>(seeds);
  auto* p = static_cast<int32_t*>(pred);
  auto* sc = static_cast<float*>(score);
  if (dtype == AMT_BF16)
    return launch<__nv_bfloat16>(cond, null, b, sd, rows_per_seed, (uint32_t)step, p, sc,
                                 rows, C, k, iters, gs, temperature, s);
  if (dtype == AMT_F32)
    return launch<float>(cond, null, b, sd, rows_per_seed, (uint32_t)step, p, sc, rows, C,
                         k, iters, gs, temperature, s);
  return cudaErrorInvalidValue;
}
