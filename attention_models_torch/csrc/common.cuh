// Shared helpers for the port's Hopper kernels (built with nvcc for sm_90a,
// bound through a plain C interface and loaded with ctypes; see
// attention_models_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (ops/_build.py::DTYPE_CODES)
#define AMT_F32 0
#define AMT_BF16 1

#define AMT_EXPORT extern "C" __attribute__((visibility("default")))

// Element strides of a (batch, head, row) indexed operand whose last
// dimension is contiguous; 64-bit, so b*h*t*d past 2^31 never overflows.
struct Strides3 {
  int64_t b, h, r;
};

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two fp32 values -> one 32-bit register holding (lo, hi) as bf16, the
// operand packing of mma.sync's bf16 fragments.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16x2_raw(__nv_bfloat16 lo,
                                                    __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 operands, fp32 accumulators.
// Fragment layout (PTX ISA, mma.m16n8k16, .bf16): with g = lane / 4 and
// t = lane % 4,
//   a[0] = A[g][2t..2t+1]      a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]    a[3] = A[g+8][2t+8..2t+9]
//   b[0] = B[2t..2t+1][g]      b[1] = B[2t+8..2t+9][g]
//   d[0..1] = D[g][2t..2t+1]   d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_bf16_16816 operand fragments read element by element from any
// strided bf16 layout (shared or global memory), so one helper serves a
// matrix and its transpose. A (16x16): element (m, k) at p[m * sm + k * sk];
// B (16x8): element (k, n) at p[k * sk + n * sn].
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* p, int sm,
                                            int sk) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int k0 = 2 * t * sk, k1 = (2 * t + 1) * sk;
  const int k8 = (2 * t + 8) * sk, k9 = (2 * t + 9) * sk;
  a[0] = pack_bf16x2_raw(p[g * sm + k0], p[g * sm + k1]);
  a[1] = pack_bf16x2_raw(p[(g + 8) * sm + k0], p[(g + 8) * sm + k1]);
  a[2] = pack_bf16x2_raw(p[g * sm + k8], p[g * sm + k9]);
  a[3] = pack_bf16x2_raw(p[(g + 8) * sm + k8], p[(g + 8) * sm + k9]);
}
__device__ __forceinline__ void load_b_frag(uint32_t b[2],
                                            const __nv_bfloat16* p, int sk,
                                            int sn) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  b[0] = pack_bf16x2_raw(p[2 * t * sk + g * sn], p[(2 * t + 1) * sk + g * sn]);
  b[1] = pack_bf16x2_raw(p[(2 * t + 8) * sk + g * sn],
                         p[(2 * t + 9) * sk + g * sn]);
}
// 16-byte asynchronous copy global -> shared (cp.async, sm_80+); with
// valid == false nothing is read and the 16 shared bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

namespace {
// out (m, n; rows ldc apart) = the sum over z = 0 .. splits-1, in order, of
// part[z] ((m, n) contiguous planes), n % 4 == 0: the second pass of a
// product whose K was split into ordered fp32 partials (no atomics, so a
// repeat call gives the same bits).
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int m, int n,
                                  int ldc, int splits) {
  const int64_t plane = (int64_t)m * n;
  const int64_t i = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= plane) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 v = *reinterpret_cast<const float4*>(part + z * plane + i);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  *reinterpret_cast<float4*>(out + (i / n) * ldc + i % n) = s;
}
}  // namespace
