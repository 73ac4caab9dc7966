// Fused pre-LN MLP block: out = x + gelu(LN(x) * g + b @ W1^T + b1) @ W2^T + b2.
//
// Replaces attention_models_tpu/ops/ffn.py::_ln_mlp_kernel (entry
// fused_ln_mlp / _ln_mlp_forward), bf16 only as there. W1 is (hid, d) and W2
// (d, hid): the torch Linear layout, whose rows are the "col" B operand of
// mma.sync as they stand.
//
// Bound on the H100: operations. At the main path's 8192 rows, d 512 and hid
// 1368 the two products are 4*n*d*hid = 22.9 GFLOP against 19 MB of x, out
// and weights, about 23 us at the bf16 tensor-core peak.
//
// Design: a block of 8 warps takes 64 rows. It normalises them into shared
// memory as bf16 (fp32 statistics, biased variance), then walks the hidden
// width in chunks of 64: H = Y W1[c]^T + b1 (mma.sync m16n8k16, fp32
// accumulation), G = gelu(H) with the true erff (the TPU kernel used the
// A&S 7.1.26 polynomial), written to shared memory as bf16, then
// acc += G W2[:, c]^T with the (64, d) accumulator in fp32 registers spread
// over the 8 warps. The (n, hid) intermediate never reaches device memory.
// The epilogue adds b2 and the residual x. hid need only be a multiple of 8
// (1368 is not a multiple of 64): the last chunk's missing hidden rows and
// columns are zero-filled in shared memory, so they add gelu(0) * 0 = 0.
// Each chunk's W1 and W2 slices (128 KB at d 512) are re-read from L2 by
// every block through cp.async, each overlapping the other product (there is
// no room for a second buffer of either at d 512). One block per SM and
// mma.sync in place of wgmma are what later PRs tune.
//
// Widths. The single pass is instantiated for d 128, 256, 384 and 512 (its
// shared memory grows with d: 216 KB at 512, and 318 KB at d 768 would not
// fit the H100's 227 KB per block). Every wider d % 128 == 0 that the JAX
// gate sends to its kernel runs in three launches: the LayerNorm kernel
// (csrc/layernorm.cu, bf16 yc with fp32 statistics, the rounding the single
// pass makes) into a (n, d) scratch, then kernel 7's two tile products
// (csrc/mlp.cu) with the residual x added in the second epilogue.
#include "common.cuh"

extern "C" int amt_layernorm(const void* x, const void* gamma, const void* beta, void* y,
                             int64_t n, int d, float eps, int dtype, void* stream);
cudaError_t amt_mlp_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1, const float* b1,
                         const __nv_bfloat16* w2, const float* b2, const __nv_bfloat16* res,
                         __nv_bfloat16* g_scratch, __nv_bfloat16* out, int n, int d, int hid,
                         cudaStream_t s);

namespace {

constexpr int kRows = 64;
constexpr int kChunk = 64;
constexpr int kCS = kChunk + 8;  // row stride of the W2 chunk and of G

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)kRows * (D + 8) + (size_t)kChunk * (D + 8) + (size_t)D * kCS +
          (size_t)kRows * kCS);
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

template <int D>
__global__ __launch_bounds__(256, 1) void ln_mlp_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ lng,
    const float* __restrict__ lnb, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int n,
    int hid, float eps) {
  constexpr int kYS = D + 8;  // row stride of Y and of the W1 chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* w1s = ys + kRows * kYS;   // [kChunk][kYS]
  __nv_bfloat16* w2s = w1s + kChunk * kYS;  // [D][kCS]
  __nv_bfloat16* gs = w2s + D * kCS;        // [kRows][kCS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = blockIdx.x * kRows;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // Hidden-chunk weight slices arrive by cp.async (rows/columns past hid
  // zero-filled): W1's slice for the next chunk loads during this chunk's
  // G W2 product, W2's during the next chunk's Y W1 product.
  auto load_w1 = [&](int h0) {
    for (int i = threadIdx.x; i < kChunk * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = h0 + r < hid;
      cp_async16(w1s + r * kYS + c, w1 + (ok ? (int64_t)(h0 + r) * D + c : 0), ok);
    }
    cp_async_commit();
  };
  auto load_w2 = [&](int h0) {
    for (int i = threadIdx.x; i < D * (kChunk / 8); i += blockDim.x) {
      const int o = i / (kChunk / 8), c = (i % (kChunk / 8)) * 8;
      const bool ok = h0 + c < hid;
      cp_async16(w2s + o * kCS + c, w2 + (ok ? (int64_t)o * hid + h0 + c : 0), ok);
    }
    cp_async_commit();
  };
  load_w1(0);
  load_w2(0);

  // LN: each warp normalises 8 rows, 8 bf16 per lane per 16-byte load
  // (at D 128 and 384 the last load slot of some lanes lies past the row)
  constexpr int VPL = (D / 8 + 31) / 32;
  for (int rr = 0; rr < kRows / 8; ++rr) {
    const int r = warp * (kRows / 8) + rr;
    const int gr = row0 + r;
    float v[VPL][8];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int col = (lane + c * 32) * 8;
      const uint4 raw = gr < n && col < D
                            ? *reinterpret_cast<const uint4*>(x + (int64_t)gr * D + col)
                            : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[c][j] = __bfloat162float(e[j]);
        sum += v[c][j];
      }
    }
    const float mean = warp_sum(sum) / D;
    float sq = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
      if ((lane + c * 32) * 8 < D)
#pragma unroll
        for (int j = 0; j < 8; ++j) sq += (v[c][j] - mean) * (v[c][j] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      const int col = (lane + c * 32) * 8;
      if (col >= D) continue;
      uint4 packed;
      uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c0 = col + 2 * j;
        p[j] = pack_bf16x2((v[c][2 * j] - mean) * rstd * lng[c0] + lnb[c0],
                           (v[c][2 * j + 1] - mean) * rstd * lng[c0 + 1] + lnb[c0 + 1]);
      }
      *reinterpret_cast<uint4*>(ys + r * kYS + col) = packed;
    }
  }

  const int wr = warp & 3;   // 16-row group of this warp
  const int wc = warp >> 2;  // H: hidden cols wc*32.. of a chunk; O: out cols wc*D/2..
  constexpr int NT = D / 16;  // 8-wide output tiles per warp
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int nchunks = (hid + kChunk - 1) / kChunk;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int h0 = ch * kChunk;
    const bool more = ch + 1 < nchunks;
    cp_async_wait<1>();  // this chunk's W1 slice has landed (W2's may not)
    __syncthreads();     // ... for every thread; Y is written

    // H (16 rows x 32 hidden cols of this warp) = Y W1c^T
    float hacc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* ya = ys + (wr * 16 + g) * kYS + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ya);
      a[1] = *reinterpret_cast<const uint32_t*>(ya + 8 * kYS);
      a[2] = *reinterpret_cast<const uint32_t*>(ya + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ya + 8 * kYS + 8);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wb = w1s + (wc * 32 + nt * 8 + g) * kYS + kk * 16 + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(wb);
        b[1] = *reinterpret_cast<const uint32_t*>(wb + 8);
        mma_bf16_16816(hacc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int hc = wc * 32 + nt * 8 + 2 * t;  // column within the chunk
      const float bb0 = h0 + hc < hid ? b1[h0 + hc] : 0.f;
      const float bb1 = h0 + hc + 1 < hid ? b1[h0 + hc + 1] : 0.f;
      *reinterpret_cast<uint32_t*>(gs + (wr * 16 + g) * kCS + hc) =
          pack_bf16x2(gelu_exact(hacc[nt][0] + bb0), gelu_exact(hacc[nt][1] + bb1));
      *reinterpret_cast<uint32_t*>(gs + (wr * 16 + g + 8) * kCS + hc) =
          pack_bf16x2(gelu_exact(hacc[nt][2] + bb0), gelu_exact(hacc[nt][3] + bb1));
    }
    __syncthreads();  // G written; no warp reads the W1 slice any more
    if (more) {
      load_w1(h0 + kChunk);
    } else {
      cp_async_commit();  // an empty group keeps the wait counts uniform
    }
    cp_async_wait<1>();  // this chunk's W2 slice has landed
    __syncthreads();

    // acc (16 rows x D/2 out cols of this warp) += G W2c^T
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const __nv_bfloat16* ga = gs + (wr * 16 + g) * kCS + kk * 16 + 2 * t;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ga);
      a[1] = *reinterpret_cast<const uint32_t*>(ga + 8 * kCS);
      a[2] = *reinterpret_cast<const uint32_t*>(ga + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ga + 8 * kCS + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* wb = w2s + (wc * (D / 2) + nt * 8 + g) * kCS + kk * 16 + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(wb);
        b[1] = *reinterpret_cast<const uint32_t*>(wb + 8);
        mma_bf16_16816(acc[nt], a, b);
      }
    }
    __syncthreads();  // no warp reads the W2 slice or G any more
    if (more) {
      load_w2(h0 + kChunk);
    } else {
      cp_async_commit();
    }
  }

#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wc * (D / 2) + nt * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wr * 16 + g + half * 8;
      if (r < n) {
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(x + (int64_t)r * D + col);
        const float y0 = acc[nt][2 * half] + b2[col] + __bfloat162float(xv.x);
        const float y1 = acc[nt][2 * half + 1] + b2[col + 1] + __bfloat162float(xv.y);
        *reinterpret_cast<uint32_t*>(out + (int64_t)r * D + col) = pack_bf16x2(y0, y1);
      }
    }
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* x, const float* lng, const float* lnb,
                   const __nv_bfloat16* w1, const float* b1,
                   const __nv_bfloat16* w2, const float* b2, __nv_bfloat16* out,
                   int n, int hid, float eps, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      ln_mlp_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kRows - 1) / kRows);
  ln_mlp_kernel<D><<<grid, 256, bytes, stream>>>(x, lng, lnb, w1, b1, w2, b2,
                                                 out, n, hid, eps);
  return cudaGetLastError();
}

}  // namespace

// yc_scratch (n, d) and g_scratch (n, hid), bf16: used (and needed) only
// above d 512.
AMT_EXPORT int amt_ln_mlp(const void* x, const void* lng, const void* lnb,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, void* yc_scratch,
                          void* g_scratch, int n, int d, int hid, float eps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return cudaSuccess;
  if (hid % 8 != 0 || d % 128 != 0) return cudaErrorInvalidValue;
  const auto* xi = static_cast<const __nv_bfloat16*>(x);
  const auto* w1i = static_cast<const __nv_bfloat16*>(w1);
  const auto* w2i = static_cast<const __nv_bfloat16*>(w2);
  const auto* g = static_cast<const float*>(lng);
  const auto* bt = static_cast<const float*>(lnb);
  const auto* bb1 = static_cast<const float*>(b1);
  const auto* bb2 = static_cast<const float*>(b2);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (d) {
    case 128: return launch<128>(xi, g, bt, w1i, bb1, w2i, bb2, o, n, hid, eps, s);
    case 256: return launch<256>(xi, g, bt, w1i, bb1, w2i, bb2, o, n, hid, eps, s);
    case 384: return launch<384>(xi, g, bt, w1i, bb1, w2i, bb2, o, n, hid, eps, s);
    case 512: return launch<512>(xi, g, bt, w1i, bb1, w2i, bb2, o, n, hid, eps, s);
  }
  auto* yc = static_cast<__nv_bfloat16*>(yc_scratch);
  if (yc == nullptr || g_scratch == nullptr) return cudaErrorInvalidValue;
  const int err = amt_layernorm(x, lng, lnb, yc, n, d, eps, AMT_BF16, stream);
  if (err != cudaSuccess) return err;
  return amt_mlp_bf16(yc, w1i, bb1, w2i, bb2, xi, static_cast<__nv_bfloat16*>(g_scratch), o,
                      n, d, hid, s);
}
