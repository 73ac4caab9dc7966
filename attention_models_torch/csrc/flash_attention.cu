// Flash attention forward on the packed kv projection.
//
// Replaces attention_models_tpu/ops/flash_attention.py::_flash_kernel_mh_kv
// (+ _fwd_core; entry flash_attention_bthd_kv / _flash_forward_bthd_kv).
//
// q is (b, tq, h, 64) and kv is (b, tk, 2, h, 64), the fused kv.0
// projection's output viewed in place: k and v of head hi are read straight
// from it at a row stride of 2*h*64 elements, so no split copy of k or v is
// ever made (avoiding those copies is the TPU kernel's point). Outputs: out
// (b, tq, h, 64) in q's dtype and the natural-log logsumexp lse (b, tq, h) in
// fp32, which the backward needs. The optional causal mask is bottom-right
// aligned: query row r sees keys c <= r + (tk - tq); the Python wrapper
// rejects tq > tk.
//
// Bound on the H100: operations. At the main path's b 8, h 8, t 1024 the two
// products are 4*b*h*t*t*64 = 17.2 GFLOP against 50 MB of q/kv/out, about
// 17 us at the bf16 tensor-core peak.
//
// bf16 design: the grid runs over (q tiles of 64 rows, b*h); a block of four
// warps takes one q tile, each warp 16 query rows. k and v stream through
// shared memory in tiles of 64 keys, double-buffered with cp.async so the
// next tile loads while this one is computed. S = Q K^T and O += P V are mma.sync
// m16n8k16 with fp32 accumulation; q is scaled by scale*log2(e) in fp32 and
// rounded to bf16 once, so the online softmax runs in exp2 with no per-score
// multiply, as the TPU kernel does. P is rounded to bf16 for the PV product
// straight from the S accumulators (the m16n8 C layout is the A layout of
// the next product), and the row sum l stays fp32.
//
// fp32 design (the exact path the golden index check runs): one thread per
// query row, 64 rows a block, q row and output accumulator in registers,
// k/v tiles in shared memory read as broadcasts, fp32 FMA dots, exact expf.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kStride = kD + 8;  // bf16 smem row stride: conflict-free fragments
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__global__ __launch_bounds__(128) void flash_fwd_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int tq, int tk,
    int h, float scale_log2, int causal) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBlockK][kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBlockK][kStride];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hd = h * kD;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int off = tk - tq;

  // Q fragments (A operand), pre-scaled into the log2 domain
  const __nv_bfloat16* qb = q + (int64_t)bi * tq * hd + hi * kD;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < tq) {
        x0 = __bfloat162float(qb[(int64_t)row * hd + col]);
        x1 = __bfloat162float(qb[(int64_t)row * hd + col + 1]);
      }
      qa[kk][i] = pack_bf16x2(x0 * scale_log2, x1 * scale_log2);
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int64_t kv_row = 2 * (int64_t)hd;
  const __nv_bfloat16* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const __nv_bfloat16* vb = kb + hd;
  const int kend = causal ? min(tk, q0 + kBlockQ + off) : tk;
  const int ntiles = (kend + kBlockK - 1) / kBlockK;

  // k/v tiles are double-buffered: tile it+1 is in flight (cp.async, rows
  // past tk zero-filled) while tile it is computed on
  auto load_tile = [&](int k0, int buf) {
    for (int i = threadIdx.x; i < kBlockK * (kD / 8); i += blockDim.x) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool ok = k0 + r < tk;
      const int64_t at = ok ? (k0 + r) * kv_row + c : 0;
      cp_async16(&ks[buf][r][c], kb + at, ok);
      cp_async16(&vs[buf][r][c], vb + at, ok);
    }
    cp_async_commit();
  };
  load_tile(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK, buf = it & 1;
    if (it + 1 < ntiles) {
      load_tile(k0 + kBlockK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys, each over 4 steps of 16 dims
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&ks[buf][j * 8 + g][kk * 16 + 2 * t]);
        b[1] = *reinterpret_cast<const uint32_t*>(&ks[buf][j * 8 + g][kk * 16 + 2 * t + 8]);
        mma_bf16_16816(s[j], qa[kk], b);
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        if (col >= tk || (causal && col > row + off)) s[j][e] = kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float m = e < 2 ? m0 : m1;
        s[j][e] = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m);
      }
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + ps0;  // partial over this thread's columns
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: 4 steps of 16 keys, 8 tiles of 8 output dims
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = n * 8 + g;
        uint32_t b[2];
        b[0] = pack_bf16x2_raw(vs[buf][kr][c], vs[buf][kr + 1][c]);
        b[1] = pack_bf16x2_raw(vs[buf][kr + 8][c], vs[buf][kr + 9][c]);
        mma_bf16_16816(o[n], a, b);
      }
    }
    __syncthreads();  // buf is refilled by the next iteration's load
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* ob = out + (int64_t)bi * tq * hd + hi * kD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r0 * hd + col) =
          pack_bf16x2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)r1 * hd + col) =
          pack_bf16x2(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (t == 0) {
    float* lb = lse + (int64_t)bi * tq * h + hi;
    if (r0 < tq) lb[(int64_t)r0 * h] = (m0 + log2f(l0)) * kLn2;
    if (r1 < tq) lb[(int64_t)r1 * h] = (m1 + log2f(l1)) * kLn2;
  }
}

constexpr int kChunk = 16;

__global__ __launch_bounds__(kBlockQ) void flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    float* __restrict__ out, float* __restrict__ lse, int tq, int tk, int h,
    float scale, int causal) {
  __shared__ __align__(16) float ks[kBlockK][kD];
  __shared__ __align__(16) float vs[kBlockK][kD];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + threadIdx.x;
  const int hd = h * kD;
  const int off = tk - tq;

  float qr[kD], acc[kD];
  const float4* qrow = reinterpret_cast<const float4*>(
      q + ((int64_t)bi * tq + row) * hd + hi * kD);
#pragma unroll
  for (int c = 0; c < kD / 4; ++c) {
    const float4 v = row < tq ? qrow[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = v.x;
    qr[4 * c + 1] = v.y;
    qr[4 * c + 2] = v.z;
    qr[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  const int64_t kv_row = 2 * (int64_t)hd;
  const float* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const float* vb = kb + hd;
  const int kend = causal ? min(tk, q0 + kBlockQ + off) : tk;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * (kD / 4); i += blockDim.x) {
      const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
      float4 kval = make_float4(0.f, 0.f, 0.f, 0.f), vval = kval;
      if (k0 + r < tk) {
        kval = *reinterpret_cast<const float4*>(kb + (k0 + r) * kv_row + c);
        vval = *reinterpret_cast<const float4*>(vb + (k0 + r) * kv_row + c);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kval;
      *reinterpret_cast<float4*>(&vs[r][c]) = vval;
    }
    __syncthreads();

    const int kmax = min(kBlockK, kend - k0);
    for (int c0 = 0; c0 < kmax; c0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c0 + jj, col = k0 + j;
        const float4* k4 = reinterpret_cast<const float4*>(ks[j]);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < kD / 4; ++c) {
          const float4 e = k4[c];
          dot = fmaf(qr[4 * c + 0], e.x, dot);
          dot = fmaf(qr[4 * c + 1], e.y, dot);
          dot = fmaf(qr[4 * c + 2], e.z, dot);
          dot = fmaf(qr[4 * c + 3], e.w, dot);
        }
        const bool masked = col >= tk || (causal && col > row + off);
        s[jj] = masked ? kNegInf : dot * scale;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = expf(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = s[jj] == kNegInf ? 0.f : expf(s[jj] - m);
        l += p;
        const float4* v4 = reinterpret_cast<const float4*>(vs[c0 + jj]);
#pragma unroll
        for (int c = 0; c < kD / 4; ++c) {
          const float4 e = v4[c];
          acc[4 * c + 0] = fmaf(p, e.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(p, e.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(p, e.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(p, e.w, acc[4 * c + 3]);
        }
      }
    }
  }

  if (row < tq) {
    const float inv = 1.f / l;
    float4* orow = reinterpret_cast<float4*>(
        out + ((int64_t)bi * tq + row) * hd + hi * kD);
#pragma unroll
    for (int c = 0; c < kD / 4; ++c)
      orow[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                            acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
    lse[((int64_t)bi * tq + row) * h + hi] = m + logf(l);
  }
}

}  // namespace

AMT_EXPORT int amt_flash_fwd_kv(const void* q, const void* kv, void* out,
                                void* lse, int b, int tq, int tk, int h, int d,
                                float scale, int causal, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != kD) return cudaErrorInvalidValue;
  if (b == 0 || tq == 0) return cudaSuccess;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, b * h);
  if (dtype == AMT_BF16) {
    flash_fwd_bf16_kernel<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kv), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(lse), tq, tk, h, scale * kLog2e, causal);
    return cudaGetLastError();
  }
  if (dtype == AMT_F32) {
    flash_fwd_f32_kernel<<<grid, kBlockQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(kv),
        static_cast<float*>(out), static_cast<float*>(lse), tq, tk, h, scale,
        causal);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
