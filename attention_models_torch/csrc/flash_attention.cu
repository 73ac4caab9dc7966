// Flash attention forward, one template for every layout.
//
// Replaces three TPU kernels of attention_models_tpu/ops/flash_attention.py,
// which compute the same arithmetic on different layouts:
//   - _flash_kernel_mh_kv (+ _fwd_core; entry _flash_forward_bthd_kv):
//     q (b, tq, h, d) over the packed kv projection (b, tk, 2, h, d), the
//     kv.0 output viewed in place, so k and v are never split into copies;
//   - _flash_kernel_mh (entry _flash_forward_bthd): q, k, v (b, t, h, d);
//   - _flash_kernel (entry _flash_forward): q, k, v (b, h, t, d), the
//     long-context and ring-attention building block.
// The kernels take element strides (batch, head, row) for q, k, v, out and
// lse, so the three layouts are three sets of strides (amt_flash_fwd_kv
// computes the packed set itself). The last dimension is contiguous and
// every row is 16-byte aligned (the wrapper checks both). Outputs: out in
// q's dtype and the natural-log logsumexp lse in fp32, which the backward
// needs. The optional causal mask is bottom-right aligned: query row r sees
// keys c <= r + (tk - tq); the Python wrapper rejects tq > tk. Head width
// d is a template parameter: 32 or 64.
//
// Bound on the H100: operations. The two products are 4*b*h*tq*tk*d flops
// (causal: only the visible pairs) against q, k, v and out read or written
// once: at the recon shape (b 8, h 8, t 1024, d 64) 17.2 GFLOP against
// 50 MB, about 17 us at the bf16 tensor-core peak; at the long-context
// shape (b 1, h 8, t 16384, causal) 275 GFLOP, 0.28 ms.
//
// bf16 design: the grid runs over (q tiles of 64 rows, b*h); a block of four
// warps takes one q tile, each warp 16 query rows. k and v stream through
// shared memory in tiles of 64 keys, double-buffered with cp.async so the
// next tile loads while this one is computed: memory is O(t), never a
// (t, t) score matrix. S = Q K^T and O += P V are mma.sync m16n8k16 with
// fp32 accumulation; q is scaled by scale*log2(e) in fp32 and rounded to
// bf16 once, so the online softmax runs in exp2 with no per-score multiply,
// as the TPU kernel does. P is rounded to bf16 for the PV product straight
// from the S accumulators (the m16n8 C layout is the A layout of the next
// product), and the row sum l stays fp32. Causal q tiles stop at their last
// visible key tile, so the work follows the visible pairs.
//
// fp32 design (the exact path the golden index check runs): one thread per
// query row, 64 rows a block, q row and output accumulator in registers,
// k/v tiles in shared memory read as broadcasts, fp32 FMA dots, exact expf.
#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  Strides3 sq, sk, sv, so, sl;
  int h, tq, tk;
  float scale;
  int causal;
};

template <int D>
__global__ __launch_bounds__(128) void flash_fwd_bf16_kernel(FwdArgs a) {
  constexpr int kS = D + 8;  // bf16 smem row stride: conflict-free fragments
  constexpr int kKS = D / 16;  // k-steps of a product over the head dim
  constexpr int kNT = D / 8;   // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBlockK][kS];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBlockK][kS];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tq = a.tq, tk = a.tk;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows
  const int off = tk - tq;
  const float scale_log2 = a.scale * kLog2e;

  // Q fragments (A operand), pre-scaled into the log2 domain
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) +
                            bi * a.sq.b + hi * a.sq.h;
  uint32_t qa[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < tq) {
        x0 = __bfloat162float(qb[row * a.sq.r + col]);
        x1 = __bfloat162float(qb[row * a.sq.r + col + 1]);
      }
      qa[kk][i] = pack_bf16x2(x0 * scale_log2, x1 * scale_log2);
    }
  }

  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) +
                            bi * a.sk.b + hi * a.sk.h;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) +
                            bi * a.sv.b + hi * a.sv.h;
  const int kend = a.causal ? min(tk, q0 + kBlockQ + off) : tk;
  const int ntiles = (kend + kBlockK - 1) / kBlockK;

  // k/v tiles are double-buffered: tile it+1 is in flight (cp.async, rows
  // past tk zero-filled) while tile it is computed on
  auto load_tile = [&](int k0, int buf) {
    for (int i = threadIdx.x; i < kBlockK * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < tk;
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(&ks[buf][r][c], kb + row * a.sk.r + c, ok);
      cp_async16(&vs[buf][r][c], vb + row * a.sv.r + c, ok);
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

    // S = Q K^T: 8 tiles of 8 keys, each over D/16 steps of 16 dims
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
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
        if (col >= tk || (a.causal && col > row + off)) s[j][e] = kNegInf;
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
    for (int n = 0; n < kNT; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // O += P V: 4 steps of 16 keys, D/8 tiles of 8 output dims
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int kr = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const int c = n * 8 + g;
        uint32_t b[2];
        b[0] = pack_bf16x2_raw(vs[buf][kr][c], vs[buf][kr + 1][c]);
        b[1] = pack_bf16x2_raw(vs[buf][kr + 8][c], vs[buf][kr + 9][c]);
        mma_bf16_16816(o[n], pa, b);
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
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + bi * a.so.b +
                      hi * a.so.h;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(ob + r0 * a.so.r + col) =
          pack_bf16x2(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(ob + r1 * a.so.r + col) =
          pack_bf16x2(o[n][2] * inv1, o[n][3] * inv1);
  }
  if (t == 0) {
    float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
    if (r0 < tq) lb[r0 * a.sl.r] = (m0 + log2f(l0)) * kLn2;
    if (r1 < tq) lb[r1 * a.sl.r] = (m1 + log2f(l1)) * kLn2;
  }
}

constexpr int kChunk = 16;

template <int D>
__global__ __launch_bounds__(kBlockQ) void flash_fwd_f32_kernel(FwdArgs a) {
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int q0 = blockIdx.x * kBlockQ;
  const int row = q0 + threadIdx.x;
  const int tq = a.tq, tk = a.tk;
  const int off = tk - tq;

  float qr[D], acc[D];
  const float4* qrow = reinterpret_cast<const float4*>(
      static_cast<const float*>(a.q) + bi * a.sq.b + hi * a.sq.h +
      (row < tq ? row : 0) * a.sq.r);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 v = row < tq ? qrow[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * c + 0] = v.x;
    qr[4 * c + 1] = v.y;
    qr[4 * c + 2] = v.z;
    qr[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;
  float m = kNegInf, l = 0.f;

  const float* kb = static_cast<const float*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.sv.b + hi * a.sv.h;
  const int kend = a.causal ? min(tk, q0 + kBlockQ + off) : tk;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * (D / 4); i += blockDim.x) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kval = make_float4(0.f, 0.f, 0.f, 0.f), vval = kval;
      if (k0 + r < tk) {
        const int64_t kr = k0 + r;
        kval = *reinterpret_cast<const float4*>(kb + kr * a.sk.r + c);
        vval = *reinterpret_cast<const float4*>(vb + kr * a.sv.r + c);
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
        for (int c = 0; c < D / 4; ++c) {
          const float4 e = k4[c];
          dot = fmaf(qr[4 * c + 0], e.x, dot);
          dot = fmaf(qr[4 * c + 1], e.y, dot);
          dot = fmaf(qr[4 * c + 2], e.z, dot);
          dot = fmaf(qr[4 * c + 3], e.w, dot);
        }
        const bool masked = col >= tk || (a.causal && col > row + off);
        s[jj] = masked ? kNegInf : dot * a.scale;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = expf(m - mx);
      m = mx;
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = s[jj] == kNegInf ? 0.f : expf(s[jj] - m);
        l += p;
        const float4* v4 = reinterpret_cast<const float4*>(vs[c0 + jj]);
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
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
        static_cast<float*>(a.out) + bi * a.so.b + hi * a.so.h + row * a.so.r);
#pragma unroll
    for (int c = 0; c < D / 4; ++c)
      orow[c] = make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv,
                            acc[4 * c + 2] * inv, acc[4 * c + 3] * inv);
    a.lse[bi * a.sl.b + hi * a.sl.h + row * a.sl.r] = m + logf(l);
  }
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, int b, int dtype, cudaStream_t s) {
  const dim3 grid((a.tq + kBlockQ - 1) / kBlockQ, b * a.h);
  if (dtype == AMT_BF16) {
    flash_fwd_bf16_kernel<D><<<grid, 128, 0, s>>>(a);
    return cudaGetLastError();
  }
  if (dtype == AMT_F32) {
    flash_fwd_f32_kernel<D><<<grid, kBlockQ, 0, s>>>(a);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

Strides3 strides_at(const int64_t* s, int i) {
  return Strides3{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// General entry: strides holds (batch, head, row) element strides of q, k,
// v, out and lse, in that order (15 values).
AMT_EXPORT int amt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const int64_t* strides,
                             int b, int h, int tq, int tk, int d, float scale,
                             int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tq < 0 || tk <= 0 || h <= 0 || (int64_t)b * h > 65535)
    return cudaErrorInvalidValue;
  if (b == 0 || tq == 0) return cudaSuccess;
  FwdArgs a{q, k, v, out, static_cast<float*>(lse),
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4), h, tq, tk, scale, causal};
  if (d == 64) return launch_fwd<64>(a, b, dtype, s);
  if (d == 32) return launch_fwd<32>(a, b, dtype, s);
  return cudaErrorInvalidValue;
}

// Packed kv (kernel 1's layout): q (b, tq, h, d), kv (b, tk, 2, h, d), out
// like q, lse (b, tq, h), all contiguous.
AMT_EXPORT int amt_flash_fwd_kv(const void* q, const void* kv, void* out,
                                void* lse, int b, int tq, int tk, int h, int d,
                                float scale, int causal, int dtype,
                                void* stream) {
  const int64_t hd = (int64_t)h * d;
  const int64_t st[15] = {tq * hd,          d, hd,      // q
                          2 * tk * hd,      d, 2 * hd,  // k = kv[:, :, 0]
                          2 * tk * hd,      d, 2 * hd,  // v = kv[:, :, 1]
                          tq * hd,          d, hd,      // out
                          (int64_t)tq * h,  1, h};      // lse
  const size_t item = dtype == AMT_BF16 ? 2 : 4;
  const void* v = static_cast<const char*>(kv) + hd * item;
  return amt_flash_fwd(q, kv, v, out, lse, st, b, h, tq, tk, d, scale, causal,
                       dtype, stream);
}
