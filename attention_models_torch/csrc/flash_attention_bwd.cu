// Flash attention backward on the packed kv projection.
//
// Replaces attention_models_tpu/ops/flash_attention.py::
// _flash_bwd_fused_kernel_mh_kv (+ _bwd_fused_body; entry
// _flash_backward_bthd_kv). Inputs: q and the output cotangent dout as
// (b, tq, h, 64), kv packed as (b, tk, 2, h, 64), the forward's natural-log
// lse and delta = rowsum(o * dout) as (b, tq, h) fp32. Outputs: dq
// (b, tq, h, 64) in q's dtype and dkv packed like kv. k, v of head hi are
// read from kv at a row stride of 2*h*64 elements and dk, dv written back
// the same way: no split copies. P is recomputed as exp(S - lse),
// dS = P * (dP - delta), and dK, dQ carry the softmax scale. The causal mask
// is bottom-right aligned, as in the forward.
//
// Bound on the H100: operations. The five products are 10*b*h*t*t*64 flops
// against ~75 MB of inputs and outputs: at the main path's b 8, h 8, t 1024
// that is 43 us at the bf16 tensor-core peak (641 us at the fp32 peak).
//
// The TPU kernel adds dq over the k-block grid axis into one resident fp32
// output; that works only because a TPU grid runs in order. Here blocks run
// in parallel, so the backward is two kernels, deterministic (no atomics):
//   - dkv: a block per (64 keys, b*h) walks the q tiles and accumulates
//     dK and dV in registers;
//   - dq:  a block per (64 queries, b*h) walks the k tiles, recomputes P and
//     dP (two extra products, 14 instead of 10 flops per score) and
//     accumulates dQ in registers.
//
// bf16 design: four warps, 16 rows each, mma.sync m16n8k16 with fp32
// accumulation. S is formed exactly as the forward forms it, from q scaled by
// scale*log2(e) and rounded to bf16, so P = exp2(S - lse*log2(e)) is
// normalised against the forward's own lse. P and dS are rounded to bf16
// before the products that take them (as the TPU kernel does); their fp32
// accumulators are reused as the next product's A fragments. Transposed
// operands are read element by element from shared memory (load_b_frag).
//
// fp32 design: one thread per key row (dkv) or query row (dq), fp32 FMA
// dots against tiles in shared memory, exact expf; only the order of the
// sums differs from the plain version.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kS = kD + 8;  // bf16 smem row stride
constexpr int kChunk = 16;  // fp32 kernels: rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// Fragment pairs straight from device memory: two bf16 at p (4-byte
// aligned) when row < limit, else zeros.
__device__ __forceinline__ uint32_t pair_or_zero(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ uint32_t scaled_pair(const bf16* p, bool ok,
                                                float scale) {
  if (!ok) return 0u;
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16x2(__bfloat162float(v.x) * scale,
                     __bfloat162float(v.y) * scale);
}

__global__ __launch_bounds__(128) void flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kv,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dkv, int tq, int tk,
    int h, float scale, int causal) {
  __shared__ __align__(16) bf16 qs[kBQ][kS];   // q tile
  __shared__ __align__(16) bf16 qss[kBQ][kS];  // q * scale*log2e, rounded
  __shared__ __align__(16) bf16 dos[kBQ][kS];  // dout tile
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hd = h * kD;
  const int64_t kv_row = 2 * (int64_t)hd;
  const int off = tk - tq;
  const float scale_log2 = scale * kLog2e;
  const int kr0 = k0 + warp * 16;  // this warp's first key

  // this warp's 16 keys of k and v as A fragments (rows past tk are zero)
  const bf16* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const bf16* vb = kb + hd;
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = kr0 + g + ((i & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      const int64_t at = (int64_t)row * kv_row + col;
      ka[kk][i] = pair_or_zero(kb + at, row < tk);
      va[kk][i] = pair_or_zero(vb + at, row < tk);
    }
  }

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bf16* qb = q + (int64_t)bi * tq * hd + hi * kD;
  const bf16* db = dout + (int64_t)bi * tq * hd + hi * kD;
  const float* lb = lse + (int64_t)bi * tq * h + hi;
  const float* deb = delta + (int64_t)bi * tq * h + hi;
  const int q_first = causal ? max(k0 - off, 0) : 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int q0 = q_first / kBQ * kBQ; q0 < tq; q0 += kBQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBQ * (kD / 8); i += blockDim.x) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool ok = q0 + r < tq;
      const uint4 qv = ok ? *reinterpret_cast<const uint4*>(qb + (int64_t)(q0 + r) * hd + c) : zero;
      const uint4 dv4 = ok ? *reinterpret_cast<const uint4*>(db + (int64_t)(q0 + r) * hd + c) : zero;
      *reinterpret_cast<uint4*>(&qs[r][c]) = qv;
      *reinterpret_cast<uint4*>(&dos[r][c]) = dv4;
      const bf16* e = reinterpret_cast<const bf16*>(&qv);
      uint4 sv;
      uint32_t* sp = reinterpret_cast<uint32_t*>(&sv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sp[j] = pack_bf16x2(__bfloat162float(e[2 * j]) * scale_log2,
                            __bfloat162float(e[2 * j + 1]) * scale_log2);
      *reinterpret_cast<uint4*>(&qss[r][c]) = sv;
    }
    if (threadIdx.x < kBQ) {
      const int r = threadIdx.x;
      const bool ok = q0 + r < tq;
      lse_s[r] = ok ? lb[(int64_t)(q0 + r) * h] * kLog2e : 0.f;
      delta_s[r] = ok ? deb[(int64_t)(q0 + r) * h] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K Q'^T, then P^T in place
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        load_b_frag(b, &qss[j * 8][kk * 16], 1, kS);
        mma_bf16_16816(st[j], ka[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr0 + g + ((e & 2) ? 8 : 0);
        const int qi = j * 8 + 2 * t + (e & 1);
        const int qrow = q0 + qi;
        const bool masked = qrow >= tq || (causal && key > qrow + off);
        st[j][e] = masked ? 0.f : exp2f(st[j][e] - lse_s[qi]);
      }
    }

    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b_frag(b, &dos[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dv[n], a, b);
      }
    }

    // dP^T (16 keys x 64 queries) = V dO^T, then dS^T = P^T (dP^T - delta)
    float dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        load_b_frag(b, &dos[j * 8][kk * 16], 1, kS);
        mma_bf16_16816(dpt[j], va[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + 2 * t + (e & 1);
        dpt[j][e] = st[j][e] * (dpt[j][e] - delta_s[qi]);
      }
    }

    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b_frag(b, &qs[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dk[n], a, b);
      }
    }
  }

  bf16* dkb = dkv + (int64_t)bi * tk * kv_row + hi * kD;
  bf16* dvb = dkb + hd;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kr0 + g + half * 8;
      if (key < tk) {
        const int64_t at = (int64_t)key * kv_row + col;
        *reinterpret_cast<uint32_t*>(dkb + at) =
            pack_bf16x2(dk[n][2 * half] * scale, dk[n][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + at) =
            pack_bf16x2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

__global__ __launch_bounds__(128) void flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kv,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int tq, int tk,
    int h, float scale, int causal) {
  __shared__ __align__(16) bf16 ks[kBK][kS];
  __shared__ __align__(16) bf16 vs[kBK][kS];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hd = h * kD;
  const int64_t kv_row = 2 * (int64_t)hd;
  const int off = tk - tq;
  const float scale_log2 = scale * kLog2e;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // A fragments: q scaled as the forward's S operand, and dout
  const bf16* qb = q + (int64_t)bi * tq * hd + hi * kD;
  const bf16* db = dout + (int64_t)bi * tq * hd + hi * kD;
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      const int64_t at = (int64_t)row * hd + col;
      qa[kk][i] = scaled_pair(qb + at, row < tq, scale_log2);
      da[kk][i] = pair_or_zero(db + at, row < tq);
    }
  }
  const float* lb = lse + (int64_t)bi * tq * h + hi;
  const float* deb = delta + (int64_t)bi * tq * h + hi;
  const float lse0 = r0 < tq ? lb[(int64_t)r0 * h] * kLog2e : 0.f;
  const float lse1 = r1 < tq ? lb[(int64_t)r1 * h] * kLog2e : 0.f;
  const float dl0 = r0 < tq ? deb[(int64_t)r0 * h] : 0.f;
  const float dl1 = r1 < tq ? deb[(int64_t)r1 * h] : 0.f;

  float dqa[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const bf16* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const bf16* vb = kb + hd;
  const int kend = causal ? min(tk, q0 + kBQ + off) : tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * (kD / 8); i += blockDim.x) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      const bool ok = k0 + r < tk;
      const int64_t at = ok ? (k0 + r) * kv_row + c : 0;
      cp_async16(&ks[r][c], kb + at, ok);
      cp_async16(&vs[r][c], vb + at, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // S = Q' K^T, then P in place
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        load_b_frag(b, &ks[j * 8][kk * 16], 1, kS);
        mma_bf16_16816(s[j], qa[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const bool masked =
            row >= tq || col >= tk || (causal && col > row + off);
        s[j][e] = masked ? 0.f : exp2f(s[j][e] - (e < 2 ? lse0 : lse1));
      }
    }

    // dP = dO V^T, then dS = P (dP - delta)
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t b[2];
        load_b_frag(b, &vs[j * 8][kk * 16], 1, kS);
        mma_bf16_16816(dp[j], da[kk], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? dl0 : dl1));
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a_frag(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b[2];
        load_b_frag(b, &ks[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dqa[n], a, b);
      }
    }
  }

  bf16* dqb = dq + (int64_t)bi * tq * hd + hi * kD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)r0 * hd + col) =
          pack_bf16x2(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(dqb + (int64_t)r1 * hd + col) =
          pack_bf16x2(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

__global__ __launch_bounds__(kBK) void flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dkv, int tq, int tk,
    int h, float scale, int causal) {
  __shared__ float kt[kBK][kD + 1];  // padded: thread-per-row reads
  __shared__ float vt[kBK][kD + 1];
  __shared__ __align__(16) float qs[kChunk][kD];
  __shared__ __align__(16) float dos[kChunk][kD];
  __shared__ float lse_s[kChunk], delta_s[kChunk];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int k0 = blockIdx.x * kBK;
  const int key = k0 + threadIdx.x;
  const int hd = h * kD;
  const int64_t kv_row = 2 * (int64_t)hd;
  const int off = tk - tq;

  const float* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const float* vb = kb + hd;
  for (int i = threadIdx.x; i < kBK * kD; i += blockDim.x) {
    const int r = i / kD, c = i % kD;
    const bool ok = k0 + r < tk;
    kt[r][c] = ok ? kb[(k0 + r) * kv_row + c] : 0.f;
    vt[r][c] = ok ? vb[(k0 + r) * kv_row + c] : 0.f;
  }

  float dk[kD], dv[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) dk[c] = dv[c] = 0.f;

  const float* qb = q + (int64_t)bi * tq * hd + hi * kD;
  const float* db = dout + (int64_t)bi * tq * hd + hi * kD;
  const float* lb = lse + (int64_t)bi * tq * h + hi;
  const float* deb = delta + (int64_t)bi * tq * h + hi;
  const int q_first = causal ? max(k0 - off, 0) : 0;

  for (int qc = q_first; qc < tq; qc += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kD; i += blockDim.x) {
      const int r = i / kD, c = i % kD;
      const bool ok = qc + r < tq;
      qs[r][c] = ok ? qb[(int64_t)(qc + r) * hd + c] : 0.f;
      dos[r][c] = ok ? db[(int64_t)(qc + r) * hd + c] : 0.f;
    }
    if (threadIdx.x < kChunk) {
      const int r = threadIdx.x;
      const bool ok = qc + r < tq;
      lse_s[r] = ok ? lb[(int64_t)(qc + r) * h] : 0.f;
      delta_s[r] = ok ? deb[(int64_t)(qc + r) * h] : 0.f;
    }
    __syncthreads();
    const int rows = min(kChunk, tq - qc);
    for (int i = 0; i < rows; ++i) {
      const int qrow = qc + i;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        s = fmaf(kt[threadIdx.x][c], qs[i][c], s);
        dp = fmaf(vt[threadIdx.x][c], dos[i][c], dp);
      }
      const bool masked = causal && key > qrow + off;
      const float p = masked ? 0.f : expf(s * scale - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        dv[c] = fmaf(p, dos[i][c], dv[c]);
        dk[c] = fmaf(ds, qs[i][c], dk[c]);
      }
    }
  }

  if (key < tk) {
    float* dkb = dkv + (int64_t)bi * tk * kv_row + (int64_t)key * kv_row + hi * kD;
    float* dvb = dkb + hd;
#pragma unroll
    for (int c = 0; c < kD; c += 4) {
      *reinterpret_cast<float4*>(dkb + c) = make_float4(
          dk[c] * scale, dk[c + 1] * scale, dk[c + 2] * scale, dk[c + 3] * scale);
      *reinterpret_cast<float4*>(dvb + c) =
          make_float4(dv[c], dv[c + 1], dv[c + 2], dv[c + 3]);
    }
  }
}

__global__ __launch_bounds__(kBQ) void flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ kv,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int tq, int tk,
    int h, float scale, int causal) {
  __shared__ float qt[kBQ][kD + 1];  // padded: thread-per-row reads
  __shared__ float dt[kBQ][kD + 1];
  __shared__ __align__(16) float ks[kChunk][kD];
  __shared__ __align__(16) float vs[kChunk][kD];

  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + threadIdx.x;
  const int hd = h * kD;
  const int64_t kv_row = 2 * (int64_t)hd;
  const int off = tk - tq;

  const float* qb = q + (int64_t)bi * tq * hd + hi * kD;
  const float* db = dout + (int64_t)bi * tq * hd + hi * kD;
  for (int i = threadIdx.x; i < kBQ * kD; i += blockDim.x) {
    const int r = i / kD, c = i % kD;
    const bool ok = q0 + r < tq;
    qt[r][c] = ok ? qb[(int64_t)(q0 + r) * hd + c] : 0.f;
    dt[r][c] = ok ? db[(int64_t)(q0 + r) * hd + c] : 0.f;
  }
  const int64_t rh = ((int64_t)bi * tq + row) * h + hi;
  const float lse_r = row < tq ? lse[rh] : 0.f;
  const float dl = row < tq ? delta[rh] : 0.f;

  float acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;

  const float* kb = kv + (int64_t)bi * tk * kv_row + hi * kD;
  const float* vb = kb + hd;
  const int kend = causal ? min(tk, q0 + kBQ + off) : tk;
  for (int kc = 0; kc < kend; kc += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * kD; i += blockDim.x) {
      const int r = i / kD, c = i % kD;
      const bool ok = kc + r < tk;
      ks[r][c] = ok ? kb[(kc + r) * kv_row + c] : 0.f;
      vs[r][c] = ok ? vb[(kc + r) * kv_row + c] : 0.f;
    }
    __syncthreads();
    const int cols = min(kChunk, kend - kc);
    for (int j = 0; j < cols; ++j) {
      const int col = kc + j;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kD; ++c) {
        s = fmaf(qt[threadIdx.x][c], ks[j][c], s);
        dp = fmaf(dt[threadIdx.x][c], vs[j][c], dp);
      }
      const bool masked = row >= tq || (causal && col > row + off);
      const float p = masked ? 0.f : expf(s * scale - lse_r);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] = fmaf(ds, ks[j][c], acc[c]);
    }
  }

  if (row < tq) {
    float* out = dq + ((int64_t)bi * tq + row) * hd + hi * kD;
#pragma unroll
    for (int c = 0; c < kD; c += 4)
      *reinterpret_cast<float4*>(out + c) = make_float4(
          acc[c] * scale, acc[c + 1] * scale, acc[c + 2] * scale,
          acc[c + 3] * scale);
  }
}

}  // namespace

AMT_EXPORT int amt_flash_bwd_kv(const void* q, const void* kv,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dkv, int b,
                                int tq, int tk, int h, int d, float scale,
                                int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != kD || tq <= 0 || tk <= 0) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const dim3 grid_kv((tk + kBK - 1) / kBK, b * h);
  const dim3 grid_q((tq + kBQ - 1) / kBQ, b * h);
  if (dtype == AMT_BF16) {
    const auto* qi = static_cast<const bf16*>(q);
    const auto* kvi = static_cast<const bf16*>(kv);
    const auto* di = static_cast<const bf16*>(dout);
    const auto* li = static_cast<const float*>(lse);
    const auto* dli = static_cast<const float*>(delta);
    flash_bwd_dkv_bf16_kernel<<<grid_kv, 128, 0, s>>>(
        qi, kvi, di, li, dli, static_cast<bf16*>(dkv), tq, tk, h, scale,
        causal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<<<grid_q, 128, 0, s>>>(
        qi, kvi, di, li, dli, static_cast<bf16*>(dq), tq, tk, h, scale, causal);
    return cudaGetLastError();
  }
  if (dtype == AMT_F32) {
    const auto* qi = static_cast<const float*>(q);
    const auto* kvi = static_cast<const float*>(kv);
    const auto* di = static_cast<const float*>(dout);
    const auto* li = static_cast<const float*>(lse);
    const auto* dli = static_cast<const float*>(delta);
    flash_bwd_dkv_f32_kernel<<<grid_kv, kBK, 0, s>>>(
        qi, kvi, di, li, dli, static_cast<float*>(dkv), tq, tk, h, scale,
        causal);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<<<grid_q, kBQ, 0, s>>>(
        qi, kvi, di, li, dli, static_cast<float*>(dq), tq, tk, h, scale,
        causal);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
