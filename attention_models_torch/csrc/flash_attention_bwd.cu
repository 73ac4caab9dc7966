// Flash attention backward, one template for every layout: a dkv kernel and
// a dq kernel, each launched on its own from a given lse and delta.
//
// Replaces four TPU kernels of attention_models_tpu/ops/flash_attention.py:
//   - _flash_bwd_fused_kernel_mh_kv (+ _bwd_fused_body; entry
//     _flash_backward_bthd_kv): q (b, tq, h, d), packed kv (b, tk, 2, h, d),
//     dkv written back packed (amt_flash_bwd_kv: dkv, then dq);
//   - _flash_bwd_fused_kernel_mh (entry _flash_backward_bthd): q, k, v
//     (b, t, h, d), separate dk and dv (the same two launches);
//   - _flash_bwd_dkv_kernel (entry flash_bwd_dkv): dk, dv of one k/v chunk
//     on (b, h, t, d) from the GLOBAL lse and delta (amt_flash_bwd_dkv);
//   - _flash_bwd_dq_kernel (entry flash_bwd_dq): dq against one k/v chunk
//     from the same lse and delta (amt_flash_bwd_dq).
// The ring backward calls the last two once per ring step. Inputs: q, k, v
// and the output cotangent dout, the forward's natural-log lse and
// delta = rowsum(o * dout) in fp32; every operand is addressed through
// element strides (batch, head, row) with a contiguous last dimension and
// 16-byte aligned rows. P is recomputed as exp(S - lse), dS = P (dP - delta),
// and dK, dQ carry the softmax scale. The causal mask is bottom-right
// aligned, as in the forward. Head width d is a template parameter: 32 or 64.
//
// Bound on the H100: operations. For the same result the least work is the
// TPU fused kernel's five products, 10*b*h*tq*tk*d flops (causal: the
// visible pairs). This split recomputes S and dP in both halves: dkv does
// four products (8*b*h*tq*tk*d) and dq three (6*b*h*tq*tk*d), 14 in all.
// At the recon shape (b 8, h 8, t 1024, d 64) the pair is 60 GFLOP,
// 61 us at the bf16 tensor-core peak (43 us for the fused 10); at the
// long-context shape (b 1, h 8, t 16384, causal) 963 GFLOP, 0.97 ms.
//
// The TPU kernel adds dq over the k-block grid axis into one resident fp32
// output; that works only because a TPU grid runs in order. Here blocks run
// in parallel, so the backward is two kernels, deterministic (no atomics):
//   - dkv: a block per (64 keys, b*h) walks every q tile of the chunk (from
//     the first one its keys are visible to, under the causal mask) and
//     accumulates dK and dV in registers;
//   - dq:  a block per (64 queries, b*h) walks every k tile (up to its last
//     visible one), recomputes P and dP and accumulates dQ in registers.
// Neither holds more than one tile of the other side, so memory is O(t).
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

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kChunk = 16;  // fp32 kernels: rows per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides3 sq, sk, sv, sdo, sl, sdl, sdq, sdk, sdv;
  int h, tq, tk;
  float scale;
  int causal;
};

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

template <typename T>
__device__ __forceinline__ const T* head_of(const void* p, Strides3 s, int bi,
                                            int hi) {
  return static_cast<const T*>(p) + bi * s.b + hi * s.h;
}
template <typename T>
__device__ __forceinline__ T* head_of(void* p, Strides3 s, int bi, int hi) {
  return static_cast<T*>(p) + bi * s.b + hi * s.h;
}

template <int D>
__global__ __launch_bounds__(128) void flash_bwd_dkv_bf16_kernel(BwdArgs a) {
  constexpr int kS = D + 8;  // bf16 smem row stride
  constexpr int kKS = D / 16, kNT = D / 8;
  __shared__ __align__(16) bf16 qs[kBQ][kS];   // q tile
  __shared__ __align__(16) bf16 qss[kBQ][kS];  // q * scale*log2e, rounded
  __shared__ __align__(16) bf16 dos[kBQ][kS];  // dout tile
  __shared__ float lse_s[kBQ], delta_s[kBQ];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tq = a.tq, tk = a.tk, causal = a.causal;
  const int off = tk - tq;
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  const int kr0 = k0 + warp * 16;  // this warp's first key

  // this warp's 16 keys of k and v as A fragments (rows past tk are zero)
  const bf16* kb = head_of<bf16>(a.k, a.sk, bi, hi);
  const bf16* vb = head_of<bf16>(a.v, a.sv, bi, hi);
  uint32_t ka[kKS][4], va[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = kr0 + g + ((i & 1) ? 8 : 0);
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      const int64_t r = row < tk ? row : 0;
      ka[kk][i] = pair_or_zero(kb + r * a.sk.r + col, row < tk);
      va[kk][i] = pair_or_zero(vb + r * a.sv.r + col, row < tk);
    }
  }

  float dk[kNT][4], dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const bf16* qb = head_of<bf16>(a.q, a.sq, bi, hi);
  const bf16* db = head_of<bf16>(a.dout, a.sdo, bi, hi);
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* deb = a.delta + bi * a.sdl.b + hi * a.sdl.h;
  const int q_first = causal ? max(k0 - off, 0) : 0;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int q0 = q_first / kBQ * kBQ; q0 < tq; q0 += kBQ) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBQ * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = q0 + r < tq;
      const int64_t row = ok ? q0 + r : 0;
      const uint4 qv = ok ? *reinterpret_cast<const uint4*>(qb + row * a.sq.r + c) : zero;
      const uint4 dv4 = ok ? *reinterpret_cast<const uint4*>(db + row * a.sdo.r + c) : zero;
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
      const int64_t row = ok ? q0 + r : 0;
      lse_s[r] = ok ? lb[row * a.sl.r] * kLog2e : 0.f;
      delta_s[r] = ok ? deb[row * a.sdl.r] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K Q'^T, then P^T in place
    float st[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
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
      uint32_t pa[4];
      acc_to_a_frag(pa, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b[2];
        load_b_frag(b, &dos[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dv[n], pa, b);
      }
    }

    // dP^T (16 keys x 64 queries) = V dO^T, then dS^T = P^T (dP^T - delta)
    float dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
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
      uint32_t pa[4];
      acc_to_a_frag(pa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b[2];
        load_b_frag(b, &qs[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dk[n], pa, b);
      }
    }
  }

  bf16* dkb = head_of<bf16>(a.dk, a.sdk, bi, hi);
  bf16* dvb = head_of<bf16>(a.dv, a.sdv, bi, hi);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = kr0 + g + half * 8;
      if (key < tk) {
        *reinterpret_cast<uint32_t*>(dkb + key * a.sdk.r + col) =
            pack_bf16x2(dk[n][2 * half] * scale, dk[n][2 * half + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvb + key * a.sdv.r + col) =
            pack_bf16x2(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

template <int D>
__global__ __launch_bounds__(128) void flash_bwd_dq_bf16_kernel(BwdArgs a) {
  constexpr int kS = D + 8;
  constexpr int kKS = D / 16, kNT = D / 8;
  __shared__ __align__(16) bf16 ks[kBK][kS];
  __shared__ __align__(16) bf16 vs[kBK][kS];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tq = a.tq, tk = a.tk, causal = a.causal;
  const int off = tk - tq;
  const float scale = a.scale, scale_log2 = scale * kLog2e;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // A fragments: q scaled as the forward's S operand, and dout
  const bf16* qb = head_of<bf16>(a.q, a.sq, bi, hi);
  const bf16* db = head_of<bf16>(a.dout, a.sdo, bi, hi);
  uint32_t qa[kKS][4], da[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? r1 : r0;
      const int col = kk * 16 + 2 * t + ((i & 2) ? 8 : 0);
      const int64_t r = row < tq ? row : 0;
      qa[kk][i] = scaled_pair(qb + r * a.sq.r + col, row < tq, scale_log2);
      da[kk][i] = pair_or_zero(db + r * a.sdo.r + col, row < tq);
    }
  }
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* deb = a.delta + bi * a.sdl.b + hi * a.sdl.h;
  const float lse0 = r0 < tq ? lb[r0 * a.sl.r] * kLog2e : 0.f;
  const float lse1 = r1 < tq ? lb[r1 * a.sl.r] * kLog2e : 0.f;
  const float dl0 = r0 < tq ? deb[r0 * a.sdl.r] : 0.f;
  const float dl1 = r1 < tq ? deb[r1 * a.sdl.r] : 0.f;

  float dqa[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const bf16* kb = head_of<bf16>(a.k, a.sk, bi, hi);
  const bf16* vb = head_of<bf16>(a.v, a.sv, bi, hi);
  const int kend = causal ? min(tk, q0 + kBQ + off) : tk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBK * (D / 8); i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool ok = k0 + r < tk;
      const int64_t row = ok ? k0 + r : 0;
      cp_async16(&ks[r][c], kb + row * a.sk.r + c, ok);
      cp_async16(&vs[r][c], vb + row * a.sv.r + c, ok);
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
      for (int kk = 0; kk < kKS; ++kk) {
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
      for (int kk = 0; kk < kKS; ++kk) {
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
      uint32_t pa[4];
      acc_to_a_frag(pa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t b[2];
        load_b_frag(b, &ks[kk * 16][n * 8], kS, 1);
        mma_bf16_16816(dqa[n], pa, b);
      }
    }
  }

  bf16* dqb = head_of<bf16>(a.dq, a.sdq, bi, hi);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * a.sdq.r + col) =
          pack_bf16x2(dqa[n][0] * scale, dqa[n][1] * scale);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * a.sdq.r + col) =
          pack_bf16x2(dqa[n][2] * scale, dqa[n][3] * scale);
  }
}

template <int D>
__global__ __launch_bounds__(kBK) void flash_bwd_dkv_f32_kernel(BwdArgs a) {
  __shared__ float kt[kBK][D + 1];  // padded: thread-per-row reads
  __shared__ float vt[kBK][D + 1];
  __shared__ __align__(16) float qs[kChunk][D];
  __shared__ __align__(16) float dos[kChunk][D];
  __shared__ float lse_s[kChunk], delta_s[kChunk];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int k0 = blockIdx.x * kBK;
  const int key = k0 + threadIdx.x;
  const int tq = a.tq, tk = a.tk, causal = a.causal;
  const int off = tk - tq;
  const float scale = a.scale;

  const float* kb = head_of<float>(a.k, a.sk, bi, hi);
  const float* vb = head_of<float>(a.v, a.sv, bi, hi);
  for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool ok = k0 + r < tk;
    const int64_t row = ok ? k0 + r : 0;
    kt[r][c] = ok ? kb[row * a.sk.r + c] : 0.f;
    vt[r][c] = ok ? vb[row * a.sv.r + c] : 0.f;
  }

  float dk[D], dv[D];
#pragma unroll
  for (int c = 0; c < D; ++c) dk[c] = dv[c] = 0.f;

  const float* qb = head_of<float>(a.q, a.sq, bi, hi);
  const float* db = head_of<float>(a.dout, a.sdo, bi, hi);
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* deb = a.delta + bi * a.sdl.b + hi * a.sdl.h;
  const int q_first = causal ? max(k0 - off, 0) : 0;

  for (int qc = q_first; qc < tq; qc += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool ok = qc + r < tq;
      const int64_t row = ok ? qc + r : 0;
      qs[r][c] = ok ? qb[row * a.sq.r + c] : 0.f;
      dos[r][c] = ok ? db[row * a.sdo.r + c] : 0.f;
    }
    if (threadIdx.x < kChunk) {
      const int r = threadIdx.x;
      const bool ok = qc + r < tq;
      const int64_t row = ok ? qc + r : 0;
      lse_s[r] = ok ? lb[row * a.sl.r] : 0.f;
      delta_s[r] = ok ? deb[row * a.sdl.r] : 0.f;
    }
    __syncthreads();
    const int rows = min(kChunk, tq - qc);
    for (int i = 0; i < rows; ++i) {
      const int qrow = qc + i;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(kt[threadIdx.x][c], qs[i][c], s);
        dp = fmaf(vt[threadIdx.x][c], dos[i][c], dp);
      }
      const bool masked = causal && key > qrow + off;
      const float p = masked ? 0.f : expf(s * scale - lse_s[i]);
      const float ds = p * (dp - delta_s[i]);
#pragma unroll
      for (int c = 0; c < D; ++c) {
        dv[c] = fmaf(p, dos[i][c], dv[c]);
        dk[c] = fmaf(ds, qs[i][c], dk[c]);
      }
    }
  }

  if (key < tk) {
    float* dkb = head_of<float>(a.dk, a.sdk, bi, hi) + key * a.sdk.r;
    float* dvb = head_of<float>(a.dv, a.sdv, bi, hi) + key * a.sdv.r;
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      *reinterpret_cast<float4*>(dkb + c) = make_float4(
          dk[c] * scale, dk[c + 1] * scale, dk[c + 2] * scale, dk[c + 3] * scale);
      *reinterpret_cast<float4*>(dvb + c) =
          make_float4(dv[c], dv[c + 1], dv[c + 2], dv[c + 3]);
    }
  }
}

template <int D>
__global__ __launch_bounds__(kBQ) void flash_bwd_dq_f32_kernel(BwdArgs a) {
  __shared__ float qt[kBQ][D + 1];  // padded: thread-per-row reads
  __shared__ float dt[kBQ][D + 1];
  __shared__ __align__(16) float ks[kChunk][D];
  __shared__ __align__(16) float vs[kChunk][D];

  const int bi = blockIdx.y / a.h, hi = blockIdx.y % a.h;
  const int q0 = blockIdx.x * kBQ;
  const int row = q0 + threadIdx.x;
  const int tq = a.tq, tk = a.tk, causal = a.causal;
  const int off = tk - tq;
  const float scale = a.scale;

  const float* qb = head_of<float>(a.q, a.sq, bi, hi);
  const float* db = head_of<float>(a.dout, a.sdo, bi, hi);
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D, c = i % D;
    const bool ok = q0 + r < tq;
    const int64_t qr = ok ? q0 + r : 0;
    qt[r][c] = ok ? qb[qr * a.sq.r + c] : 0.f;
    dt[r][c] = ok ? db[qr * a.sdo.r + c] : 0.f;
  }
  const int64_t rr = row < tq ? row : 0;
  const float lse_r = row < tq ? a.lse[bi * a.sl.b + hi * a.sl.h + rr * a.sl.r] : 0.f;
  const float dl =
      row < tq ? a.delta[bi * a.sdl.b + hi * a.sdl.h + rr * a.sdl.r] : 0.f;

  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.f;

  const float* kb = head_of<float>(a.k, a.sk, bi, hi);
  const float* vb = head_of<float>(a.v, a.sv, bi, hi);
  const int kend = causal ? min(tk, q0 + kBQ + off) : tk;
  for (int kc = 0; kc < kend; kc += kChunk) {
    __syncthreads();
    for (int i = threadIdx.x; i < kChunk * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool ok = kc + r < tk;
      const int64_t kr = ok ? kc + r : 0;
      ks[r][c] = ok ? kb[kr * a.sk.r + c] : 0.f;
      vs[r][c] = ok ? vb[kr * a.sv.r + c] : 0.f;
    }
    __syncthreads();
    const int cols = min(kChunk, kend - kc);
    for (int j = 0; j < cols; ++j) {
      const int col = kc + j;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qt[threadIdx.x][c], ks[j][c], s);
        dp = fmaf(dt[threadIdx.x][c], vs[j][c], dp);
      }
      const bool masked = row >= tq || (causal && col > row + off);
      const float p = masked ? 0.f : expf(s * scale - lse_r);
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = fmaf(ds, ks[j][c], acc[c]);
    }
  }

  if (row < tq) {
    float* out = head_of<float>(a.dq, a.sdq, bi, hi) + row * a.sdq.r;
#pragma unroll
    for (int c = 0; c < D; c += 4)
      *reinterpret_cast<float4*>(out + c) = make_float4(
          acc[c] * scale, acc[c + 1] * scale, acc[c + 2] * scale,
          acc[c + 3] * scale);
  }
}

template <int D>
cudaError_t launch_dkv(const BwdArgs& a, int b, int dtype, cudaStream_t s) {
  const dim3 grid((a.tk + kBK - 1) / kBK, b * a.h);
  if (dtype == AMT_BF16)
    flash_bwd_dkv_bf16_kernel<D><<<grid, 128, 0, s>>>(a);
  else if (dtype == AMT_F32)
    flash_bwd_dkv_f32_kernel<D><<<grid, kBK, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdArgs& a, int b, int dtype, cudaStream_t s) {
  const dim3 grid((a.tq + kBQ - 1) / kBQ, b * a.h);
  if (dtype == AMT_BF16)
    flash_bwd_dq_bf16_kernel<D><<<grid, 128, 0, s>>>(a);
  else if (dtype == AMT_F32)
    flash_bwd_dq_f32_kernel<D><<<grid, kBQ, 0, s>>>(a);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

Strides3 strides_at(const int64_t* s, int i) {
  return Strides3{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

BwdArgs make_args(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, void* dk, void* dv, const int64_t* st, int h,
                  int tq, int tk, float scale, int causal) {
  return BwdArgs{q, k, v, dout, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), dq, dk, dv,
                 strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
                 strides_at(st, 3), strides_at(st, 4), strides_at(st, 5),
                 strides_at(st, 6), strides_at(st, 7), strides_at(st, 8),
                 h, tq, tk, scale, causal};
}

bool bad_shape(int b, int h, int tq, int tk) {
  return b < 0 || h <= 0 || tq <= 0 || tk <= 0 || (int64_t)b * h > 65535;
}

}  // namespace

// strides holds (batch, head, row) element strides of q, k, v, dout, lse,
// delta, dq, dk and dv, in that order (27 values; an absent output's are
// not read).
AMT_EXPORT int amt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const int64_t* strides, int b, int h, int tq,
                                 int tk, int d, float scale, int causal,
                                 int dtype, void* stream) {
  if (bad_shape(b, h, tq, tk)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv,
                              strides, h, tq, tk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dkv<64>(a, b, dtype, s);
  if (d == 32) return launch_dkv<32>(a, b, dtype, s);
  return cudaErrorInvalidValue;
}

AMT_EXPORT int amt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const int64_t* strides, int b, int h, int tq,
                                int tk, int d, float scale, int causal,
                                int dtype, void* stream) {
  if (bad_shape(b, h, tq, tk)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr,
                              nullptr, strides, h, tq, tk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_dq<64>(a, b, dtype, s);
  if (d == 32) return launch_dq<32>(a, b, dtype, s);
  return cudaErrorInvalidValue;
}

// Packed kv (kernel 5's layout): q, dout and dq (b, tq, h, d), kv and dkv
// (b, tk, 2, h, d), lse and delta (b, tq, h), all contiguous. Launches the
// dkv kernel, then the dq kernel.
AMT_EXPORT int amt_flash_bwd_kv(const void* q, const void* kv,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dkv, int b,
                                int tq, int tk, int h, int d, float scale,
                                int causal, int dtype, void* stream) {
  const int64_t hd = (int64_t)h * d;
  const int64_t tqh = (int64_t)tq * h;
  const int64_t st[27] = {tq * hd,     d, hd,      // q
                          2 * tk * hd, d, 2 * hd,  // k = kv[:, :, 0]
                          2 * tk * hd, d, 2 * hd,  // v = kv[:, :, 1]
                          tq * hd,     d, hd,      // dout
                          tqh,         1, h,       // lse
                          tqh,         1, h,       // delta
                          tq * hd,     d, hd,      // dq
                          2 * tk * hd, d, 2 * hd,  // dk = dkv[:, :, 0]
                          2 * tk * hd, d, 2 * hd}; // dv = dkv[:, :, 1]
  const size_t item = dtype == AMT_BF16 ? 2 : 4;
  const void* v = static_cast<const char*>(kv) + hd * item;
  void* dv = static_cast<char*>(dkv) + hd * item;
  const int err = amt_flash_bwd_dkv(q, kv, v, dout, lse, delta, dkv, dv, st,
                                    b, h, tq, tk, d, scale, causal, dtype,
                                    stream);
  if (err != cudaSuccess) return err;
  return amt_flash_bwd_dq(q, kv, v, dout, lse, delta, dq, st, b, h, tq, tk, d,
                          scale, causal, dtype, stream);
}
