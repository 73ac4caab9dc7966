// Flash attention backward, one template for every layout: a dkv kernel and
// a dq kernel, each launched on its own from a given lse and delta.
//
// Replaces four TPU kernels of attention_models_tpu/ops/flash_attention.py:
//   - _flash_bwd_fused_kernel_mh_kv (+ _bwd_fused_body; entry
//     _flash_backward_bthd_kv): q (b, tq, h, d), packed kv (b, tk, 2, h, d),
//     dkv written back packed (amt_flash_bwd_kv: dkv, then dq);
//   - _flash_bwd_fused_kernel_mh (entry _flash_backward_bthd): q, k, v
//     (b, t, h, d), separate dk and dv (the same two launches);
//   - _flash_bwd_dkv_kernel (+ _bwd_dkv_core; entry flash_bwd_dkv): dk, dv
//     of one k/v chunk on (b, h, t, d) from the GLOBAL lse and delta
//     (amt_flash_bwd_dkv);
//   - _flash_bwd_dq_kernel (+ _bwd_dq_core; entry flash_bwd_dq): dq against
//     one k/v chunk from the same lse and delta (amt_flash_bwd_dq).
// The ring backward calls the last two once per ring step. Inputs: q, k, v
// and the output cotangent dout, the forward's natural-log lse and
// delta = rowsum(o * dout) in fp32; every operand is addressed through
// element strides (batch, head, row) with a contiguous last dimension.
// P is recomputed as exp(S - lse), dS = P (dP - delta), and dK, dQ carry the
// softmax scale. The causal mask is bottom-right aligned, as in the forward.
// Head width d is a template parameter: 32 or 64.
//
// Bound on the H100: operations. For the same result the least work is the
// TPU fused kernel's five products, 10*b*h*tq*tk*d flops (causal: the
// visible pairs). This split recomputes S and dP in both halves: dkv does
// four products (8*b*h*tq*tk*d) and dq three (6*b*h*tq*tk*d), 14 in all.
// At the recon shape (b 8, h 8, t 1024, d 64) the pair is 60 GFLOP,
// 61 us at the bf16 tensor-core peak (43 us for the fused 10); at the
// long-context shape (b 1, h 8, t 16384, causal) 963 GFLOP, 0.97 ms. In
// fp32 (CUDA cores, 67 TFLOP/s) the recon shape's pair takes 0.90 ms.
//
// The TPU kernel adds dq over the k-block grid axis into one resident fp32
// output; that works only because a TPU grid runs in order. Here blocks run
// in parallel, so the backward is two kernels, deterministic (no atomics,
// every sum in one fixed order that does not depend on the strides, so the
// layouts give the same bits):
//   - dkv: a block owns 64 keys of one (batch, head) and walks the q tiles
//     (from the first one its keys are visible to, under the causal mask),
//     accumulating dK and dV in registers;
//   - dq:  a block owns 64 query rows and walks the k/v tiles (up to its
//     last visible one), recomputing P and dP and accumulating dQ.
// Neither holds more than its own tile and a ring of the other side, so
// memory is O(t).
//
// bf16 design (flash_bwd_dkv_bf16_kernel, flash_bwd_dq_bf16_kernel), built
// from hopper.cuh as the forward is:
//   - a block is one warpgroup (128 threads; dkv two blocks an SM, so ptxas
//     may give a thread up to 255 registers, which its accumulators dK, dV,
//     S^T and dP^T, 128 fp32 a thread at d 64, need; dq four, its 2-stage
//     ring within a quarter of the SM's shared memory); its thread 0 is
//     also the producer: it issues every TMA load;
//   - q, k, v and dout are read through rank-4 tensor maps (d, t, h, b)
//     whose byte strides come from the views (the host plan, BwdPlan in
//     ops/flash_attention.py), in tiles of 64 rows, swizzled one tile row
//     (128 bytes at d 64, 64 at d 32); TMA zero-fills rows past t;
//   - dkv: k and v are loaded once; q and dout tiles stream through a ring
//     of 3 stages completed on mbarriers, refilled by thread 0 as soon as
//     the warpgroup has released a stage. Per q tile:
//     S^T = K Q'^T (SS wgmma m64n64k16), where Q' = q * scale*log2(e)
//     rounded to bf16 (the forward's S operand, so P is normalised against
//     the forward's own lse) is a copy of the stage's q tile written by the
//     warpgroup in shared memory (then fence.proxy.async); P^T =
//     exp2(S^T - lse*log2(e)) is rounded to bf16 straight into the A
//     registers of dV += P^T dO (RS wgmma, dO the MN-major B operand through
//     the transpose bit); dP^T = V dO^T (SS); dS^T = P^T (dP^T - delta),
//     rounded into the A registers of dK += dS^T Q (q unscaled, MN-major B).
//     S^T and dP^T are issued together, P^T is formed while dP^T runs and
//     dS^T while dV's product runs; the next tile's Q' and its lse / delta
//     rows (plain loads: their row stride may be h) are prepared while dK's
//     product runs;
//   - dq: q (scaled in place once) and dout are loaded once; k and v tiles
//     stream through a ring of 2 stages. Per k tile: S = Q' K^T and
//     dP = dO V^T (SS, issued together), P = exp2(S - lse*log2(e)) while dP
//     runs, dS = P (dP - delta) rounded into the A registers of dQ += dS K
//     (RS, k MN-major);
//   - the mask runs only on tiles that cross the bottom-right diagonal (and,
//     in dq, the ragged last k tile); fully hidden tiles are never loaded.
//     Query rows past tq read lse = +inf, so their P is exactly 0 without a
//     mask; keys past tk are never stored (dkv) or masked (dq);
//   - causal dq blocks run heaviest first (the plan reverses the grid's y
//     index); dkv's natural order already is (the first keys see the most
//     rows);
//   - async A registers (P^T, dS^T, dS) are fenced after wgmma_wait.
//
// fp32 design (flash_bwd_dkv_f32_kernel, flash_bwd_dq_f32_kernel; wgmma has
// no fp32 operands and TF32 would break the 1e-5 gate): a small SIMT GEMM.
// 128 threads own 64 keys (dkv) or 64 query rows (dq); the other side
// streams in chunks of 32 rows, double-buffered with 16-byte cp.async into
// padded rows (conflict-free float4 reads). Each thread computes a 4 x 4
// micro-tile of S^T and dP^T (or S and dP), exact expf, writes P^T / dS^T
// (or dS) to shared memory, then accumulates a 4 x d/8 slice of dK and dV
// (or dQ) in registers, reading both operands as float4 (the helpers are
// csrc/flash_f32.cuh's, shared with the fp32 forward). Only the order of
// the sums differs from the plain version.
//
// Measured (one H100, in turns in one call, same bits; bench_flash_bwd.py
// variants): dq with 2 stages and four blocks an SM against 3 stages and
// three: 16 % faster at the recon shape, 36 % at t 4096, 13 % at t 16384
// causal, 4 % slower at t 4096 causal. dkv with 2 stages and three blocks
// (166 registers, spilling) against 3 stages and two: 4-7 % faster at h 12
// and t 16384 causal, 24-35 % slower at t 4096 (512 blocks fill 1.3 waves
// of 396 slots, against 1.9 of 264), so dkv keeps 3 stages and two
// blocks. Issuing S and dP together and forming P while dP runs (dkv: dS
// while dV runs), against one product at a time: 0.9-3.6 % faster but for
// dq at t 4096 (0.8 % slower).
#include "common.cuh"
#include "flash_f32.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kLog2e = 1.4426950408889634f;

// The bf16 kernels' shape (ops/flash_attention.py mirrors these numbers in
// BWD_ROWS, BWD_DKV_STAGES, BWD_DQ_STAGES and BWD_THREADS). dkv runs two
// blocks an SM (its registers and shared memory), dq four (a 2-stage ring
// keeps its shared memory within a quarter of the SM's): see the
// measurements at the top.
constexpr int kBwdRows = 64;      // own rows of a block, rows of a tile
constexpr int kDkvStages = 3;     // depth of dkv's q / dout ring
constexpr int kDqStages = 2;      // depth of dq's k / v ring
constexpr int kBwdThreads = 128;  // one warpgroup

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
  int heaviest_first;  // dq: run the q tiles in descending order
};

template <typename T>
__device__ __forceinline__ const T* head_of(const void* p, Strides3 s, int bi,
                                            int hi) {
  return static_cast<const T*>(p) + bi * s.b + hi * s.h;
}
template <typename T>
__device__ __forceinline__ T* head_of(void* p, Strides3 s, int bi, int hi) {
  return static_cast<T*>(p) + bi * s.b + hi * s.h;
}

// -- bf16: wgmma ----------------------------------------------------------------

// 2^x on the SFU, denormal results flushed to zero (as the forward).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A tile of 64 rows times s, rounded to bf16, from src into dst (which may
// be src): elementwise, so the swizzle does not matter; then visible to
// wgmma. Every thread of the warpgroup takes part.
template <int D>
__device__ __forceinline__ void scale_tile(bf16* dst, const bf16* src,
                                           float s) {
  const uint4* in = reinterpret_cast<const uint4*>(src);
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int it = 0; it < kBwdRows * D / 8 / kBwdThreads; ++it) {
    const int idx = it * kBwdThreads + threadIdx.x;
    uint4 x = in[idx];
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
      w[e] = pack_bf16x2(f.x * s, f.y * s);
    }
    out[idx] = x;
  }
  hopper::fence_proxy_async();
}

// acc(64 x 64) = A(64 x D) B(64 x D)^T, both K-major tiles of D-wide rows in
// shared memory (SS); issued and committed, not waited.
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], const bf16* a,
                                          const bf16* b) {
  using namespace hopper;
  const uint64_t da = wgmma_desc<D * 2>(a, 8 * D * 2, 8 * D * 2);
  const uint64_t db = wgmma_desc<D * 2>(b, 8 * D * 2, 8 * D * 2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64k16(acc, desc_advance(da, kk * 32),
                       desc_advance(db, kk * 32), kk > 0);
  wgmma_commit();
}

// o(64 x D) += A(64 x 64, registers) B(64 x D), B an MN-major tile read
// through the transpose bit (RS); issued and committed, not waited.
template <int D>
__device__ __forceinline__ void issue_ab(float (&o)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         const bf16* b) {
  using namespace hopper;
  const uint64_t desc = wgmma_desc<D * 2>(b, 8 * D * 2, 8 * D * 2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_advance(desc, kk * 16 * D * 2);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16<1>(o, a[kk], db, 1);
    else
      wgmma_rs_m64n32k16<1>(o, a[kk], db, 1);
  }
  wgmma_commit();
}

// A 64 x 64 accumulator rounded to bf16 into the A registers of a product
// that takes it as its left operand (hopper.cuh's layout note).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Shared memory of the bf16 kernels; every tile starts on a 1024-byte
// boundary (the swizzle atom), the base is aligned by hand.
template <int D>
struct DkvTiles {
  bf16 k[kBwdRows * D];
  bf16 v[kBwdRows * D];
  bf16 q[kDkvStages][kBwdRows * D];
  bf16 qs[kDkvStages][kBwdRows * D];  // q * scale*log2(e), rounded
  bf16 dout[kDkvStages][kBwdRows * D];
  float lse[2][kBwdRows];    // lse * log2(e); +inf past tq
  float delta[2][kBwdRows];  // 0 past tq
  uint64_t kv_full, full[kDkvStages];
};

template <int D>
struct DqTiles {
  bf16 q[kBwdRows * D];  // scaled in place
  bf16 dout[kBwdRows * D];
  bf16 k[kDqStages][kBwdRows * D];
  bf16 v[kDqStages][kBwdRows * D];
  uint64_t own_full, k_full[kDqStages], v_full[kDqStages];
};

template <typename T>
__device__ __forceinline__ T& aligned_tiles(uint8_t* raw) {
  return *reinterpret_cast<T*>(
      raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u));
}

// dkv: the statistic thread tid stages for the q tile at row q0: lse (in
// log2, +inf past tq) for tid < 64, delta (0 past tq) above.
__device__ __forceinline__ float row_stat(const BwdArgs& a, const float* lb,
                                          const float* db, int q0) {
  const int row = q0 + threadIdx.x % kBwdRows;
  if (threadIdx.x < kBwdRows)
    return row < a.tq ? lb[row * a.sl.r] * kLog2e : INFINITY;
  return row < a.tq ? db[row * a.sdl.r] : 0.f;
}

template <int D>
__global__ __launch_bounds__(kBwdThreads, 2) void flash_bwd_dkv_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap dmap, BwdArgs a) {
  using namespace hopper;
  constexpr uint32_t kTile = kBwdRows * D * 2;
  extern __shared__ uint8_t smem_raw[];
  DkvTiles<D>& sm = aligned_tiles<DkvTiles<D>>(smem_raw);

  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int k0 = blockIdx.y * kBwdRows;
  const int tq = a.tq, off = a.tk - tq;
  // q tiles [j0, nq): every earlier tile is hidden from these keys; tiles
  // from jfull on see all of them (no mask)
  const int j0 = a.causal ? max(k0 - off, 0) / kBwdRows : 0;
  const int n = (tq + kBwdRows - 1) / kBwdRows - j0;
  const int jfull =
      a.causal ? max(j0, (k0 + 2 * kBwdRows - 2 - off) / kBwdRows) : j0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const float scale_log2 = a.scale * kLog2e;
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* db = a.delta + bi * a.sdl.b + hi * a.sdl.h;

  auto load = [&](int st, int j) {  // thread 0: q tile j into stage st
    mbar_expect_tx(&sm.full[st], 2 * kTile);
    tma_load_4d(sm.q[st], &qmap, &sm.full[st], 0, j * kBwdRows, hi, bi);
    tma_load_4d(sm.dout[st], &dmap, &sm.full[st], 0, j * kBwdRows, hi, bi);
  };
  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int st = 0; st < kDkvStages; ++st) mbar_init(&sm.full[st], 1);
    fence_barrier_init();
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
    prefetch_tensor_map(&dmap);
    mbar_expect_tx(&sm.kv_full, 2 * kTile);
    tma_load_4d(sm.k, &kmap, &sm.kv_full, 0, k0, hi, bi);
    tma_load_4d(sm.v, &vmap, &sm.kv_full, 0, k0, hi, bi);
    for (int st = 0; st < kDkvStages && st < n; ++st) load(st, j0 + st);
  }
  __syncthreads();

  // the first tile's statistics and Q'
  float stat = row_stat(a, lb, db, j0 * kBwdRows);
  (tid < kBwdRows ? sm.lse[0] : sm.delta[0])[tid % kBwdRows] = stat;
  mbar_wait(&sm.full[0], 0);
  scale_tile<D>(sm.qs[0], sm.q[0], scale_log2);
  mbar_wait(&sm.kv_full, 0);
  __syncthreads();

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], da[4][4];
  const int key0 = k0 + 16 * warp + g;  // this thread's rows of S^T: key0, +8
  for (int i = 0; i < n; ++i) {
    const int st = i % kDkvStages, buf = i & 1;
    const int j = j0 + i, q0 = j * kBwdRows;
    if (i + 1 < n) stat = row_stat(a, lb, db, q0 + kBwdRows);  // stored below

    // S^T = K Q'^T and dP^T = V dO^T; P^T = exp2(S^T - lse) in place while
    // dP^T runs
    issue_abt<D>(s, sm.k, sm.qs[st]);
    issue_abt<D>(dp, sm.v, sm.dout[st]);
    wgmma_wait<1>();
    fence_regs(s);
    const float* ls = sm.lse[buf];
    const float* ds = sm.delta[buf];
    const bool masked = j < jfull;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * ii + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_ftz(s[4 * ii + e] - ((e & 1) ? l.y : l.x));
        const int col = q0 + 8 * ii + 2 * t + (e & 1);
        s[4 * ii + e] =
            masked && key0 + 8 * (e >> 1) > col + off ? 0.f : p;
      }
    }
    pack_a(pa, s);

    // dV += P^T dO; while it runs, dS^T = P^T (dP^T - delta), then
    // dK += dS^T Q
    issue_ab<D>(dv, pa, sm.dout[st]);
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float2 dl = *reinterpret_cast<const float2*>(ds + 8 * ii + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[4 * ii + e] =
            s[4 * ii + e] * (dp[4 * ii + e] - ((e & 1) ? dl.y : dl.x));
    }
    pack_a(da, dp);
    issue_ab<D>(dk, da, sm.q[st]);

    // while dK's product runs: the next tile's statistics and Q'
    if (i + 1 < n) {
      (tid < kBwdRows ? sm.lse[buf ^ 1] : sm.delta[buf ^ 1])[tid % kBwdRows] =
          stat;
      const int nst = (i + 1) % kDkvStages;
      mbar_wait(&sm.full[nst], ((i + 1) / kDkvStages) & 1);
      scale_tile<D>(sm.qs[nst], sm.q[nst], scale_log2);
    }
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();  // stage st released; the next tile's writes visible
    if (tid == 0 && i + kDkvStages < n) load(st, j + kDkvStages);
    __syncwarp();
  }

  bf16* dkb = head_of<bf16>(a.dk, a.sdk, bi, hi);
  bf16* dvb = head_of<bf16>(a.dv, a.sdv, bi, hi);
#pragma unroll
  for (int ii = 0; ii < D / 8; ++ii) {
    const int col = 8 * ii + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key < a.tk) {
        *reinterpret_cast<uint32_t*>(dkb + key * a.sdk.r + col) =
            pack_bf16x2(dk[4 * ii + 2 * half] * a.scale,
                        dk[4 * ii + 2 * half + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvb + key * a.sdv.r + col) =
            pack_bf16x2(dv[4 * ii + 2 * half], dv[4 * ii + 2 * half + 1]);
      }
    }
  }
}

template <int D>
__global__ __launch_bounds__(kBwdThreads, 4) void flash_bwd_dq_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap dmap, BwdArgs a) {
  using namespace hopper;
  constexpr uint32_t kTile = kBwdRows * D * 2;
  extern __shared__ uint8_t smem_raw[];
  DqTiles<D>& sm = aligned_tiles<DqTiles<D>>(smem_raw);

  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int qt = a.heaviest_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBwdRows;
  const int tq = a.tq, tk = a.tk, off = tk - tq;
  // k tiles [0, n): later ones are hidden from every row; tiles [0, nfull)
  // hide no key from any row and hold no key past tk (no mask)
  const int kend = a.causal ? min(tk, q0 + kBwdRows + off) : tk;
  const int n = (kend + kBwdRows - 1) / kBwdRows;
  const int nfull =
      min(n, (a.causal ? min(tk, q0 + off + 1) : tk) / kBwdRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;

  auto load = [&](int st, int j) {  // thread 0: k/v tile j into stage st
    mbar_expect_tx(&sm.k_full[st], kTile);
    tma_load_4d(sm.k[st], &kmap, &sm.k_full[st], 0, j * kBwdRows, hi, bi);
    mbar_expect_tx(&sm.v_full[st], kTile);
    tma_load_4d(sm.v[st], &vmap, &sm.v_full[st], 0, j * kBwdRows, hi, bi);
  };
  if (tid == 0) {
    mbar_init(&sm.own_full, 1);
#pragma unroll
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
    }
    fence_barrier_init();
    prefetch_tensor_map(&qmap);
    prefetch_tensor_map(&kmap);
    prefetch_tensor_map(&vmap);
    prefetch_tensor_map(&dmap);
    mbar_expect_tx(&sm.own_full, 2 * kTile);
    tma_load_4d(sm.q, &qmap, &sm.own_full, 0, q0, hi, bi);
    tma_load_4d(sm.dout, &dmap, &sm.own_full, 0, q0, hi, bi);
    for (int st = 0; st < kDqStages && st < n; ++st) load(st, st);
  }
  __syncthreads();

  // this thread's rows r0 and r1 = r0 + 8: lse in log2 (+inf past tq, so P
  // is 0 there) and delta
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* db = a.delta + bi * a.sdl.b + hi * a.sdl.h;
  const float lse0 = r0 < tq ? lb[r0 * a.sl.r] * kLog2e : INFINITY;
  const float lse1 = r1 < tq ? lb[r1 * a.sl.r] * kLog2e : INFINITY;
  const float dl0 = r0 < tq ? db[r0 * a.sdl.r] : 0.f;
  const float dl1 = r1 < tq ? db[r1 * a.sdl.r] : 0.f;
  mbar_wait(&sm.own_full, 0);
  scale_tile<D>(sm.q, sm.q, a.scale * kLog2e);
  __syncthreads();

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t da[4][4];
  for (int j = 0; j < n; ++j) {
    const int st = j % kDqStages;
    const uint32_t parity = (j / kDqStages) & 1;
    // S = Q' K^T and dP = dO V^T; P = exp2(S - lse) in place while dP
    // runs, masked on crossing tiles; then dS = P (dP - delta)
    mbar_wait(&sm.k_full[st], parity);
    issue_abt<D>(s, sm.q, sm.k[st]);
    mbar_wait(&sm.v_full[st], parity);
    issue_abt<D>(dp, sm.dout, sm.v[st]);
    wgmma_wait<1>();
    fence_regs(s);
    const bool masked = j >= nfull;
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * ii + e;
        float p = exp2_ftz(s[x] - (e < 2 ? lse0 : lse1));
        if (masked) {
          const int col = j * kBwdRows + 8 * ii + 2 * t + (e & 1);
          if (col >= tk || (a.causal && col > (e < 2 ? r0 : r1) + off))
            p = 0.f;
        }
        s[x] = p;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x)
      dp[x] = s[x] * (dp[x] - ((x & 2) ? dl1 : dl0));
    pack_a(da, dp);

    // dQ += dS K
    issue_ab<D>(dq, da, sm.k[st]);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(da);
    __syncthreads();  // stage st released
    if (tid == 0 && j + kDqStages < n) load(st, j + kDqStages);
    __syncwarp();
  }

  bf16* dqb = head_of<bf16>(a.dq, a.sdq, bi, hi);
#pragma unroll
  for (int ii = 0; ii < D / 8; ++ii) {
    const int col = 8 * ii + 2 * t;
    if (r0 < tq)
      *reinterpret_cast<uint32_t*>(dqb + r0 * a.sdq.r + col) =
          pack_bf16x2(dq[4 * ii] * a.scale, dq[4 * ii + 1] * a.scale);
    if (r1 < tq)
      *reinterpret_cast<uint32_t*>(dqb + r1 * a.sdq.r + col) =
          pack_bf16x2(dq[4 * ii + 2] * a.scale, dq[4 * ii + 3] * a.scale);
  }
}

// -- fp32: register-tiled FMA ----------------------------------------------------

template <int D>
struct DkvF32 {
  float k[kF32Own][D + 4];
  float v[kF32Own][D + 4];
  float q[2][kF32Chunk][D + 4];
  float dout[2][kF32Chunk][D + 4];
  float p[kF32Chunk][kF32Own + 4];   // P^T, stored [query row][key]
  float ds[kF32Chunk][kF32Own + 4];  // dS^T, the same
  float lse[2][kF32Chunk];           // +inf past tq
  float delta[2][kF32Chunk];
};

template <int D>
struct DqF32 {
  float q[kF32Own][D + 4];
  float dout[kF32Own][D + 4];
  float k[2][kF32Chunk][D + 4];
  float v[2][kF32Chunk][D + 4];
  float ds[kF32Chunk][kF32Own + 4];  // dS, stored [key][query row]
};

template <int D>
__global__ __launch_bounds__(kF32Threads, 2) void flash_bwd_dkv_f32_kernel(
    BwdArgs a) {
  extern __shared__ float4 smem_f32[];
  DkvF32<D>& sm = *reinterpret_cast<DkvF32<D>*>(smem_f32);
  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int k0 = blockIdx.y * kF32Own;
  const int tq = a.tq, tk = a.tk, off = tk - tq;
  const int tid = threadIdx.x;
  const int c0 = (a.causal ? max(k0 - off, 0) : 0) / kF32Chunk * kF32Chunk;
  const int n = (tq - c0 + kF32Chunk - 1) / kF32Chunk;
  const float* qb = head_of<float>(a.q, a.sq, bi, hi);
  const float* dob = head_of<float>(a.dout, a.sdo, bi, hi);
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* deb = a.delta + bi * a.sdl.b + hi * a.sdl.h;

  auto load_chunk = [&](int buf, int r0) {
    load_rows_f32<D>(&sm.q[buf][0][0], qb, a.sq.r, r0, kF32Chunk, tq);
    load_rows_f32<D>(&sm.dout[buf][0][0], dob, a.sdo.r, r0, kF32Chunk, tq);
    if (tid < 2 * kF32Chunk) {
      const int r = tid % kF32Chunk, row = r0 + r;
      const bool is_lse = tid < kF32Chunk;
      float* dst = is_lse ? &sm.lse[buf][r] : &sm.delta[buf][r];
      if (row < tq)
        cp_async4(dst, is_lse ? lb + row * a.sl.r : deb + row * a.sdl.r);
      else
        *dst = is_lse ? INFINITY : 0.f;
    }
  };
  load_rows_f32<D>(&sm.k[0][0], head_of<float>(a.k, a.sk, bi, hi), a.sk.r,
                   k0, kF32Own, tk);
  load_rows_f32<D>(&sm.v[0][0], head_of<float>(a.v, a.sv, bi, hi), a.sv.r,
                   k0, kF32Own, tk);
  load_chunk(0, c0);
  cp_async_commit();

  float dk[4][D / 8], dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dk[i][c] = dv[i][c] = 0.f;
  const int key = k0 + 4 * (tid / 8);  // this thread's keys: key .. key + 3
  for (int c = 0; c < n; ++c) {
    const int buf = c & 1, r0 = c0 + c * kF32Chunk;
    if (c + 1 < n) {
      load_chunk(buf ^ 1, r0 + kF32Chunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T and dP^T, then P^T = exp(S^T scale - lse) and dS^T
    float s[4][4], dp[4][4];
    micro_abt<D>(s, dp, &sm.k[0][0], &sm.v[0][0], &sm.q[buf][0][0],
                 &sm.dout[buf][0][0]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tid % 8 + 8 * j, row = r0 + rl;
      const float lse = sm.lse[buf][rl], dl = sm.delta[buf][rl];
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hidden = a.causal && key + i > row + off;
        p[i] = hidden ? 0.f : expf(s[i][j] * a.scale - lse);
        ds[i] = p[i] * (dp[i][j] - dl);
      }
      *reinterpret_cast<float4*>(&sm.p[rl][4 * (tid / 8)]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&sm.ds[rl][4 * (tid / 8)]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q
    micro_atb<D>(dv, &sm.p[0][0], &sm.dout[buf][0][0]);
    micro_atb<D>(dk, &sm.ds[0][0], &sm.q[buf][0][0]);
    __syncthreads();
  }
  store_slice<D>(head_of<float>(a.dk, a.sdk, bi, hi), a.sdk.r, k0, tk, dk,
                 a.scale);
  store_slice<D>(head_of<float>(a.dv, a.sdv, bi, hi), a.sdv.r, k0, tk, dv,
                 1.f);
}

template <int D>
__global__ __launch_bounds__(kF32Threads, 2) void flash_bwd_dq_f32_kernel(
    BwdArgs a) {
  extern __shared__ float4 smem_f32[];
  DqF32<D>& sm = *reinterpret_cast<DqF32<D>*>(smem_f32);
  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int qt = a.heaviest_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kF32Own;
  const int tq = a.tq, tk = a.tk, off = tk - tq;
  const int tid = threadIdx.x;
  const int kend = a.causal ? min(tk, q0 + kF32Own + off) : tk;
  const int n = (kend + kF32Chunk - 1) / kF32Chunk;
  const float* kb = head_of<float>(a.k, a.sk, bi, hi);
  const float* vb = head_of<float>(a.v, a.sv, bi, hi);

  auto load_chunk = [&](int buf, int r0) {
    load_rows_f32<D>(&sm.k[buf][0][0], kb, a.sk.r, r0, kF32Chunk, tk);
    load_rows_f32<D>(&sm.v[buf][0][0], vb, a.sv.r, r0, kF32Chunk, tk);
  };
  load_rows_f32<D>(&sm.q[0][0], head_of<float>(a.q, a.sq, bi, hi), a.sq.r,
                   q0, kF32Own, tq);
  load_rows_f32<D>(&sm.dout[0][0], head_of<float>(a.dout, a.sdo, bi, hi),
                   a.sdo.r, q0, kF32Own, tq);
  load_chunk(0, 0);
  cp_async_commit();

  // this thread's rows row .. row + 3: lse (+inf past tq) and delta
  const int row = q0 + 4 * (tid / 8);
  const float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
  const float* deb = a.delta + bi * a.sdl.b + hi * a.sdl.h;
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = row + i < tq;
    lse[i] = ok ? lb[(row + i) * a.sl.r] : INFINITY;
    dl[i] = ok ? deb[(row + i) * a.sdl.r] : 0.f;
  }

  float dq[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) dq[i][c] = 0.f;
  for (int c = 0; c < n; ++c) {
    const int buf = c & 1, k0 = c * kF32Chunk;
    if (c + 1 < n) {
      load_chunk(buf ^ 1, k0 + kF32Chunk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S and dP, then P = exp(S scale - lse) (masked: keys past tk or hidden)
    // and dS
    float s[4][4], dp[4][4];
    micro_abt<D>(s, dp, &sm.q[0][0], &sm.dout[0][0], &sm.k[buf][0][0],
                 &sm.v[buf][0][0]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = tid % 8 + 8 * j, key = k0 + kl;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool hidden = key >= tk || (a.causal && key > row + i + off);
        const float p = hidden ? 0.f : expf(s[i][j] * a.scale - lse[i]);
        ds[i] = p * (dp[i][j] - dl[i]);
      }
      *reinterpret_cast<float4*>(&sm.ds[kl][4 * (tid / 8)]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K
    micro_atb<D>(dq, &sm.ds[0][0], &sm.k[buf][0][0]);
    __syncthreads();
  }
  store_slice<D>(head_of<float>(a.dq, a.sdq, bi, hi), a.sdq.r, q0, tq, dq,
                 a.scale);
}

// -- launches -------------------------------------------------------------------

// The dynamic shared-memory attribute of `kernel`, raised once per size.
template <typename K>
cudaError_t allow_smem(K kernel, int64_t smem, int64_t& set) {
  if (smem <= set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

// The bf16 kernels from a host plan (ops/flash_attention.py's BwdPlan, 45
// int64 values): for q, k, v and dout in turn their map's dims
// (d, t, h, b), byte strides (t, h, b) and box (d, rows); then the swizzle
// bytes, the dkv grid (b*h, k tiles), the dq grid (b*h, q tiles), the
// threads, the dkv and dq dynamic shared-memory bytes and whether the dq
// tiles run heaviest first.
template <int D>
bool encode_maps(CUtensorMap (&maps)[4], const BwdArgs& a,
                 const int64_t* plan) {
  const void* bases[4] = {a.q, a.k, a.v, a.dout};
  if (plan[36] != 2 * D || plan[41] != kBwdThreads) return false;
  for (int i = 0; i < 4; ++i) {
    const int64_t* p = plan + 9 * i;
    if (p[7] != D || p[8] != kBwdRows ||
        !hopper::encode_bf16_map_4d(&maps[i], bases[i], p, p + 4, D,
                                    kBwdRows, (int)plan[36]))
      return false;
  }
  return true;
}

template <int D>
cudaError_t launch_dkv_bf16(const BwdArgs& a, const int64_t* plan,
                            cudaStream_t s) {
  const int64_t smem = plan[42];
  CUtensorMap maps[4];
  if (smem < (int64_t)sizeof(DkvTiles<D>) + 1024 || smem > 232448 ||
      !encode_maps<D>(maps, a, plan))
    return cudaErrorInvalidValue;
  static int64_t smem_set = 0;
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)plan[37], (unsigned)plan[38]);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kBwdThreads, (size_t)smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(BwdArgs a, const int64_t* plan, cudaStream_t s) {
  const int64_t smem = plan[43];
  CUtensorMap maps[4];
  if (smem < (int64_t)sizeof(DqTiles<D>) + 1024 || smem > 232448 ||
      !encode_maps<D>(maps, a, plan))
    return cudaErrorInvalidValue;
  static int64_t smem_set = 0;
  const cudaError_t err =
      allow_smem(flash_bwd_dq_bf16_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)plan[39], (unsigned)plan[40]);
  a.heaviest_first = (int)plan[44];
  flash_bwd_dq_bf16_kernel<D><<<grid, kBwdThreads, (size_t)smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_f32(const BwdArgs& a, int b, cudaStream_t s) {
  static int64_t smem_set = 0;
  const int64_t smem = sizeof(DkvF32<D>);
  const cudaError_t err =
      allow_smem(flash_bwd_dkv_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * a.h, (a.tk + kF32Own - 1) / kF32Own);
  flash_bwd_dkv_f32_kernel<D><<<grid, kF32Threads, (size_t)smem, s>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(BwdArgs a, int b, cudaStream_t s) {
  static int64_t smem_set = 0;
  const int64_t smem = sizeof(DqF32<D>);
  const cudaError_t err =
      allow_smem(flash_bwd_dq_f32_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(b * a.h, (a.tq + kF32Own - 1) / kF32Own);
  a.heaviest_first = a.causal;
  flash_bwd_dq_f32_kernel<D><<<grid, kF32Threads, (size_t)smem, s>>>(a);
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
                 h, tq, tk, scale, causal, 0};
}

bool bad_shape(int b, int h, int tq, int tk) {
  return b < 0 || h <= 0 || tq <= 0 || tk <= 0 || (int64_t)b * h > 65535;
}

}  // namespace

// strides holds (batch, head, row) element strides of q, k, v, dout, lse,
// delta, dq, dk and dv, in that order (27 values; an absent output's are
// not read); plan is the bf16 kernels' host plan (45 values; unused,
// and may be null, in fp32).
AMT_EXPORT int amt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const int64_t* strides, const int64_t* plan,
                                 int b, int h, int tq, int tk, int d,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  if (bad_shape(b, h, tq, tk)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv,
                              strides, h, tq, tk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AMT_BF16) {
    if (plan == nullptr) return cudaErrorInvalidValue;
    if (d == 64) return launch_dkv_bf16<64>(a, plan, s);
    if (d == 32) return launch_dkv_bf16<32>(a, plan, s);
  } else if (dtype == AMT_F32) {
    if (d == 64) return launch_dkv_f32<64>(a, b, s);
    if (d == 32) return launch_dkv_f32<32>(a, b, s);
  }
  return cudaErrorInvalidValue;
}

AMT_EXPORT int amt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const int64_t* strides, const int64_t* plan,
                                int b, int h, int tq, int tk, int d,
                                float scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(b, h, tq, tk)) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const BwdArgs a = make_args(q, k, v, dout, lse, delta, dq, nullptr,
                              nullptr, strides, h, tq, tk, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AMT_BF16) {
    if (plan == nullptr) return cudaErrorInvalidValue;
    if (d == 64) return launch_dq_bf16<64>(a, plan, s);
    if (d == 32) return launch_dq_bf16<32>(a, plan, s);
  } else if (dtype == AMT_F32) {
    if (d == 64) return launch_dq_f32<64>(a, b, s);
    if (d == 32) return launch_dq_f32<32>(a, b, s);
  }
  return cudaErrorInvalidValue;
}

// Packed kv (kernel 5's layout): q, dout and dq (b, tq, h, d), kv and dkv
// (b, tk, 2, h, d), lse and delta (b, tq, h), all contiguous. Launches the
// dkv kernel, then the dq kernel; plan (bf16) holds the maps of q, the
// views kv[:, :, 0] and kv[:, :, 1], and dout.
AMT_EXPORT int amt_flash_bwd_kv(const void* q, const void* kv,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, void* dkv,
                                const int64_t* plan, int b, int tq, int tk,
                                int h, int d, float scale, int causal,
                                int dtype, void* stream) {
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
                                    plan, b, h, tq, tk, d, scale, causal,
                                    dtype, stream);
  if (err != cudaSuccess) return err;
  return amt_flash_bwd_dq(q, kv, v, dout, lse, delta, dq, st, plan, b, h, tq,
                          tk, d, scale, causal, dtype, stream);
}
