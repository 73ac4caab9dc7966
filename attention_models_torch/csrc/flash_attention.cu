// Flash attention forward, one kernel for every layout.
//
// Replaces three TPU kernels of attention_models_tpu/ops/flash_attention.py,
// which compute the same arithmetic on different layouts:
//   - _flash_kernel_mh_kv (+ _fwd_core; entry _flash_forward_bthd_kv):
//     q (b, tq, h, d) over the packed kv projection (b, tk, 2, h, d), the
//     kv.0 output viewed in place, so k and v are never split into copies;
//   - _flash_kernel_mh (entry _flash_forward_bthd): q, k, v (b, t, h, d);
//   - _flash_kernel (entry _flash_forward): q, k, v (b, h, t, d), the
//     long-context and ring-attention building block.
// Outputs: out in q's dtype and the natural-log logsumexp lse in fp32, which
// the backward needs, through (batch, head, row) element strides. The
// optional causal mask is bottom-right aligned: query row r sees keys
// c <= r + (tk - tq); the Python wrapper rejects tq > tk. Head width d is a
// template parameter: 32 or 64.
//
// Bound on the H100: operations. The two products are 4*b*h*tq*tk*d flops
// (causal: only the visible pairs) against q, k, v and out read or written
// once: at the recon shape (b 8, h 8, t 1024, d 64) 17.2 GFLOP against
// 50 MB, about 17 us at the bf16 tensor-core peak; at the long-context
// shape (b 1, h 8, t 16384, causal) 275 GFLOP, 0.28 ms.
//
// bf16 design (flash_fwd_bf16_kernel), built from hopper.cuh:
//   - a block takes 128 query rows of one (batch, head): a producer
//     warpgroup, of which one thread issues TMA loads, and two consumer
//     warpgroups of 64 rows each; setmaxnreg gives the producer 40
//     registers and the consumers 232 at run time (ptxas still allots each
//     thread the launch's 168);
//   - q, k and v are read through rank-4 tensor maps (d, t, h, b) whose byte
//     strides come from the views, so the three layouts (and packed kv's k
//     and v views) are three sets of maps to one kernel; TMA zero-fills rows
//     past t, so a ragged length needs no padded copy. Tiles are swizzled
//     128 bytes at d 64 and 64 bytes at d 32 (one row of the tile);
//   - k and v tiles of 128 keys stream through a ring of kFwdStages stages
//     in shared memory with full (TMA bytes) and empty (eight consumer
//     warps) mbarriers; k and v have separate full barriers, so S starts
//     before v has landed;
//   - S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//     memory (SS): each consumer scales its 64 q rows of the TMA tile by
//     scale*log2(e) in fp32 and rounds them to bf16 in place once (the
//     rounding point of the plain versions and of the backward). Q in
//     shared memory, not registers, keeps a consumer thread within those
//     168 registers, with no spill and no serialised wgmma;
//   - the online softmax runs in exp2 with fp32 m and l on the S
//     accumulators; P is rounded to bf16 and packed straight into the A
//     registers of O += P V (wgmma m64nDk16, RS): the m64nN accumulator
//     layout is the A-register layout. v is the MN-major B operand, read
//     through wgmma's transpose bit, never transposed in memory;
//   - a warpgroup takes one tile at a time (S, softmax, P V); the two
//     warpgroups' products and softmaxes interleave on the SM;
//   - the mask runs only where it can hide a key: a warpgroup's tiles below
//     its first row's diagonal are computed unmasked, the diagonal tiles
//     and the ragged last tile masked, and tiles past its last row's
//     diagonal are skipped (still released to the producer);
//   - causal q tiles launch heaviest first (the plan reverses the grid's y
//     index; b*h rides x, so every head's heaviest tile is in the first
//     wave);
//   - the epilogue divides O by l, writes it through the warpgroup's half
//     of the q tile (swizzled, no bank conflicts) and stores 16-byte rows
//     below tq; lse from one thread per row.
// No atomics, and every sum runs in one fixed order that does not depend on
// the strides, so the three layouts give the same bits. What the host
// decides (maps, grid, shared memory) comes from ops/flash_attention.py's
// FwdPlan; this file encodes the maps and launches.
//
// It replaces an Ampere-style body with these limits, each answered above:
// (1) mma.sync m16n8k16, which cannot reach Hopper's bf16 rate: now wgmma;
// (2) k fragments from 32-bit shared loads and v fragments from four 16-bit
// loads each: wgmma reads both B operands from swizzled shared memory;
// (3) cp.async copies issued by every thread, two stages: one TMA thread and
// an mbarrier ring; (4) 64-row q tiles: 128; (5) the mask on every score:
// masked tiles only; (6) ascending causal order: heaviest first; (7) q by
// scalar 16-bit global loads: one TMA tile, scaled in shared memory.
//
// Measured and left out (one H100, one call each, same bits): tile j's S in
// flight during tile j - 1's softmax and P V in one warpgroup (6-30 %
// slower within the 168 registers ptxas allots a thread), the two
// warpgroups taking turns to issue S with named barriers (0-5 % slower),
// and a third ring stage (from 2 % faster to 6 % slower by shape).
//
// fp32 design (flash_fwd_f32_kernel, the exact path the golden index check
// and the fp32 MaskGIT trainer run; wgmma has no fp32 operands and TF32
// would break the 1e-5 gate), built like the backward's dq kernel from
// csrc/flash_f32.cuh's register tiles:
//   - a block is 128 threads owning 64 query rows of one (batch, head),
//     loaded once into shared rows of D + 4 floats; k and v stream in
//     32-key chunks through a ring of kFwd32Stages stages of 16-byte
//     cp.async, rows past tk zero-filled;
//   - per chunk each thread computes a 4 x 4 micro-tile of S (rows
//     4*(tid/8) + i, keys tid%8 + 8j); a row's 32 scores lie with 8
//     adjacent lanes, whose shuffles (xor 1, 2, 4) give the chunk's max;
//     alpha = exp(m_old - m) and P = exp(S * scale - m) are exact expf in
//     the natural-log domain; each lane keeps its part of the row sum;
//   - P goes to shared memory as [key][row], then O = alpha O + P V as a
//     4 x D/8 slice a thread (the rows of its S micro-tile, so alpha is in
//     its registers);
//   - the mask runs only on the chunks that cross the block's diagonal and
//     on the ragged last chunk; chunks past its last row's diagonal are
//     never loaded; causal q tiles run heaviest first (grid (b*h, q tiles),
//     as the backward's dq);
//   - the epilogue sums the row's 8 parts of l by shuffles, writes O / l as
//     float4 through the output strides and lse = m + log l.
// Every sum runs in one fixed order that does not depend on the strides.
// It replaces a one-thread-a-row body (64 rows a block, k and v read as
// shared-memory broadcasts, ascending causal order) that ran at 15-27 % of
// the fp32 FMA peak.
#include "common.cuh"
#include "flash_f32.cuh"
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The bf16 kernel's shape (ops/flash_attention.py mirrors these numbers in
// FWD_ROWS, FWD_KEYS, FWD_STAGES and FWD_THREADS).
constexpr int kFwdRows = 128;     // query rows a block
constexpr int kFwdKeys = 128;     // keys a k or v tile
constexpr int kFwdStages = 2;     // depth of the k/v ring
constexpr int kFwdThreads = 384;  // producer + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

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
  int heaviest_first;  // run the q tiles in descending order
};

// Shared memory of the bf16 kernel; every tile starts on a 1024-byte
// boundary (the swizzle atom), the base is aligned by hand.
template <int D>
struct FwdTiles {
  __nv_bfloat16 q[kFwdRows * D];
  __nv_bfloat16 k[kFwdStages][kFwdKeys * D];
  __nv_bfloat16 v[kFwdStages][kFwdKeys * D];
  uint64_t q_full, k_full[kFwdStages], v_full[kFwdStages], empty[kFwdStages];
};

// 2^x on the SFU, denormal results flushed to zero (they are below any
// bf16 P and any fp32 row sum the softmax keeps).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one k tile (q: this warpgroup's 64 rows), issued and
// committed (not waited).
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64],
                                        const __nv_bfloat16* qs,
                                        const __nv_bfloat16* ks) {
  using namespace hopper;
  const uint64_t qdesc = wgmma_desc<D * 2>(qs, 8 * D * 2, 8 * D * 2);
  const uint64_t kdesc = wgmma_desc<D * 2>(ks, 8 * D * 2, 8 * D * 2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n128k16(s, desc_advance(qdesc, kk * 32),
                        desc_advance(kdesc, kk * 32), kk > 0);
  wgmma_commit();
}

// O += P V of one v tile, issued and committed (not waited).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[8][4],
                                         const __nv_bfloat16* vs) {
  using namespace hopper;
  const uint64_t desc = wgmma_desc<D * 2>(vs, 8 * D * 2, 8 * D * 2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = desc_advance(desc, kk * 16 * D * 2);
    if constexpr (D == 64)
      wgmma_rs_m64n64k16<1>(o, pa[kk], dv, 1);
    else
      wgmma_rs_m64n32k16<1>(o, pa[kk], dv, 1);
  }
  wgmma_commit();
}

// The online softmax of one S tile (k0: its first key), in place: masked
// when kMasked, then s = exp2(S - m) with m the new running row max; alpha
// rescales O and l, ps is this thread's partial row sum of the tile. Every
// row sees key 0 and tile 0 comes first, so m is finite from the first tile
// on and exp2(kNegInf - m) is 0.
template <bool kMasked>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float& m0,
                                             float& m1, float& alpha0,
                                             float& alpha1, float& ps0,
                                             float& ps1, int k0, int r0,
                                             int r1, int tk, int off,
                                             bool causal) {
  const int t = threadIdx.x % 4;
  if (kMasked) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * i + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        if (col >= tk || (causal && col > row + off)) s[4 * i + e] = kNegInf;
      }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
  }
  alpha0 = exp2_ftz(m0 - mx0);
  alpha1 = exp2_ftz(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  ps0 = 0.f;
  ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s[4 * i] = exp2_ftz(s[4 * i] - m0);
    s[4 * i + 1] = exp2_ftz(s[4 * i + 1] - m0);
    s[4 * i + 2] = exp2_ftz(s[4 * i + 2] - m1);
    s[4 * i + 3] = exp2_ftz(s[4 * i + 3] - m1);
    ps0 += s[4 * i] + s[4 * i + 1];
    ps1 += s[4 * i + 2] + s[4 * i + 3];
  }
}

// P (fp32 in s) rounded to bf16 straight into the A registers of P V.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[8][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ __launch_bounds__(kFwdThreads, 1) void flash_fwd_bf16_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, FwdArgs a) {
  using namespace hopper;
  constexpr int kRowBytes = D * 2;
  constexpr int kSwizzle = kRowBytes;
  constexpr uint32_t kTileBytes = kFwdKeys * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  FwdTiles<D>& sm = *reinterpret_cast<FwdTiles<D>*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));

  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int qt = a.heaviest_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kFwdRows;
  const int tq = a.tq, tk = a.tk, off = tk - tq;
  const int kend = a.causal ? min(tk, q0 + kFwdRows + off) : tk;
  const int ntiles = (kend + kFwdKeys - 1) / kFwdKeys;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int st = 0; st < kFwdStages; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&qmap);
      prefetch_tensor_map(&kmap);
      prefetch_tensor_map(&vmap);
      mbar_expect_tx(&sm.q_full, kFwdRows * kRowBytes);
      tma_load_4d(sm.q, &qmap, &sm.q_full, 0, q0, hi, bi);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kFwdStages;
        mbar_wait(&sm.empty[st], ((j / kFwdStages) & 1) ^ 1);
        mbar_expect_tx(&sm.k_full[st], kTileBytes);
        tma_load_4d(sm.k[st], &kmap, &sm.k_full[st], 0, j * kFwdKeys, hi, bi);
        mbar_expect_tx(&sm.v_full[st], kTileBytes);
        tma_load_4d(sm.v[st], &vmap, &sm.v_full[st], 0, j * kFwdKeys, hi, bi);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;  // consumer warpgroup: rows 64c.. of the block
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + 64 * c;  // this warpgroup's first row
  const int r0 = row0 + 16 * warp + g, r1 = r0 + 8;
  const float scale_log2 = a.scale * kLog2e;

  // this warpgroup's q rows, pre-scaled into the log2 domain and rounded to
  // bf16 once, in place (elementwise, so the swizzle does not matter); then
  // visible to wgmma, which reads them from shared memory
  mbar_wait(&sm.q_full, 0);
  const __nv_bfloat16* qw = sm.q + c * 64 * D;
  {
    uint4* qc = reinterpret_cast<uint4*>(sm.q + c * 64 * D);
#pragma unroll
    for (int idx = tid; idx < 64 * D / 8; idx += 128) {
      uint4 x = qc[idx];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        w[e] = pack_bf16x2(f.x * scale_log2, f.y * scale_log2);
      }
      qc[idx] = x;
    }
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
  }

  // tiles [0, nfull) hide no key from any row of this warpgroup, tiles
  // [nfull, nneed) need the mask, tiles [nneed, ntiles) hold no key any of
  // its rows sees
  int nneed = ntiles, nfull = tk / kFwdKeys;
  if (a.causal) {
    nneed = (min(tk, row0 + 64 + off) + kFwdKeys - 1) / kFwdKeys;
    nfull = min(tk, row0 + off + 1) / kFwdKeys;
  }
  nfull = min(nfull, nneed);

  // One tile at a time: S, the softmax, P V (the overlapped loop measured
  // slower; see the note at the top).
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[64];
  uint32_t pa[8][4];
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kFwdStages;
    const uint32_t parity = (j / kFwdStages) & 1;
    if (j < nneed) {
      mbar_wait(&sm.k_full[st], parity);
      issue_s<D>(s, qw, sm.k[st]);
      wgmma_wait<0>();
      fence_regs(s);
      float alpha0, alpha1, ps0, ps1;
      if (j < nfull)
        softmax_tile<false>(s, m0, m1, alpha0, alpha1, ps0, ps1, j * kFwdKeys,
                            r0, r1, tk, off, a.causal);
      else
        softmax_tile<true>(s, m0, m1, alpha0, alpha1, ps0, ps1, j * kFwdKeys,
                           r0, r1, tk, off, a.causal);
      l0 = l0 * alpha0 + ps0;  // partial over this thread's columns
      l1 = l1 * alpha1 + ps1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha0;
        o[4 * i + 1] *= alpha0;
        o[4 * i + 2] *= alpha1;
        o[4 * i + 3] *= alpha1;
      }
      pack_p(pa, s);
      mbar_wait(&sm.v_full[st], parity);
      issue_pv<D>(o, pa, sm.v[st]);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
    }
    // tiles past this warpgroup's last row's diagonal are released unread
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }

  // O / l (a division, as the plain version normalises) through this
  // warpgroup's half of the q tile (its own q rows, whose last reader, the
  // last S product, has completed), then 16-byte rows below tq to global
  named_barrier_sync(1 + c, 128);
  uint8_t* os = reinterpret_cast<uint8_t*>(sm.q) + c * 64 * kRowBytes;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int row = 16 * warp + g, col = 8 * i + 2 * t;
    *reinterpret_cast<uint32_t*>(os + swizzle<kSwizzle>(row * kRowBytes +
                                                        col * 2)) =
        pack_bf16x2(o[4 * i] / l0, o[4 * i + 1] / l0);
    *reinterpret_cast<uint32_t*>(os + swizzle<kSwizzle>((row + 8) * kRowBytes +
                                                        col * 2)) =
        pack_bf16x2(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
  }
  named_barrier_sync(1 + c, 128);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + bi * a.so.b +
                      hi * a.so.h;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int row = idx / kChunks, ch = idx % kChunks;
    if (row0 + row < tq)
      *reinterpret_cast<uint4*>(ob + (row0 + row) * a.so.r + ch * 8) =
          *reinterpret_cast<const uint4*>(
              os + swizzle<kSwizzle>(row * kRowBytes + ch * 16));
  }
  if (t == 0) {
    float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
    if (r0 < tq) lb[r0 * a.sl.r] = (m0 + log2f(l0)) * kLn2;
    if (r1 < tq) lb[r1 * a.sl.r] = (m1 + log2f(l1)) * kLn2;
  }
}

// -- fp32: register tiles (csrc/flash_f32.cuh) ----------------------------------

// The fp32 kernel's ring of k / v chunks and the blocks an SM its
// registers are held to (ops/flash_attention.py takes no plan in fp32).
constexpr int kFwd32Stages = 2;
constexpr int kFwd32Blocks = 3;

template <int D>
struct FwdF32 {
  float q[kF32Own][D + 4];
  float k[kFwd32Stages][kF32Chunk][D + 4];
  float v[kFwd32Stages][kF32Chunk][D + 4];
  float p[kF32Chunk][kF32Own + 4];  // P, stored [key][query row]
};

template <int D>
__global__ __launch_bounds__(kF32Threads, kFwd32Blocks) void flash_fwd_f32_kernel(
    FwdArgs a) {
  extern __shared__ float4 smem_f32[];
  FwdF32<D>& sm = *reinterpret_cast<FwdF32<D>*>(smem_f32);
  const int bi = blockIdx.x / a.h, hi = blockIdx.x % a.h;
  const int qt = a.heaviest_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kF32Own;
  const int tq = a.tq, tk = a.tk, off = tk - tq;
  const int tid = threadIdx.x;
  // chunks [0, nfull) hide no key from any row of the block, chunks
  // [nfull, n) need the mask; none past the last row's diagonal is loaded
  const int kend = a.causal ? min(tk, q0 + kF32Own + off) : tk;
  const int n = (kend + kF32Chunk - 1) / kF32Chunk;
  const int nfull =
      min(n, (a.causal ? min(tk, q0 + off + 1) : tk) / kF32Chunk);
  const float* kb = static_cast<const float*>(a.k) + bi * a.sk.b + hi * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + bi * a.sv.b + hi * a.sv.h;

  // chunk c into stage c % kFwd32Stages; one commit group a chunk (empty
  // past n), the q tile in chunk 0's
  const auto load_chunk = [&](int c) {
    if (c < n) {
      const int st = c % kFwd32Stages;
      load_rows_f32<D>(&sm.k[st][0][0], kb, a.sk.r, c * kF32Chunk, kF32Chunk,
                       tk);
      load_rows_f32<D>(&sm.v[st][0][0], vb, a.sv.r, c * kF32Chunk, kF32Chunk,
                       tk);
    }
    cp_async_commit();
  };
  load_rows_f32<D>(&sm.q[0][0],
                   static_cast<const float*>(a.q) + bi * a.sq.b + hi * a.sq.h,
                   a.sq.r, q0, kF32Own, tq);
#pragma unroll
  for (int c = 0; c < kFwd32Stages - 1; ++c) load_chunk(c);

  // this thread's rows row .. row + 3: running max m, its part l of the row
  // sum (the keys tid%8 + 8j of each chunk), o's 4 x D/8 slice
  const int row = q0 + 4 * (tid / 8);
  float o[4][D / 8], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) o[i][c] = 0.f;
  }
  for (int c = 0; c < n; ++c) {
    cp_async_wait<kFwd32Stages - 2>();  // chunk c has landed for this thread
    __syncthreads();  // ... for every thread; chunk c - 1's stage and P free
    load_chunk(c + kFwd32Stages - 1);
    const int st = c % kFwd32Stages, k0 = c * kF32Chunk;

    // S of the chunk, scaled; masked (-> kNegInf, P 0) on the diagonal and
    // the ragged last chunk only
    float s[4][4];
    micro_abt<D>(s, &sm.q[0][0], &sm.k[st][0][0]);
    const bool masked = c >= nfull;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tid % 8 + 8 * j;
        s[i][j] = masked && (key >= tk || (a.causal && key > row + i + off))
                      ? kNegInf
                      : s[i][j] * a.scale;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's max over its 8 lanes
#pragma unroll
      for (int x = 1; x <= 4; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float alpha = expf(m[i] - mx);
      m[i] = mx;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked && s[i][j] == kNegInf ? 0.f : expf(s[i][j] - mx);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int cc = 0; cc < D / 8; ++cc) o[i][cc] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sm.p[tid % 8 + 8 * j][4 * (tid / 8)]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // O += P V
    micro_atb<D>(o, &sm.p[0][0], &sm.v[st][0][0]);
  }

  // l over the 8 lanes that share the rows (each lane ends with the same
  // sum); O / l, then lse = m + log l from the first lane
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int x = 1; x <= 4; x <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
#pragma unroll
    for (int cc = 0; cc < D / 8; ++cc) o[i][cc] /= l[i];
  }
  store_slice<D>(static_cast<float*>(a.out) + bi * a.so.b + hi * a.so.h,
                 a.so.r, q0, tq, o, 1.f);
  if (tid % 8 == 0) {
    float* lb = a.lse + bi * a.sl.b + hi * a.sl.h;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (row + i < tq) lb[(row + i) * a.sl.r] = m[i] + logf(l[i]);
  }
}

// The bf16 kernel from a host plan (ops/flash_attention.py's FwdPlan, 33
// int64 values): for q, k and v in turn their map's dims (d, t, h, b), byte
// strides (t, h, b) and box (d, rows); then the swizzle bytes, the grid
// (b*h, q tiles), the threads, the dynamic shared-memory bytes and whether
// the q tiles run heaviest first.
template <int D>
cudaError_t launch_bf16(FwdArgs a, const int64_t* plan, cudaStream_t s) {
  const int64_t swz = plan[27], threads = plan[30], smem = plan[31];
  if (threads != kFwdThreads || swz != 2 * D ||
      smem < (int64_t)sizeof(FwdTiles<D>) + 1024 || smem > 232448)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* bases[3] = {a.q, a.k, a.v};
  for (int i = 0; i < 3; ++i) {
    const int64_t* p = plan + 9 * i;
    if (p[7] != D || p[8] != kFwdKeys ||
        !hopper::encode_bf16_map_4d(&maps[i], bases[i], p, p + 4, (int)p[7],
                                    (int)p[8], (int)swz))
      return cudaErrorInvalidValue;
  }
  static int64_t smem_set = 0;  // the attribute, set once per size
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid((unsigned)plan[28], (unsigned)plan[29]);
  a.heaviest_first = (int)plan[32];
  flash_fwd_bf16_kernel<D><<<grid, kFwdThreads, (size_t)smem, s>>>(
      maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

// The fp32 kernel: grid (b*h, q tiles of 64 rows), causal q tiles heaviest
// first (b*h rides x, so every head's heaviest tile is in the first wave).
template <int D>
cudaError_t launch_f32(FwdArgs a, int b, cudaStream_t s) {
  static int64_t smem_set = 0;  // the attribute, set once
  const int64_t smem = sizeof(FwdF32<D>);
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const dim3 grid(b * a.h, (a.tq + kF32Own - 1) / kF32Own);
  a.heaviest_first = a.causal;
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, (size_t)smem, s>>>(a);
  return cudaGetLastError();
}

Strides3 strides_at(const int64_t* s, int i) {
  return Strides3{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

}  // namespace

// General entry: strides holds (batch, head, row) element strides of q, k,
// v, out and lse, in that order (15 values); plan is the bf16 kernel's host
// plan (33 values; unused, and may be null, in fp32).
AMT_EXPORT int amt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, const int64_t* strides,
                             const int64_t* plan, int b, int h, int tq,
                             int tk, int d, float scale, int causal,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tq < 0 || tk <= 0 || h <= 0 || (int64_t)b * h > 65535)
    return cudaErrorInvalidValue;
  if (b == 0 || tq == 0) return cudaSuccess;
  FwdArgs a{q, k, v, out, static_cast<float*>(lse),
            strides_at(strides, 0), strides_at(strides, 1),
            strides_at(strides, 2), strides_at(strides, 3),
            strides_at(strides, 4), h, tq, tk, scale, causal, 0};
  if (dtype == AMT_BF16) {
    if (plan == nullptr) return cudaErrorInvalidValue;
    if (d == 64) return launch_bf16<64>(a, plan, s);
    if (d == 32) return launch_bf16<32>(a, plan, s);
  } else if (dtype == AMT_F32) {
    if (d == 64) return launch_f32<64>(a, b, s);
    if (d == 32) return launch_f32<32>(a, b, s);
  }
  return cudaErrorInvalidValue;
}

// Packed kv (kernel 1's layout): q (b, tq, h, d), kv (b, tk, 2, h, d), out
// like q, lse (b, tq, h), all contiguous; v is the view kv + h*d elements.
// plan (bf16) holds the maps of q and of the views kv[:, :, 0] and
// kv[:, :, 1].
AMT_EXPORT int amt_flash_fwd_kv(const void* q, const void* kv, void* out,
                                void* lse, const int64_t* plan, int b, int tq,
                                int tk, int h, int d, float scale, int causal,
                                int dtype, void* stream) {
  const int64_t hd = (int64_t)h * d;
  const int64_t st[15] = {tq * hd,          d, hd,      // q
                          2 * tk * hd,      d, 2 * hd,  // k = kv[:, :, 0]
                          2 * tk * hd,      d, 2 * hd,  // v = kv[:, :, 1]
                          tq * hd,          d, hd,      // out
                          (int64_t)tq * h,  1, h};      // lse
  const size_t item = dtype == AMT_BF16 ? 2 : 4;
  const void* v = static_cast<const char*>(kv) + hd * item;
  return amt_flash_fwd(q, kv, v, out, lse, st, plan, b, h, tq, tk, d, scale,
                       causal, dtype, stream);
}
