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
// What kept a block-per-row kernel far from that bound was its instruction
// stream (the register-bisection kernel this replaces read 0.52 ms at the
// decode shape): sixteen counts over the whole row in series, each a
// compare and an add per value and a block-wide reduction, and the noise
// drawn wherever a lane happened to hold a kept value, so a warp ran
// Philox and two logf for nearly every group of every lane (a kept value
// is one in ten, spread over all the lanes).
//
// Design. The block's 256 threads hold a chunk of up to 8192 values in
// registers (8 groups of 4 consecutive columns a thread, group j at column
// 4 * (thread + 256 j)); a wider row is walked chunk by chunk, read again
// for each pass in the same order.
//   - min and max with the load, one barrier;
//   - the bisection, bit for bit kth_value_bisect's (ops/sampling.py): each
//     midpoint mid = __fmul_rn(0.5f, __fadd_rn(lo, hi)), lo = mid where
//     count(x >= mid) >= k, one block-wide count (a barrier, the warps'
//     counts in double-buffered slots) a level. The first levels count the
//     whole row, until at most kCap values lie in [lo, hi): count(x >= lo)
//     - count(x >= hi), both known from the counts taken (count(x >= max)
//     taken as 0 while hi is the max, and then [lo, max] is kept whole).
//     Then each warp gathers its own such values (a ballot a value, no
//     atomics), at most kPerWarp, four a lane in registers (a warp with
//     more: one more whole-row level, and again), and the remaining levels
//     count those four: count(x >= mid) = count(x >= hi) + theirs. At the
//     decode shape three whole-row levels leave some 850 values;
//   - the noise only for kept values, x >= kth (about 1 - p of them): each
//     warp appends its kept (value, column) pairs to a ring in shared
//     memory (a ballot and a population count a value) and draws their
//     noise 32 at a time with every lane busy, each its own Philox4x32-10
//     call (the word of its column) and two logf; the argmax is order-free
//     (first index on ties), so the pick does not depend on that order;
//   - the exp-sum in each thread's column order, then the warps'
//     butterflies and the warps in order, as in the kernel this replaces,
//     so picks and scores keep its bits.
// tests/test_torch_sampling.py holds a numpy model of the search to
// kth_value_bisect on ties, constant rows, k = 1 and k = C, collapsing
// ranges and negative rows.
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 8;                      // groups of 4 a thread
constexpr int kChunk = 4 * kGroups * kThreads;  // 8192 columns
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 4;                     // gathered values a lane holds
constexpr int kPerWarp = 32 * kPerLane;
constexpr int kCap = kWarps * kPerWarp;  // values the last levels count
constexpr int kQueue = 256;  // a warp's ring of kept values (a power of 2)

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

struct Pick {
  float noised;  // the value compared
  int idx;       // its column
  float x;       // the (guided) logit there
};

__device__ __forceinline__ bool better(const Pick& a, const Pick& b) {
  return a.noised > b.noised || (a.noised == b.noised && a.idx < b.idx);
}

struct Shared {
  float cand[kCap];  // each warp's values in [lo, hi), kPerWarp a warp
  int nwarp[kWarps];
  float redmax[kWarps], redmin[kWarps], redsum[kWarps];
  int redcnt[2][kWarps];
  Pick redp[kWarps];
  float qx[kWarps][kQueue];  // each warp's ring of kept values ...
  int qcol[kWarps][kQueue];  // ... and their columns
};

__device__ __forceinline__ uint32_t lanes_below() {
  uint32_t m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ float bisect_mid(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// Blocks an SM: three (at most 80 registers a thread); for fp32 logits
// with CFG, whose cond and null loads in flight need more, two for a held
// row and one for a row walked in chunks.
template <typename T, bool kNull, bool kHeld>
constexpr int min_blocks() {
  return sizeof(T) == 4 && kNull ? (kHeld ? 2 : 1) : 3;
}

// kHeld: the row is one chunk, read once and held in registers through
// every pass; else each pass reads its chunks again (a separate
// instantiation, so neither pays the other's registers).
template <typename T, bool kNull, bool kBits, bool kHeld>
__global__ __launch_bounds__(kThreads, (min_blocks<T, kNull, kHeld>())) void sample_epilogue_kernel(
    const T* __restrict__ cond, const T* __restrict__ null,
    const int32_t* __restrict__ bits, const int64_t* __restrict__ seeds,
    int rows_per_seed, uint32_t step, int32_t* __restrict__ pred,
    float* __restrict__ score, int C, int k, int iters, float gs, float temperature) {
  __shared__ Shared sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x;
  const int64_t base_off = (int64_t)row * C;
  const int chunks = kHeld ? 1 : (C + kChunk - 1) / kChunk;

  float v[kGroups][4];
  // v = the (guided) logits of the chunk at column c0
  const auto load = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int col = c0 + 4 * (tid + j * kThreads);
      if (col < C) {
        load4(cond + base_off + col, v[j]);
        if (kNull) {
          float nv[4];
          load4(null + base_off + col, nv);
#pragma unroll
          for (int w = 0; w < 4; ++w)
            v[j][w] = __fadd_rn(nv[w], __fmul_rn(gs, __fsub_rn(v[j][w], nv[w])));
        }
      }
    }
  };
  // fn(group values, first column) for each of this thread's groups of the
  // row, chunk by chunk in order (each chunk read again unless the row is
  // held)
  const auto each_group = [&](auto&& fn) {
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * kChunk;
      if (!kHeld) load(c0);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const int col = c0 + 4 * (tid + j * kThreads);
        if (col < C) fn(v[j], col);
      }
    }
  };

  if (kHeld) load(0);
  float vmax = -INFINITY, vmin = INFINITY;
  each_group([&](const float(&g)[4], int) {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      vmax = fmaxf(vmax, g[w]);
      vmin = fminf(vmin, g[w]);
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, o));
  }
  if (lane == 0) {
    sm.redmax[warp] = vmax;
    sm.redmin[warp] = vmin;
  }
  __syncthreads();
  float rmax = sm.redmax[0], lo = sm.redmin[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    rmax = fmaxf(rmax, sm.redmax[w]);
    lo = fminf(lo, sm.redmin[w]);
  }
  float hi = rmax;

  // the largest threshold found with count(x >= t) >= k. Whole-row counts
  // until at most kCap values lie in [lo, hi) (all of [lo, max] while hi is
  // the max); then each warp gathers its own such values, at most kPerWarp
  // (else one more whole-row level, and again), four a lane in registers,
  // and the counts take those: count(x >= mid) = count(x >= hi) + theirs.
  int done = 0, cnt_lo = C, cnt_hi = 0, base = 0, mine = 0;
  bool hi_moved = false, gathered = false;
  float c[kPerLane];
  for (; done < iters; ++done) {
    if (!gathered && cnt_lo - cnt_hi <= kCap) {
      const float hi_x = hi_moved ? hi : INFINITY;
      float* region = sm.cand + warp * kPerWarp;
      int n = 0;  // this warp's values in [lo, hi_x), the same in every lane
      for (int ch = 0; ch < chunks; ++ch) {
        const int c0 = ch * kChunk;
        if (!kHeld) load(c0);
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const bool in = c0 + 4 * (tid + j * kThreads) < C;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const bool take = in && v[j][w] >= lo && v[j][w] < hi_x;
            const uint32_t m = __ballot_sync(0xffffffffu, take);
            const int at = n + __popc(m & lanes_below());
            if (take && at < kPerWarp) region[at] = v[j][w];
            n += __popc(m);
          }
        }
      }
      if (lane == 0) sm.nwarp[warp] = n;
      __syncthreads();
      int most = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) most = max(most, sm.nwarp[w]);
      if (most <= kPerWarp) {
        gathered = true;
        base = hi_moved ? cnt_hi : 0;
        mine = n;
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          c[i] = lane + 32 * i < n ? region[lane + 32 * i] : 0.f;
      }
    }
    const float mid = bisect_mid(lo, hi);
    int c2[2] = {0, 0};  // two chains of adds
    if (gathered) {
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) c2[i & 1] += lane + 32 * i < mine && c[i] >= mid;
    } else {
      each_group([&](const float(&g)[4], int) {
#pragma unroll
        for (int w = 0; w < 4; ++w) c2[w & 1] += g[w] >= mid;
      });
    }
    int cnt = __reduce_add_sync(0xffffffffu, c2[0] + c2[1]);
    if (lane == 0) sm.redcnt[done & 1][warp] = cnt;
    __syncthreads();
    cnt = base;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) cnt += sm.redcnt[done & 1][w];
    if (cnt >= k) {
      lo = mid;
      cnt_lo = cnt;
    } else {
      hi = mid;
      cnt_hi = cnt;
      hi_moved = true;
    }
  }
  const float kth = lo;

  // the exp-sum in column order; the kept values' noise 32 at a time from
  // the warp's ring; the argmax
  Pick best{-INFINITY, INT_MAX, 0.f};
  float esum = 0.f;
  const uint2 key = kBits ? make_uint2(0u, 0u)
                          : make_uint2((uint32_t)seeds[row / rows_per_seed], step);
  const uint32_t pos = (uint32_t)(row % rows_per_seed);
  float* qx = sm.qx[warp];
  int* qcol = sm.qcol[warp];
  uint32_t head = 0, tail = 0;  // the same in every lane of the warp
  const auto draw = [&](int count) {
    if (lane < count) {
      const uint32_t at = (head + lane) & (kQueue - 1);
      const float x = qx[at];
      const int col = qcol[at];
      uint32_t b;
      if (kBits) {
        b = (uint32_t)bits[base_off + col];
      } else {
        const uint4 q = philox4x32_10(make_uint4((uint32_t)(col / 4), pos, 0u, 0u), key);
        const int w = col % 4;
        b = w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
      }
      const Pick cand{__fadd_rn(x, __fmul_rn(temperature, gumbel_of_bits(b))), col, x};
      if (better(cand, best)) best = cand;
    }
    head += count;
  };
  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * kChunk;
    if (!kHeld) load(c0);
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int col = c0 + 4 * (tid + j * kThreads);
      const bool in = col < C;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (in) esum += expf(v[j][w] - rmax);
        const bool kept = in && v[j][w] >= kth;
        const uint32_t m = __ballot_sync(0xffffffffu, kept);
        if (kept) {
          const uint32_t at = (tail + __popc(m & lanes_below())) & (kQueue - 1);
          qx[at] = v[j][w];
          qcol[at] = col + w;
        }
        tail += __popc(m);
      }
      __syncwarp();
      while (tail - head >= 32) draw(32);
    }
  }
  draw((int)(tail - head));

  // the exp-sum and the argmax (first index on ties) across the block: the
  // warps' butterflies, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    esum += __shfl_xor_sync(0xffffffffu, esum, o);
    Pick other;
    other.noised = __shfl_xor_sync(0xffffffffu, best.noised, o);
    other.idx = __shfl_xor_sync(0xffffffffu, best.idx, o);
    other.x = __shfl_xor_sync(0xffffffffu, best.x, o);
    if (better(other, best)) best = other;
  }
  if (lane == 0) {
    sm.redsum[warp] = esum;
    sm.redp[warp] = best;
  }
  __syncthreads();
  if (tid == 0) {
    Pick r = sm.redp[0];
    float total = sm.redsum[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      total += sm.redsum[w];
      if (better(sm.redp[w], r)) r = sm.redp[w];
    }
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
  const bool held = C <= kChunk;
#define AMT_SAMPLE(NULL_, BITS_)                                                \
  do {                                                                          \
    const auto kern = held ? sample_epilogue_kernel<T, NULL_, BITS_, true>      \
                           : sample_epilogue_kernel<T, NULL_, BITS_, false>;    \
    kern<<<rows, kThreads, 0, s>>>(c, nl, bits, seeds, rows_per_seed, step, pred, \
                                   score, C, k, iters, gs, temp);               \
  } while (0)
  if (nl && bits) AMT_SAMPLE(true, true);
  else if (nl) AMT_SAMPLE(true, false);
  else if (bits) AMT_SAMPLE(false, true);
  else AMT_SAMPLE(false, false);
#undef AMT_SAMPLE
  return cudaGetLastError();
}

}  // namespace

// null and bits may be null pointers; seeds is read only without bits. Any
// C % 4 == 0: rows past 8192 columns are walked in chunks.
AMT_EXPORT int amt_sample_epilogue(const void* cond, const void* null, const void* bits,
                                   const void* seeds, int rows_per_seed, int step,
                                   void* pred, void* score, int rows, int C, int k,
                                   int iters, float gs, float temperature, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return cudaSuccess;
  if (C <= 0 || C % 4 != 0 || rows_per_seed <= 0 || iters < 0)
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
