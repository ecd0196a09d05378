// Flash (online-softmax) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:75
// (flash_attention; body _attn_kernel at :25, pallas_call at :96). Per query
// row i (position qpos = i + Sk - Sq, queries at the tail of the kv
// sequence) and head h (kv head h / (H / KV)):
//
//   s    = scale * (q . k)                      float32
//   s    = cap * tanh(s / cap)                  when cap > 0
//   s    = -1e38 where not (kpos <= qpos       when causal
//                          and kpos > qpos - window   when window > 0
//                          and kpos < Sk)
//   m, l, acc: online softmax over kv tiles, f32 running max / sum / output
//   o    = acc / max(l, 1e-30)                  cast to q's type
//
// The masked value is the Pallas kernel's finite -1e38, never -inf, so no
// inf - inf can arise. Kv tiles that no query of the block can see are
// skipped; the result is the same, since every row holds a visible key
// (its diagonal when causal) and a tile a row cannot see adds exact zeros
// or is reset by the row's first visible key.
// Unlike the Pallas kernel, any Sq <= Sk is taken: the ragged edges (query
// rows >= Sq, kv rows >= Sk) are masked here.
//
// Bound: operations. 4 * D FLOPs per visible (q, k) pair against 2 bytes
// per element of q, k, v, o moved once; at gemma2-27b's prefill (4,608
// tokens, 32 heads, D = 128) that is 174 GFLOP against 113 MB, far past
// the card's balance point: 0.176 ms at 989 TFLOP/s (bf16 dense). A second
// floor is the special-function unit (MUFU, 16 operations per clock per
// SM): one exp2 per visible pair and head, and one tanh more with a
// softcap. At that prefill that is 0.08 ms without a softcap and 0.16 ms
// with one, nearly the tensor-core bound; reaching the bound needs the
// softmax to run while the tensor cores work.
//
// Two kernels, picked by the input type:
//
// bfloat16 (the serving path), for Hopper's TMA and wgmma:
//   - Loads: q, k, v and o are 4-D TMA tensor maps over (D, heads, S, B)
//     with boxes of (64 columns = 128 bytes, 1, rows, 1) and the 128-byte
//     swizzle that wgmma reads; rows past S load as zeros and are not
//     stored, and never come from the next batch row. The launcher builds
//     the maps (cuTensorMapEncodeTiled, found through the runtime).
//   - Warp specialisation: warpgroup 0 is the producer, one thread of
//     which loads Q once and streams K and V tiles through a 2-stage ring
//     (full / empty mbarriers per stage, K and V apart so Q·Kᵀ can start
//     before V lands). One or two consumer warpgroups own 64 query rows
//     each; with two, setmaxnreg moves registers from the producer (24)
//     to the consumers (240).
//   - Products: S = Q·Kᵀ as wgmma m64nBKk16 with both operands K-major in
//     shared memory; O += P·V with P from registers (the S accumulator
//     rounded to bf16 is the A fragment) and V read MN-major through the
//     descriptor's transpose bit. Q·Kᵀ of tile t and P·V of tile t - 1
//     are in flight together, and the two consumers take turns to start
//     them (ping-pong), so one's softmax runs under the other's products.
//   - Softmax: ex2.approx fed by one fmaf that takes the kept value to log2
//     units (|scale|·log2e, or cap·log2e after one tanh.approx with a
//     softcap; the running max stays unscaled, and a scale < 0 negates Q
//     once in shared memory), the mask only on tiles that cross the
//     diagonal, the window's lower edge or Sk. A row whose keys so far were
//     all masked keeps p = 0.
//   - Tiles: BQ = 64 per consumer, BK = 128 / 144 / 64 at D = 64 / 128 /
//     256, sized so that a consumer's S, P and O fragments stay in
//     registers without spilling or serialising the wgmmas (see Tiles).
//     D = 256 has one consumer (its 64 x 256 output alone is 128
//     registers a thread).
//   - Order: query tiles heaviest first (causal), so the short ones fill
//     the tail. Epilogue: o / l to bf16 in the warpgroup's Q rows of
//     shared memory, then one TMA store per 64 columns.
//
// float32: CUDA-core FMAs, so the result matches float32 math to 1e-5
// (tensor cores would round to tf32 or bf16). 256 threads per block of 64
// query rows, tiles staged as float32 (rows padded by one float), 4 x 4
// scores per thread, four threads per row's softmax, 4 rows x D/16 output
// columns per thread in registers. 116 KB of shared memory at D = 128.
//
// Shared memory above 48 KB is set with cudaFuncSetAttribute before each
// launch. Every fused multiply-add is an explicit fmaf: the library is
// built with -fmad=false for the quantize kernel's exact codes.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // float32 kernel: query rows per block
constexpr int BK = 64;  // float32 kernel: kv rows per tile
constexpr float NEG_INF = -1.0e38f;

struct TileRange {
  int t_begin, t_end;
};

// kv tiles of bk rows that some query of the block [q0, q0 + bq) can see
__device__ __forceinline__ TileRange tile_range(int q0, int bq, int bk,
                                                int Sq, int Sk, int causal,
                                                int window) {
  const int seq_off = Sk - Sq;
  const int q_first = q0 + seq_off;
  const int q_last = min(q0 + bq, Sq) - 1 + seq_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  return {k_begin / bk, (k_end + bk - 1) / bk};
}

__device__ __forceinline__ float score(float dot, float scale, float softcap,
                                       int qpos, int kpos, int Sk, int causal,
                                       int window) {
  float x = dot * scale;
  if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
  bool ok = kpos < Sk;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok ? x : NEG_INF;
}

// ---------------------------------------------------------------------------
// bfloat16: TMA ring, wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG = 128;     // threads per warpgroup
constexpr int STAGES = 2;   // depth of the K / V ring
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: consumer warpgroups (64 query rows each) and kv rows per
// tile, so that a consumer's S, P and O fragments stay in registers with
// Q·Kᵀ and P·V in flight together. ptxas holds a 384-thread block to 168
// registers a thread and lets a consumer past that (up to its setmaxnreg
// 240) only when the wgmma operands in flight need more: at D = 128,
// BK = 144 makes them S 72 + O 64 + P 36 = 172 and the consumer runs
// without spills, where BK = 128 (160) spills and serialises its wgmmas.
// D = 256 has one consumer: its 64 x 256 output alone is 128 registers.
template <int D>
struct Tiles {
  static constexpr int NC = D == 256 ? 1 : 2;
  static constexpr int BK = D == 64 ? 128 : (D == 128 ? 144 : 64);
  static constexpr int THREADS = WG * (1 + NC);  // producer warpgroup first
  static constexpr int BQ = 64 * NC;             // query rows per block
  static constexpr int CH = D / 64;              // 128-byte column boxes
  static constexpr int ON = D < 128 ? D : 128;   // wgmma N of P·V
  static constexpr int NO = D / ON;              // P·V wgmmas per k16 step
  static constexpr int Q_WG = 64 * D * 2;        // bytes of one WG's Q rows
  static constexpr int Q_BYTES = NC * Q_WG;
  static constexpr int KV_BYTES = BK * D * 2;    // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

// One tile's online softmax on a warpgroup's S accumulator (m64nNS·2).
// s[4·n8 + 2·i + e] is row r0 + 8i, column n8·8 + 2·(lane % 4) + e. Kept
// value x: the raw score s (Q was negated when scale < 0), or with a
// softcap tanh(s·scale/cap) = tanh(s·c1); x·cs is the score in log2 units
// (cs = |scale|·log2e = c1, or with a softcap cap·log2e = c2), so one fmaf
// feeds each exp2. Masked keys get
// NEG_INF. s returns p = 2^(x·cs - m·cs); m is the running max of x, l this
// thread's partial row sums, alpha the factor for the output accumulated
// so far. A row with no visible key yet keeps p = 0.
template <bool CAP, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool mask, int kcol,
                                             const int (&lo)[2],
                                             const int (&hi)[2], float c1,
                                             float c2) {
  const float cs = CAP ? c2 : c1;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float x = CAP ? tanh_mufu(s[j] * c1) : s[j];
    if (mask) {
      const int i = (j >> 1) & 1;
      const int kpos = kcol + (j >> 2) * 8 + (j & 1);
      x = (kpos >= lo[i] && kpos < hi[i]) ? x : NEG_INF;
    }
    s[j] = x;
    mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], x);
  }
  float mref[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mref[i] = mx[i] == NEG_INF ? 0.0f : mx[i] * cs;
    alpha[i] = ex2(fmaf(m[i], cs, -mref[i]));
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int i = (j >> 1) & 1;
    s[j] = ex2(fmaf(s[j], cs, -mref[i]));
    l[i] += s[j];
  }
}

// the C layout of two neighbouring n8 blocks is the A layout of one k16
template <int NS>
__device__ __forceinline__ void pack_p(const float (&s)[NS],
                                       uint32_t (&p)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D, bool CAP>
__global__ void __launch_bounds__(Tiles<D>::THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, int H,
                           int Sq, int Sk, int group, int causal, int window,
                           int negate_q, float c1, float c2) {
  using T = Tiles<D>;
  constexpr int NC = T::NC, BK = T::BK, CH = T::CH, ON = T::ON, NO = T::NO;
  constexpr bool PINGPONG = NC == 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * STAGES];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                       // [wg][chunk][64 rows][128 B]
  const uint32_t sK = sQ + T::Q_BYTES;            // [stage][chunk][BK][128 B]
  const uint32_t sV = sK + STAGES * T::KV_BYTES;  // [stage][chunk][BK][128 B]
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full_k = [&](int s) { return smem_u32(&bars[1 + s]); };
  auto full_v = [&](int s) { return smem_u32(&bars[1 + STAGES + s]); };
  auto empty_k = [&](int s) { return smem_u32(&bars[1 + 2 * STAGES + s]); };
  auto empty_v = [&](int s) { return smem_u32(&bars[1 + 3 * STAGES + s]); };

  const int h = blockIdx.x % H;
  const int b = blockIdx.x / H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * T::BQ;  // heaviest first
  const int kvh = h / group;
  const int seq_off = Sk - Sq;
  const TileRange tr = tile_range(q0, T::BQ, BK, Sq, Sk, causal, window);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * NC);  // lane 0 of every consumer warp
      mbar_init(empty_v(s), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform role, so that the compiler gives each branch the register
  // budget its setmaxnreg sets
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / WG, 0);
  if (wg == 0) {
    // producer: one thread keeps Q and the K / V ring loaded
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, T::Q_BYTES);
      for (int w = 0; w < NC; ++w)
        for (int c = 0; c < CH; ++c)
          tma_load(sQ + w * T::Q_WG + c * 64 * 128, &tm_q, bar_q, c * 64, h,
                   q0 + 64 * w, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = tr.t_begin; t < tr.t_end; ++t) {
        mbar_wait(empty_k(stage), phase ^ 1);
        mbar_expect_tx(full_k(stage), T::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sK + stage * T::KV_BYTES + c * BK * 128, &tm_k,
                   full_k(stage), c * 64, kvh, t * BK, b);
        mbar_wait(empty_v(stage), phase ^ 1);
        mbar_expect_tx(full_v(stage), T::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sV + stage * T::KV_BYTES + c * BK * 128, &tm_v,
                   full_v(stage), c * 64, kvh, t * BK, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int cw = wg - 1;  // consumer warpgroup: query rows 64·cw ..
    const int tid = threadIdx.x - WG * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int rw = warp * 16 + lane / 4;  // rows rw and rw + 8 of the WG
    const uint32_t sQw = sQ + cw * T::Q_WG;
    const int wq_first = q0 + 64 * cw;
    const int wq_last = min(wq_first + 64, Sq) - 1;
    const int kcol = 2 * (lane % 4);
    int lo[2], hi[2];  // visible keys [lo, hi) of this thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wq_first + rw + 8 * i + seq_off;
      hi[i] = causal ? min(Sk, qpos + 1) : Sk;
      lo[i] = window > 0 ? qpos - window + 1 : 0;
    }
    // does the tile at k0 hold a key some row of this warpgroup must not
    // see? Interior tiles skip the mask.
    auto needs_mask = [&](int k0) {
      return k0 + BK > Sk || (causal && k0 + BK - 1 > wq_first + seq_off) ||
             (window > 0 && k0 < wq_last + seq_off - window + 1);
    };

    float o[NO][ON / 2];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < ON / 2; ++j) o[n][j] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, alpha[2];
    float s[BK / 2];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = 0.0f;
    uint32_t p[BK / 16][4];

    auto qk = [&](int stage) {  // s = Q · K_tileᵀ
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss(s, sdesc(sQw + (kk / 4) * 64 * 128 + off, 16, 1024),
                 sdesc(sK + stage * T::KV_BYTES + (kk / 4) * BK * 128 + off,
                       16, 1024),
                 kk > 0);
      }
      wgmma_commit();
    };
    auto pv = [&](int stage) {  // o += P · V_tile
#pragma unroll
      for (int n = 0; n < NO; ++n) reg_fence(o[n]);
      reg_fence(p);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int n = 0; n < NO; ++n)
          wgmma_rs(o[n], p[j],
                   sdesc(sV + stage * T::KV_BYTES + n * (ON / 64) * BK * 128 +
                             j * 16 * 128,
                         BK * 128, 1024));
      wgmma_commit();
    };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    auto advance = [](int& stage, uint32_t& phase) {
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };

    // S of tile t and P·V of tile t - 1 are in flight together; with two
    // consumers they take turns (named barriers 3 and 4) to start them, so
    // one's softmax runs under the other's products. The first tile is
    // peeled so that no wgmma or wait in the loop is conditional.
    const int n_tiles = tr.t_end - tr.t_begin;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(bar_q, 0);
    if (!CAP && negate_q) {
      // scale < 0: flip the sign of this warpgroup's Q once, so that S holds
      // -q·k and its max is the max of the scaled score
      for (int e = tid; e < T::Q_WG / 16; e += WG) {
        uint32_t w[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "r"(sQw + 16 * e));
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                         sQw + 16 * e),
                     "r"(w[0] ^ 0x80008000u), "r"(w[1] ^ 0x80008000u),
                     "r"(w[2] ^ 0x80008000u), "r"(w[3] ^ 0x80008000u)
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_sync(1 + cw, WG);
    }
    if (PINGPONG && cw == 1) bar_arrive(3, 2 * WG);  // warpgroup 0 first
    {
      const int k0 = tr.t_begin * BK;
      mbar_wait(full_k(stage), phase);
      if (PINGPONG) bar_sync(3 + cw, 2 * WG);
      qk(stage);
      if (PINGPONG && !(cw == 1 && n_tiles == 1))
        bar_arrive(4 - cw, 2 * WG);
      wgmma_wait<0>();
      reg_fence(s);
      release(empty_k(stage));
      softmax_tile<CAP>(s, m, l, alpha, needs_mask(k0), k0 + kcol, lo, hi,
                        c1, c2);
      pack_p(s, p);
      advance(stage, phase);
    }
    int pstage = stage == 0 ? STAGES - 1 : stage - 1;
    uint32_t pphase = stage == 0 ? phase ^ 1 : phase;
    for (int i = 1; i < n_tiles; ++i) {
      const int k0 = (tr.t_begin + i) * BK;
      mbar_wait(full_k(stage), phase);
      if (PINGPONG) bar_sync(3 + cw, 2 * WG);
      qk(stage);
      mbar_wait(full_v(pstage), pphase);
      pv(pstage);
      if (PINGPONG && !(cw == 1 && i == n_tiles - 1))
        bar_arrive(4 - cw, 2 * WG);
      wgmma_wait<1>();  // S done, P·V may still run
      reg_fence(s);
      release(empty_k(stage));
      softmax_tile<CAP>(s, m, l, alpha, needs_mask(k0), k0 + kcol, lo, hi,
                        c1, c2);
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < NO; ++n) reg_fence(o[n]);
      reg_fence(p);
      release(empty_v(pstage));
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int j = 0; j < ON / 2; ++j) o[n][j] *= alpha[(j >> 1) & 1];
      pack_p(s, p);
      pstage = stage;
      pphase = phase;
      advance(stage, phase);
    }
    mbar_wait(full_v(pstage), pphase);  // the last tile's P·V
    pv(pstage);
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NO; ++n) reg_fence(o[n]);
    release(empty_v(pstage));

    // epilogue: o / l as bf16 into this warpgroup's Q rows (their last
    // reader, the last Q·Kᵀ, has completed), then one TMA store, which
    // drops rows >= Sq
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int j = 0; j < ON / 2; j += 2) {
        const int i = (j >> 1) & 1;
        const int row = rw + 8 * i;
        const int col = n * ON + (j >> 2) * 8 + kcol;
        const uint32_t addr = sQw + (col / 64) * 64 * 128 + row * 128 +
                              ((((col % 64) / 8) ^ (row % 8)) * 16) +
                              (col % 8) * 2;
        const uint32_t v = pack_bf16(o[n][j] * inv[i], o[n][j + 1] * inv[i]);
        asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v)
                     : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(1 + cw, WG);
    if (tid == 0 && wq_first < Sq) {
      for (int c = 0; c < CH; ++c)
        tma_store(&tm_o, sQw + c * 64 * 128, c * 64, h, wq_first, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int Sq, int Sk, int H, int KV, int causal,
                         int window, float softcap, float scale) {
  constexpr int DP = D + 1;   // padded row stride of Qs / Ks
  constexpr int SP = BK + 1;  // padded row stride of Ss
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x DP
  float* Ks = Qs + BQ * DP;    // BK x DP
  float* Vs = Ks + BK * DP;    // BK x D
  float* Ss = Vs + BK * D;     // BQ x SP: scores, then probabilities
  float* m_s = Ss + BQ * SP;   // BQ running max
  float* l_s = m_s + BQ;       // BQ running sum
  float* a_s = l_s + BQ;       // BQ rescale factor of this tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int seq_off = Sk - Sq;
  const int64_t q_row = (int64_t)H * D;
  const int64_t kv_row = (int64_t)KV * D;
  const float* qb = q + ((int64_t)b * Sq * H + h) * D;
  const float* kb = k + ((int64_t)b * Sk * KV + kvh) * D;
  const float* vb = v + ((int64_t)b * Sk * KV + kvh) * D;
  float* ob = o + ((int64_t)b * Sq * H + h) * D;

  for (int e = tid; e < BQ * D; e += F32_THREADS) {
    const int r = e / D, d = e % D;
    const int qi = q0 + r;
    Qs[r * DP + d] = qi < Sq ? qb[qi * q_row + d] : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }

  const int sr = tid / 16, sc = tid % 16;  // rows sr + 16i, cols sc + 16j
  const int xr = tid / 4, xs = tid % 4;    // softmax: 4 threads per row
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  const TileRange tr = tile_range(q0, BQ, BK, Sq, Sk, causal, window);
  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of Ks / Vs / Ss are done
    for (int e = tid; e < BK * D; e += F32_THREADS) {
      const int r = e / D, d = e % D;
      const int ki = k0 + r;
      const bool in = ki < Sk;
      Ks[r * DP + d] = in ? kb[ki * kv_row + d] : 0.0f;
      Vs[r * D + d] = in ? vb[ki * kv_row + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(sr + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(sc + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = sr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = sc + 16 * j;
        Ss[r * SP + c] = score(s[i][j], scale, softcap, q0 + r + seq_off,
                               k0 + c, Sk, causal, window);
      }
    }
    __syncthreads();

    {  // online softmax of row xr over this tile
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) mx = fmaxf(mx, Ss[xr * SP + xs + 4 * c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[xr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 4; ++c) {
        const float p = expf(Ss[xr * SP + xs + 4 * c] - m_new);
        Ss[xr * SP + xs + 4 * c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (xs == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[xr] = l_s[xr] * alpha + sum;
        m_s[xr] = m_new;
        a_s[xr] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[sr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(sr + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * D + sc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = sr + 16 * i;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) ob[qi * q_row + sc + 16 * j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32_d(const void* q, const void* k, const void* v, void* o, int B,
                 int Sq, int Sk, int H, int KV, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  flash_fwd_f32_kernel<D><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, a libcuda entry point looked up through the
// runtime, so the library needs no -lcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a (B, S, heads, D) bfloat16 tensor as a 4-D map (D, heads, S, B) with a
// box of (64, 1, rows, 1): one 128-byte row of 64 columns per sequence
// position, swizzled for wgmma; rows past S read as zeros and are not
// written, and never spill into the next batch row
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool CAP>
int launch_bf16_d(const void* q, const void* k, const void* v, void* o, int B,
                  int Sq, int Sk, int H, int KV, int causal, int window,
                  float softcap, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  auto kern = flash_fwd_wgmma_kernel<D, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, Sq, H, D, 64) ||
      !make_map(&mk, k, B, Sk, KV, D, T::BK) ||
      !make_map(&mv, v, B, Sk, KV, D, T::BK) ||
      !make_map(&mo, o, B, Sq, H, D, 64))
    return (int)cudaErrorInvalidValue;
  // softmax_tile's constants: scores to log2 units as s·(|scale|·log2e),
  // with Q negated when scale < 0, or with a softcap cap·log2e·tanh(s·scale
  // / cap). |scale| is held at 1e-30 or more, so that a masked key's
  // -1e38 still lands far below any score (p = 0) when scale is 0.
  const int negate_q = !CAP && scale < 0.0f;
  const float c1 = CAP ? scale / softcap : fmaxf(fabsf(scale), 1e-30f) * LOG2E;
  const float c2 = CAP ? softcap * LOG2E : 1.0f;
  const dim3 grid((unsigned)(H * B), (unsigned)((Sq + T::BQ - 1) / T::BQ));
  kern<<<grid, T::THREADS, T::SMEM, stream>>>(mq, mk, mv, mo, H, Sq, Sk,
                                              H / KV, causal, window,
                                              negate_q, c1, c2);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KV, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32_d<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                           softcap, scale, stream);
  if (dtype == 1 && softcap > 0.0f)
    return launch_bf16_d<D, true>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                  window, softcap, scale, stream);
  if (dtype == 1)
    return launch_bf16_d<D, false>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                   window, softcap, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), contiguous, all
// of one type: dtype 0 = float32, 1 = bfloat16 (16-byte aligned). window 0
// = none, softcap 0 = none. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernels do not take (including a
// tensor the TMA maps cannot describe).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int Sq,
                                     int Sk, int H, int KV, int D, int dtype,
                                     int causal, int window, float softcap,
                                     float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk < Sq || KV <= 0 || H % KV != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<64>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                          softcap, scale, s);
    case 128:
      return launch_d<128>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal,
                           window, softcap, scale, s);
    case 256:
      return launch_d<256>(dtype, q, k, v, o, B, Sq, Sk, H, KV, causal,
                           window, softcap, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
