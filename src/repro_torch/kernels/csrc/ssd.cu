// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:68
// (ssd_chunked_kernel; body _ssd_kernel at :20-65, pallas_call at :82).
// For each batch row b and head h (B/C group g = h / (H / G)), over chunks
// of Q rows, from a zero state or the caller's initial state (P x N):
//
//   cums_i  = sum_{k <= i} dt_k * A_h                  inclusive, per chunk
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//           + exp(cums_i) C_i . state                  (state entering it)
//   state   = exp(cums_last) state + sum_j exp(cums_last - cums_j) dt_j x_j B_j^T
//
// and the final state is written after the last chunk. An initial state
// enters chunk 0 as the state passed from a previous chunk enters the
// others; without one chunk 0 has no state term. float32 or bfloat16
// x / B / C are read as float32 and y is written in x's type. The decay is
// selected, never multiplied by a mask: for i < j the exponent is positive
// and may overflow, and inf * 0 is NaN.
//
// S need not be a multiple of Q: the last chunk has qc = S - (nc - 1) Q
// rows. Its rows >= qc are staged as zeros with dt = 0, so they neither
// decay nor inject anything, cums_last is the cumulative sum at row
// qc - 1, and only rows < qc are written.
//
// Bound. The least work per head and chunk is the lower triangle of
// (C B^T o L) . (x dt) (Q(Q+1)/2 x P multiply-adds), the state term of y and
// the chunk's state (Q x P x N each), and C . B^T once per group: about
// 15.9 GFLOP at mamba2-2.7b's 4,096-token prefill against 176 MB moved.
// In float32 on the CUDA cores that is 0.238 ms (67 TFLOP/s); on the
// tensor cores at three bf16 products per float32 product (below) it is
// 0.048 ms, under the 0.0525 ms the bytes take at 3.35 TB/s. So every
// product runs on the tensor cores, and the work is cut into enough
// independent blocks to fill the card. What is left bounds it by memory:
// the passes move more than the least bytes (the states go through a
// scratch, each head reads its group's B, C and C . B^T from L2), and a
// block stages its tiles before it computes (PERF.md has the times).
//
// Precision. One bf16 or TF32 product per float32 product does not hold
// the float32 tolerance (3e-4) at N = 128 (tests/test_torch_ssd_precision.py
// emulates it). Every product here is a three-pass split with float32
// accumulators: a = ah + al with ah = bf16(a), al = bf16(a - ah), and
// d += al bh + ah bl + ah bh, three wgmmas, the small terms first. The
// dropped al bl and the rounding of the lo parts leave a relative error of
// about 2^-16 per product. Exponents are taken in float32 before the
// split.
//
// Two chunk-parallel passes (the SSD paper's decomposition,
// arXiv:2405.21060 section 6), every product on wgmma m64n64k16 with
// float32 accumulators. The threads that stage an operand split it into
// bf16 hi / lo tiles in shared memory, in the 128-byte swizzle the wgmma
// descriptors name (the same layouts as the flash kernel's TMA tiles);
// ldmatrix .trans reads A fragments from them where A comes from
// registers:
//
//   a. C . B^T per (b, group, chunk), one warpgroup per 64 x 64 tile at or
//      below the chunk's diagonal, both operands K-major from shared
//      memory; into a float32 scratch (b * G * nc * QP^2 floats, QP = Q
//      rounded up to 64; 4 MB at the layer, held in L2).
//   b. Everything else per (b, h, chunk, 64 of P), two warpgroups: x dt
//      is staged once; the chunk's state S_c = (x dt)^T . (w o B) over
//      32-row slices of B that cp.async loads one ahead; state passing
//      (each block waits for the block of the previous chunk of its head
//      and writes the state entering the next chunk, exp(cums_last) S_in
//      + S_c, into a float32 scratch of b * (nc - 1) * H * P * N floats,
//      39 MB at the layer); then y = exp(cums) C . S_in^T + (C B^T o L) . (x dt)
//      with the decayed C . B^T tile built in registers from the scratch
//      (each exp once per head and chunk).
//
// Every fused multiply-add outside the tensor cores is an explicit fmaf:
// the library is built with -fmad=false for the quantize kernel's exact
// codes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;   // pass b; also the longest chunk
constexpr int WARPS = THREADS / 32;
constexpr int QMAX = THREADS;  // one cumulative-sum row per thread
constexpr int PT = 64;         // columns of P per block of pass b
constexpr int CT = 64;         // C . B^T tile (pass a)

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
}

// Inclusive cumulative sum of dt * A over a chunk's rows into cums[0..256)
// and dt into dts (rows >= qc hold dt = 0, so cums stays at row qc - 1).
// dtc points at the chunk's first row of this head's dt (row stride H).
// Ends with the block synchronised.
__device__ __forceinline__ void chunk_cumsum(const float* dtc, int H, int qc,
                                             float Ah, float* cums, float* dts,
                                             float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float dtv = tid < qc ? dtc[(long long)tid * H] : 0.f;
  float v = dtv * Ah;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) wsum[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += wsum[w];
  cums[tid] = v;
  dts[tid] = dtv;
  __syncthreads();
}

// byte offset of bf16 element (row r, column col) in a tile of 64-column
// boxes of `rows` rows, 128-byte swizzle (16-byte chunks XOR row % 8)
__device__ __forceinline__ uint32_t sw128(int r, int col, int rows) {
  return (uint32_t)((col >> 6) * rows * 128 + r * 128 +
                    ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2);
}

// split four floats and store them at byte offset off of the hi and lo
// tiles (8 bytes each, inside one 16-byte chunk)
__device__ __forceinline__ void store_split4_sw(uint32_t hi, uint32_t lo,
                                                uint32_t off, float4 v) {
  uint32_t h0, l0, h1, l1;
  split2(v.x, v.y, h0, l0);
  split2(v.z, v.w, h1, l1);
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(hi + off), "r"(h0),
               "r"(h1)
               : "memory");
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};" ::"r"(lo + off), "r"(l0),
               "r"(l1)
               : "memory");
}

// ---------------------------------------------------------------------------
// a. C . B^T per (batch row, group, chunk)
// ---------------------------------------------------------------------------

constexpr int CB_THREADS = 128;   // one warpgroup

// bytes of a 64-row hi or lo tile N wide, in boxes of 64 columns (one box
// when N < 64; its columns past N are never read)
template <int N>
__host__ __device__ constexpr int box_bytes(int rows) {
  return (N + 63) / 64 * rows * 128;
}

template <int N>
constexpr size_t cb_smem_bytes() {
  return 1024 + 4 * (size_t)box_bytes<N>(CT);
}

// One 64 x 64 tile at or below the chunk's diagonal per block: grid
// (ntq (ntq + 1) / 2 tiles, nc chunks, b * G). C's and B's rows of the
// tile are split into K-major swizzled tiles ([row][n]) and multiplied on
// wgmma m64n64k16 with both operands from shared memory. Rows >= qc of a
// short last chunk are zeros; tiles wholly past them are not written
// (pass b never reads them).
template <typename T, int N>
__global__ void __launch_bounds__(CB_THREADS)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int S, int G, int Q, int QP, int nc) {
  constexpr int TB = box_bytes<N>(CT);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ch = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t cl = ch + TB, bh = cl + TB, bl = bh + TB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = (int)blockIdx.x - qt * (qt + 1) / 2;
  const int c = blockIdx.y, bg = blockIdx.z;
  const int bi = bg / G, g = bg % G;
  const int s0 = c * Q, qc = min(Q, S - s0);
  if (qt * CT >= qc) return;   // uniform across the block

  const long long bstride = (long long)G * N;
  const long long boff = ((long long)bi * S + s0) * bstride + (long long)g * N;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < CT * N / 4; e += CB_THREADS) {
    const int r = e / (N / 4), n = (e % (N / 4)) * 4;
    const int ri = qt * CT + r, rj = kt * CT + r;
    const uint32_t off = sw128(r, n, CT);
    store_split4_sw(ch, cl, off, ri < qc ? load4(Cm + boff + ri * bstride + n) : z);
    store_split4_sw(bh, bl, off, rj < qc ? load4(Bm + boff + rj * bstride + n) : z);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  reg_fence(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t off = (kk / 4) * CT * 128 + (kk % 4) * 32;
    wgmma_ss(acc, sdesc(cl + off, 16, 1024), sdesc(bh + off, 16, 1024), 1);
    wgmma_ss(acc, sdesc(ch + off, 16, 1024), sdesc(bl + off, 16, 1024), 1);
    wgmma_ss(acc, sdesc(ch + off, 16, 1024), sdesc(bh + off, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);

  // acc[4 n + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
  // 8 n + 2 (lane % 4) + e % 2
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  float* out = cb + ((long long)bg * nc + c) * QP * QP +
               (long long)(qt * CT + 16 * warp + gr) * QP + kt * CT + tc;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    store2(out + 8 * n, acc[4 * n], acc[4 * n + 1]);
    store2(out + 8 * QP + 8 * n, acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// split the 16 bytes of raw elements at raw (row r, columns n..), times s,
// into the swizzled hi / lo tiles of `rows` rows
__device__ __forceinline__ void split_store16_sw(const float* raw, uint32_t hi,
                                                 uint32_t lo, int r, int n,
                                                 int rows, float s) {
  store_split4_sw(hi, lo, sw128(r, n, rows), scale4(load4(raw), s));
}

__device__ __forceinline__ void split_store16_sw(const __nv_bfloat16* raw,
                                                 uint32_t hi, uint32_t lo,
                                                 int r, int n, int rows,
                                                 float s) {
  store_split4_sw(hi, lo, sw128(r, n, rows), scale4(load4(raw), s));
  store_split4_sw(hi, lo, sw128(r, n + 4, rows), scale4(load4(raw + 4), s));
}

// ---------------------------------------------------------------------------
// b. each chunk's state, the state passing and the outputs
// ---------------------------------------------------------------------------

// x dt as 256 rows (j) of 64 columns (p): bytes of the hi or the lo tile
constexpr int XT_BYTES = QMAX * 128;
constexpr int KB = 32;   // rows of B per slice of the state product

// the block's work region holds B's slices (split, then raw) while the
// chunk's state is formed, then the state entering the chunk (split)
template <typename T, int N>
constexpr size_t work_bytes() {
  return 2 * (size_t)box_bytes<N>(KB) + (size_t)KB * N * sizeof(T) >
                 2 * (size_t)box_bytes<N>(PT)
             ? 2 * (size_t)box_bytes<N>(KB) + (size_t)KB * N * sizeof(T)
             : 2 * (size_t)box_bytes<N>(PT);
}

template <typename T, int N>
constexpr size_t chunk_smem_bytes() {
  return 1024 + 2 * (size_t)XT_BYTES + work_bytes<T, N>();
}

// One (head, chunk, b * npt + P tile) per block of two warpgroups, taken
// in order from an atomic ticket (sync[0]), heads of a chunk side by side
// so that the chunk's B, C and C . B^T stay in L2:
//   1. x dt of the whole chunk is split into a swizzled tile ([j][p]).
//   2. S_c = (x dt)^T . (w o B), w_j = exp(cums_last - cums_j), over
//      slices of 32 rows of B that cp.async loads one ahead; A from
//      registers (ldmatrix .trans of the x dt tile), B MN-major, one
//      warpgroup per 64 columns of N (at N <= 64 warpgroup 1 waits).
//   3. State passing: wait until the block of chunk c - 1 has written the
//      state entering chunk c (its flag in sync; chunk 0 enters with the
//      initial state, or with none), write
//      exp(cums_last) S_in + S_c into states[b][c][h] (after the
//      last chunk the final state into state_out), raise this chunk's
//      flag, and split S_in into a K-major tile ([p][n]).
//   4. The outputs: each warpgroup owns 64-row tiles of the chunk (tiles
//      wg and 3 - wg, heavy with light), computes C . S_in^T with C's
//      fragments read from global memory, scales its rows by
//      exp(cums_i), then adds the intra-chunk product, its A fragments the
//      decayed C . B^T tile built in registers from the scratch (each exp
//      once per head and chunk), B the x dt tile. Rows < qc and columns
//      < pv are written.
// Three wgmma m64n64k16 per k step (al bh, ah bl, ah bh).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const float* __restrict__ cb,
                 float* __restrict__ states, int* __restrict__ sync,
                 const float* __restrict__ init,
                 T* __restrict__ y, float* __restrict__ state_out, int S,
                 int H, int P, int G, int Q, int QP) {
  constexpr int NB = (N + 63) / 64;          // 64-column boxes of N
  constexpr int BT = box_bytes<N>(KB);       // a split slice of B
  constexpr int SB = box_bytes<N>(PT);       // the split S_in
  constexpr int E = 16 / (int)sizeof(T);     // elements per cp.async
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float cums[QMAX], dts[QMAX], wts[QMAX], wsum[WARPS];
  __shared__ int ticket;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t xh = base, xl = xh + XT_BYTES;    // x dt
  const uint32_t work = xl + XT_BYTES;
  const uint32_t bh = work, bl = bh + BT;          // w o B, one slice
  const uint32_t sh = work, sl = sh + SB;          // S_in, after step 2
  T* braw = reinterpret_cast<T*>(smem_raw + (bl + BT - smem_u32(smem_raw)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int nc = (S + Q - 1) / Q;
  const int h = ticket % H, c = ticket / H % nc, z = ticket / (H * nc);
  const int npt = (P + PT - 1) / PT;
  const int bi = z / npt, p0 = (z % npt) * PT;
  const int pv = min(PT, P - p0);
  const int g = h / (H / G);
  const int s0 = c * Q, qc = min(Q, S - s0);
  const int xstride = H * P, bstride = G * N;   // row strides
  const long long xoff = ((long long)bi * S + s0) * xstride + (long long)h * P + p0;
  const T* Bc = Bm + ((long long)bi * S + s0) * bstride + (long long)g * N;
  const T* Cc = Cm + ((long long)bi * S + s0) * bstride + (long long)g * N;
  const float* cbc = cb + (((long long)bi * G + g) * nc + c) * QP * QP;
  const int wg = warp / 4, wl = warp % 4;   // warpgroup, warp in it
  const int gr = lane >> 2, tc = 2 * (lane & 3);

  // raw rows k0 .. k0 + KB of B (zeros past qc), one commit group
  auto issue = [&](int k0) {
    for (int e = tid; e < KB * N / E; e += THREADS) {
      const int r = e / (N / E), n = (e % (N / E)) * E, j = k0 + r;
      cp_async16(smem_u32(braw + r * N + n),
                 j < qc ? Bc + j * bstride + n : Bc, j < qc);
    }
    cp_async_commit();
  };
  issue(0);

  // 1. the cumulative sum and w; x dt in two halves, each half's loads
  // all issued before its first split and store (one batch of all 16
  // float4 a thread spills past the 128 registers two blocks per SM allow)
  chunk_cumsum(dt + ((long long)bi * S + s0) * H + h, H, qc, A[h], cums,
               dts, wsum);
  wts[tid] = expf(cums[qc - 1] - cums[tid]);
  constexpr int XV = QMAX * PT / 4 / THREADS / 2;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 v[XV];
#pragma unroll
    for (int u = 0; u < XV; ++u) {
      const int e = tid + (u + half * XV) * THREADS;
      const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
      v[u] = (j < qc && q < pv) ? load4(x + xoff + j * xstride + q) : z4;
    }
#pragma unroll
    for (int u = 0; u < XV; ++u) {
      const int e = tid + (u + half * XV) * THREADS;
      const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
      store_split4_sw(xh, xl, sw128(j, q, QMAX), scale4(v[u], dts[j]));
    }
  }
  const float clast = cums[qc - 1];
  const int nr = (qc + 15) / 16 * 16;   // rows any k step reads

  // 2. S_c, warpgroup wg's 64 columns of N
  float sacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  const int ar = (lane & 7) + 8 * (lane >> 4), ac = 8 * ((lane >> 3) & 1);
  const int m0 = 16 * wl;   // this warp's rows of P
  for (int k0 = 0; k0 < qc; k0 += KB) {
    cp_async_wait<0>();
    __syncthreads();   // B's raw slice, the x dt tile and w are in place
    for (int e = tid; e < KB * N / E; e += THREADS) {
      const int r = e / (N / E), n = (e % (N / E)) * E;
      split_store16_sw(braw + r * N + n, bh, bl, r, n, KB, wts[k0 + r]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();   // the split slice is ready, the raw slice free
    if (k0 + KB < qc) issue(k0 + KB);
    if (wg < NB) {     // uniform across the warpgroup
#pragma unroll
      for (int st = 0; st < KB / 16; ++st) {
        uint32_t ah[4], al[4];
        const uint32_t ao = sw128(k0 + 16 * st + ar, m0 + ac, QMAX);
        ldsm_x4_t(ah, xh + ao);
        ldsm_x4_t(al, xl + ao);
        const uint32_t off = wg * KB * 128 + st * 16 * 128;
        reg_fence(sacc);
        wgmma_fence();
        wgmma_rs(sacc, al, sdesc(bh + off, KB * 128, 1024));
        wgmma_rs(sacc, ah, sdesc(bl + off, KB * 128, 1024));
        wgmma_rs(sacc, ah, sdesc(bh + off, KB * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
      }
      reg_fence(sacc);
    }
    __syncthreads();   // the split slice is rewritten by the next one
  }

  // 3. state passing
  int* flag = sync + 1 + ((long long)z * H + h) * nc + c;   // chunk c done
  if (c > 0) {
    if (tid == 0) {
      const volatile int* prev = flag - 1;
      while (*prev == 0) __nanosleep(100);
      __threadfence();
    }
    __syncthreads();
  }
  // states[bi][k][h] is the state entering chunk k + 1; chunk 0 enters
  // with init[bi][h] or, without it, with none (no state term). The last
  // chunk writes the final state into state_out
  auto entering = [&](int k) {
    return states + (((long long)bi * (nc - 1) + k) * H + h) * P * N +
           (long long)p0 * N;
  };
  const long long own = ((long long)bi * H + h) * P * N + (long long)p0 * N;
  const float* sin = c > 0 ? entering(c - 1) : init ? init + own : nullptr;
  const bool has_in = sin != nullptr;   // uniform across the block
  float* so = c + 1 < nc ? entering(c) : state_out + own;
  const float dec = expf(clast);
  // sacc[4 n + e]: row m0 + lane / 4 (+ 8 for e >= 2), column 64 wg + 8 n +
  // 2 (lane % 4) + e % 2
  if (wg < NB && m0 < pv) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * wg + 8 * n + tc;
      if (col >= N) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + gr + 8 * r, e = row * N + col;
        float2 v = make_float2(0.f, 0.f);
        if (has_in) {
          v = __ldcg(reinterpret_cast<const float2*>(sin + e));
          uint32_t hi, lo;
          split2(v.x, v.y, hi, lo);
          const uint32_t o = sw128(row, col, PT);
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(sh + o), "r"(hi)
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;" ::"r"(sl + o), "r"(lo)
                       : "memory");
        }
        store2(so + e, fmaf(v.x, dec, sacc[4 * n + 2 * r]),
               fmaf(v.y, dec, sacc[4 * n + 2 * r + 1]));
      }
    }
  }
  __threadfence();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();   // S_in split; the states written
  if (tid == 0 && c + 1 < nc) atomicExch(flag, 1);

  // 4. the outputs
  const int n64 = (qc + 63) / 64;           // 64-row tiles
  for (int r = 0; 2 * r < n64; ++r) {
    const int t = 2 * r + ((r & 1) ? 1 - wg : wg);
    if (t >= n64) continue;                 // uniform across the warpgroup
    const int ia = 64 * t + 16 * wl + gr, ib = ia + 8;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    uint32_t ah[2][4], al[2][4];   // A fragments, double-buffered

    if (has_in) {
      // C's fragments straight from global memory (each element is read by
      // one warp of the block)
      const float2 z2 = make_float2(0.f, 0.f);
      const T* pa = Cc + ia * bstride + tc;
      const T* pb = Cc + ib * bstride + tc;
      const bool va = ia < qc, vb = ib < qc;
      auto build_c = [&](int k0, uint32_t (&h4)[4], uint32_t (&l4)[4]) {
        const float2 v0 = va ? load2(pa + k0) : z2;
        const float2 v1 = vb ? load2(pb + k0) : z2;
        const float2 v2 = va ? load2(pa + k0 + 8) : z2;
        const float2 v3 = vb ? load2(pb + k0 + 8) : z2;
        split2(v0.x, v0.y, h4[0], l4[0]);
        split2(v1.x, v1.y, h4[1], l4[1]);
        split2(v2.x, v2.y, h4[2], l4[2]);
        split2(v3.x, v3.y, h4[3], l4[3]);
      };
      build_c(0, ah[0], al[0]);
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int b = kk & 1;
        const uint32_t off = (kk / 4) * PT * 128 + (kk % 4) * 32;
        reg_fence(acc);
        wgmma_fence();
        wgmma_rs<0>(acc, al[b], sdesc(sh + off, 16, 1024));
        wgmma_rs<0>(acc, ah[b], sdesc(sl + off, 16, 1024));
        wgmma_rs<0>(acc, ah[b], sdesc(sh + off, 16, 1024));
        wgmma_commit();
        if (kk + 1 < N / 16) {
          wgmma_wait<1>();
          build_c(16 * (kk + 1), ah[b ^ 1], al[b ^ 1]);
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      const float ea = expf(cums[ia]), eb = expf(cums[ib]);
#pragma unroll
      for (int e = 0; e < 32; e += 4) {
        acc[e] *= ea;
        acc[e + 1] *= ea;
        acc[e + 2] *= eb;
        acc[e + 3] *= eb;
      }
    }

    // intra-chunk product over the k steps of 16 key rows up to the tile's
    // last row (and below qc); the decay is selected, never multiplied
    const float ca = cums[ia], cbv = cums[ib];
    const float* ra = cbc + (long long)ia * QP + tc;
    const float* rb = cbc + (long long)ib * QP + tc;
    auto build_l = [&](int j0, uint32_t (&h4)[4], uint32_t (&l4)[4]) {
      const int j = j0 + tc;
      const float2 v0 = load2(ra + j0), v1 = load2(rb + j0);
      const float2 v2 = load2(ra + j0 + 8), v3 = load2(rb + j0 + 8);
      const float c0 = cums[j], c1 = cums[j + 1], c8 = cums[j + 8],
                  c9 = cums[j + 9];
      auto dec = [&](float v, int i, float ci, int jj, float cjj) {
        return (jj <= i && jj < qc) ? v * __expf(ci - cjj) : 0.f;
      };
      split2(dec(v0.x, ia, ca, j, c0), dec(v0.y, ia, ca, j + 1, c1), h4[0],
             l4[0]);
      split2(dec(v1.x, ib, cbv, j, c0), dec(v1.y, ib, cbv, j + 1, c1), h4[1],
             l4[1]);
      split2(dec(v2.x, ia, ca, j + 8, c8), dec(v2.y, ia, ca, j + 9, c9),
             h4[2], l4[2]);
      split2(dec(v3.x, ib, cbv, j + 8, c8), dec(v3.y, ib, cbv, j + 9, c9),
             h4[3], l4[3]);
    };
    // k step kk with the A fragments (hc, lc); then, if more follow, the
    // next step's fragments into (hn, ln) once step kk - 1 (their last
    // reader) has completed. Unrolled by two so that no register array is
    // indexed at run time; the last step waits for all.
    const int nk = min(4 * (t + 1), nr / 16);
    auto mma3 = [&](int kk, const uint32_t (&hc)[4], const uint32_t (&lc)[4]) {
      const uint32_t off = kk * 16 * 128;
      reg_fence(acc);
      wgmma_fence();
      wgmma_rs(acc, lc, sdesc(xh + off, XT_BYTES, 1024));
      wgmma_rs(acc, hc, sdesc(xl + off, XT_BYTES, 1024));
      wgmma_rs(acc, hc, sdesc(xh + off, XT_BYTES, 1024));
      wgmma_commit();
    };
    auto step = [&](int kk, const uint32_t (&hc)[4], const uint32_t (&lc)[4],
                    uint32_t (&hn)[4], uint32_t (&ln)[4]) {
      mma3(kk, hc, lc);
      wgmma_wait<1>();
      build_l(16 * (kk + 1), hn, ln);
    };
    build_l(0, ah[0], al[0]);
    int kk = 0;
    for (; kk + 2 < nk; kk += 2) {
      step(kk, ah[0], al[0], ah[1], al[1]);
      step(kk + 1, ah[1], al[1], ah[0], al[0]);
    }
    if (kk + 1 < nk) {
      step(kk, ah[0], al[0], ah[1], al[1]);
      mma3(kk + 1, ah[1], al[1]);
    } else {
      mma3(kk, ah[0], al[0]);
    }
    wgmma_wait<0>();
    reg_fence(acc);

    // acc[4 n + e]: row ia (e < 2) or ib, column 8 n + tc + e % 2
    T* yc = y + xoff;
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      if (8 * n >= pv) break;
      if (ia < qc) store2(yc + ia * xstride + 8 * n + tc, acc[4 * n], acc[4 * n + 1]);
      if (ib < qc)
        store2(yc + ib * xstride + 8 * n + tc, acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* cb, void* states, void* sync,
           const void* init, void* y, void* state, int b, int S, int H,
           int P, int G, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, ntq = (Q + CT - 1) / CT, QP = ntq * CT;
  const int npt = (P + PT - 1) / PT;
  cudaError_t err;
  if ((err = set_smem(ssd_cb_kernel<T, N>, cb_smem_bytes<N>())) ||
      (err = set_smem(ssd_chunk_kernel<T, N>, chunk_smem_bytes<T, N>())))
    return (int)err;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* cbf = static_cast<float*>(cb);
  float* stf = static_cast<float*>(states);

  ssd_cb_kernel<T, N><<<dim3(ntq * (ntq + 1) / 2, nc, b * G), CB_THREADS,
                        cb_smem_bytes<N>(), stream>>>(Bt, Ct, cbf, S, G, Q,
                                                      QP, nc);
  if ((err = cudaGetLastError())) return (int)err;
  int* syncp = static_cast<int*>(sync);
  if ((err = cudaMemsetAsync(syncp, 0, (1 + (size_t)b * npt * H * nc) * sizeof(int),
                             stream)))
    return (int)err;
  ssd_chunk_kernel<T, N><<<dim3(H, nc, b * npt), THREADS,
                           chunk_smem_bytes<T, N>(), stream>>>(
      xt, dtf, Af, Bt, Ct, cbf, stf, syncp, static_cast<const float*>(init),
      static_cast<T*>(y),
      static_cast<float*>(state), S, H, P, G, Q, QP);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* cb, void* states, void* sync,
             const void* init, void* y, void* state, int b, int S, int H,
             int P, int G, int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16:
      return launch<T, 16>(x, dt, A, B, C, cb, states, sync, init, y, state,
                           b, S, H, P, G, Q, s);
    case 32:
      return launch<T, 32>(x, dt, A, B, C, cb, states, sync, init, y, state,
                           b, S, H, P, G, Q, s);
    case 128:
      return launch<T, 128>(x, dt, A, B, C, cb, states, sync, init, y, state,
                            b, S, H, P, G, Q, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b, S, H, P) and y (b, S, H, P) of type dtype (0 = float32, 1 =
// bfloat16), dt (b, S, H) and A (H,) float32, B and C (b, S, G, N) of type
// dtype, state (b, H, P, N) float32; init null (a zero state) or (b, H,
// P, N) float32, the state entering the first chunk; all contiguous and
// 16-byte aligned.
// Scratch: cb of b * G * nc * QP^2 floats (nc = ceil(S / Q), QP = Q
// rounded up to a multiple of 64), states of b * (nc - 1) * H * P * N
// floats (none at nc = 1), sync of 1 + b * ceil(P / 64) * H * nc ints
// (zeroed here). Needs
// P % 16 == 0, N in {16, 32, 128} (the Pallas tests' and mamba2-2.7b's), G
// dividing H and 1 <= Q <= 256. Launches the passes in order on the
// stream; returns the first CUDA error (0 = success).
extern "C" int repro_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* cb, void* states,
                         void* sync, const void* init, void* y, void* state,
                         int b, int S, int H, int P, int G, int N, int Q,
                         int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 != 0 || G <= 0 ||
      H % G != 0 || Q <= 0 || Q > QMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dt, A, B, C, cb, states, sync, init, y, state,
                           b, S, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, A, B, C, cb, states, sync, init, y,
                                   state, b, S, H, P, G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
