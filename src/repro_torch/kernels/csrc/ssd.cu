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
//
// The backward (the scan's vector-Jacobian product, repro_ssd_bwd) follows
// the forward's launcher, with its own note.
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


// ===========================================================================
// The backward: the scan's vector-Jacobian product
// ===========================================================================
//
// Replaces no TPU kernel: the JAX package's Pallas SSD kernel has no VJP
// (the JAX model differentiates its jnp chunked scan), so this is new
// work on the port. It computes autograd of ssd_chunked_ref
// (kernels/ssd/ref.py), which stays the definition; ref.ssd_chunked_vjp_ref
// is the same passes in plain PyTorch. Per (batch row, head, chunk c), with
// xdt = x dt, cums as in the forward, L[q][s] = exp(cums_q - cums_s) for
// s <= q, seg_s = exp(cums_last - cums_s), S_c the state entering chunk c,
// dy = dL/dy and dS_nc = dL/d(final state) (zero without one):
//
//   dS_c    = exp(cums_last) dS_{c+1} + sum_q exp(cums_q) dy_q C_q^T
//   dxdt_s  = sum_{q >= s} (C_q . B_s) L[q][s] dy_q + seg_s dS_{c+1} B_s
//   dCB_qs  = sum_{h of the group} L_h[q][s] (dy_hq . xdt_hs)
//   dC_q    = sum_s dCB_qs B_s + sum_h exp(cums_hq) S_{c,h}^T dy_hq
//   dB_s    = sum_q dCB_qs C_q + sum_h seg_hs dS_{c+1,h}^T xdt_hs
//
// and dx = dxdt dt. The cumulative sums' gradient collects four terms: L's
// (row sums of M = C.B^T o L o dy.xdt^T less its column sums), y's state
// term, the chunk state's weights seg and the chunk's decay:
//
//   dcums_k = rowsum(M)_k - colsum(M)_k + exp(cums_k) dy_k . (C_k S_c^T)
//           - g_k + [k = last] (sum_s g_s + exp(cums_last) <dS_{c+1}, S_c>)
//
// with g_s = xdt_s . (seg_s dS_{c+1} B_s), the state part of dxdt. Both
// sums of M come from the same products, and the last row's seg term from
// the same g: in d(dt A), dcums's reverse cumulative sum within the chunk,
// they cancel as autograd's do, where taking either from another product
// would leave that product's rounding (under a strong decay, 100x the
// plain backward's error in dA). ddt = x . dxdt + A d(dt A), dA = sum dt
// d(dt A) and d(initial state) = dS_0.
//
// Bound. At mamba2-2.7b's training cell, (4, 1,024, 80, 64), N 128, chunk
// 256, the product reads x, dt, A, B, C and dy and writes dx, ddt, dA, dB
// and dC: 430 MB in float32, 0.128 ms at 3.35 TB/s; its 29.8 GFLOP as three
// bf16 products take 0.090 ms at 989 TFLOP/s. So it is bound by bytes.
// Every product runs on the tensor cores as the forward's (three wgmma
// m64n64k16 on a bf16 hi/lo split, float32 accumulators; never one bf16 or
// TF32 pass), in five chunk-parallel passes whose scratch stays in tens of
// MB: the forward's C.B^T and entering states are reused, nothing of (b,
// nc, H, Q, Q) is formed. What keeps it above the bound (PERF.md has the
// times): the passes read dy and x more than once, stage every tile
// through shared memory before they multiply (the loads are latency-bound:
// passes 3 and 4 overlap them with the products, 4 by a ring three k
// blocks deep, 3 by four blocks an SM), and the reverse state passing runs
// chunk after chunk:
//
//   1. ssd_bwd_state_kernel, per (b, 64 of P, h, c), from the last chunk
//      to the first by an atomic ticket: each chunk's cumulative sums into
//      a scratch, sum_q exp(cums_q) dy_q C_q^T (the forward's state
//      product), then dS passed back through done-flags; dS_{c+1} of every
//      chunk into a scratch (b, nc, H, P, N), dS_0 into d(initial state).
//   2. ssd_bwd_dx_kernel, per (b, h, c, 64 of P): y's state term against
//      dy, exp(cums_last) <dS_{c+1}, S_c>, dxdt, g, dx and x . dxdt;
//      partial sums per 64 of P.
//   3. ssd_bwd_dcb_kernel, per (b, group, c, 64 x 64 tile at or below the
//      diagonal, a quarter of the group's heads): dCB summed over the
//      heads in order, and each head's row and column sums of M; dCB into
//      a scratch (b, G, parts, nc, QP, QP), the parts added in order by
//      pass 4.
//   4. ssd_bwd_dbc_kernel, per (b, group, c, 64 rows, dB or dC): the dCB
//      product, then the state product over every (head, 64 of P).
//   5. ssd_bwd_decay_kernel, per head: dcums, d(dt A), ddt, and dA summed
//      over batch rows and chunks in order.
//
// Every sum runs in a fixed order (no float atomics), so two calls on the
// same inputs give the same bits. Every decay is exp of a difference of
// cumulative sums, selected before the exp is used, as the forward's.

// wgmma m64n64k16, both operands in shared memory: A K-major, B K-major
// (TB = 0) or MN-major (TB = 1: a [k][n] tile, as wgmma_rs reads it)
template <int TB>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d += A . B over one k block of 64: A a K-major 64 x 64 split tile
// ([m][k]), B a K-major ([n][k], TB = 0) or MN-major ([k][n], TB = 1)
// split tile of 64 rows; al bh + ah bl + ah bh per k step. The caller
// fences before and commits and waits after.
template <int TB>
__device__ __forceinline__ void mma_kblock(float (&d)[32], uint32_t ah,
                                           uint32_t al, uint32_t bh,
                                           uint32_t bl) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t ao = kk * 32, bo = TB ? kk * 16 * 128 : kk * 32;
    const uint32_t lbo = TB ? CT * 128 : 16;
    wgmma_ss_t<TB>(d, sdesc(al + ao, 16, 1024), sdesc(bh + bo, lbo, 1024));
    wgmma_ss_t<TB>(d, sdesc(ah + ao, 16, 1024), sdesc(bl + bo, lbo, 1024));
    wgmma_ss_t<TB>(d, sdesc(ah + ao, 16, 1024), sdesc(bh + bo, lbo, 1024));
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// ---------------------------------------------------------------------------
// 1. reverse state passing
// ---------------------------------------------------------------------------

// One (head, chunk, b * npt + P tile) per block of two warpgroups, the
// chunks from the last by an atomic ticket (sync[0]):
//   1. the chunk's cumulative sum (into cums_out from the P tile at 0).
//   2. D = sum_q exp(cums_q) dy_q C_q^T (rows of P, columns of N): the
//      forward's state product with exp(cums) dy in place of x dt and C in
//      place of w o B. Chunk 0 skips it without an initial state (nothing
//      reads dS_0 then).
//   3. Wait for chunk c + 1's flag, read dS_{c+1} (the last chunk: gstate
//      or zero, copied into its slot), write dS_c = exp(cums_last) dS_{c+1}
//      + D into slot c - 1 (chunk 0: into dinit) and raise this chunk's
//      flag. Slot k of dst holds dS_{k+1}.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_state_kernel(const T* __restrict__ dy, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Cm,
                     const float* __restrict__ gstate,
                     float* __restrict__ cums_out, float* __restrict__ dst,
                     int* __restrict__ sync, float* __restrict__ dinit, int S,
                     int H, int P, int G, int Q, int QP) {
  constexpr int NB = (N + 63) / 64;
  constexpr int BT = box_bytes<N>(KB);
  constexpr int E = 16 / (int)sizeof(T);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float cums[QMAX], dts[QMAX], wts[QMAX], wsum[WARPS];
  __shared__ int ticket;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t yh = base, yl = yh + XT_BYTES;   // exp(cums) dy
  const uint32_t ch = yl + XT_BYTES, cl = ch + BT;  // C, one slice
  T* craw = reinterpret_cast<T*>(smem_raw + (cl + BT - smem_u32(smem_raw)));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int nc = (S + Q - 1) / Q;
  const int h = ticket % H, c = nc - 1 - ticket / H % nc,
            z = ticket / (H * nc);
  const int npt = (P + PT - 1) / PT;
  const int bi = z / npt, p0 = (z % npt) * PT;
  const int pv = min(PT, P - p0);
  const int g = h / (H / G);
  const int s0 = c * Q, qc = min(Q, S - s0);
  const int xstride = H * P, bstride = G * N;
  const long long yoff =
      ((long long)bi * S + s0) * xstride + (long long)h * P + p0;
  const T* Cc = Cm + ((long long)bi * S + s0) * bstride + (long long)g * N;
  const int wg = warp / 4, wl = warp % 4;
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const bool last = c + 1 == nc;
  const bool local = c > 0 || dinit != nullptr;   // uniform across the grid

  auto issue = [&](int k0) {   // raw rows k0 .. k0 + KB of C, one group
    for (int e = tid; e < KB * N / E; e += THREADS) {
      const int r = e / (N / E), n = (e % (N / E)) * E, j = k0 + r;
      cp_async16(smem_u32(craw + r * N + n),
                 j < qc ? Cc + j * bstride + n : Cc, j < qc);
    }
    cp_async_commit();
  };
  if (local) issue(0);

  chunk_cumsum(dt + ((long long)bi * S + s0) * H + h, H, qc, A[h], cums,
               dts, wsum);
  if (p0 == 0 && tid < QP)
    cums_out[(((long long)bi * nc + c) * H + h) * QP + tid] = cums[tid];
  if (!local && !last) return;   // chunk 0 without an initial state

  float sacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sacc[e] = 0.f;
  const int m0 = 16 * wl;   // this warp's rows of P
  if (local) {
    wts[tid] = expf(cums[tid]);
    __syncthreads();
    constexpr int XV = QMAX * PT / 4 / THREADS / 2;
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 v[XV];
#pragma unroll
      for (int u = 0; u < XV; ++u) {
        const int e = tid + (u + half * XV) * THREADS;
        const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
        v[u] = (j < qc && q < pv) ? load4(dy + yoff + j * xstride + q) : z4;
      }
#pragma unroll
      for (int u = 0; u < XV; ++u) {
        const int e = tid + (u + half * XV) * THREADS;
        const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
        store_split4_sw(yh, yl, sw128(j, q, QMAX), scale4(v[u], wts[j]));
      }
    }
    const int ar = (lane & 7) + 8 * (lane >> 4), ac = 8 * ((lane >> 3) & 1);
    for (int k0 = 0; k0 < qc; k0 += KB) {
      cp_async_wait<0>();
      __syncthreads();   // C's raw slice and the dy tile are in place
      for (int e = tid; e < KB * N / E; e += THREADS) {
        const int r = e / (N / E), n = (e % (N / E)) * E;
        split_store16_sw(craw + r * N + n, ch, cl, r, n, KB, 1.f);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();   // the split slice is ready, the raw slice free
      if (k0 + KB < qc) issue(k0 + KB);
      if (wg < NB) {     // uniform across the warpgroup
#pragma unroll
        for (int st = 0; st < KB / 16; ++st) {
          uint32_t ah[4], al[4];
          const uint32_t ao = sw128(k0 + 16 * st + ar, m0 + ac, QMAX);
          ldsm_x4_t(ah, yh + ao);
          ldsm_x4_t(al, yl + ao);
          const uint32_t off = wg * KB * 128 + st * 16 * 128;
          reg_fence(sacc);
          wgmma_fence();
          wgmma_rs(sacc, al, sdesc(ch + off, KB * 128, 1024));
          wgmma_rs(sacc, ah, sdesc(cl + off, KB * 128, 1024));
          wgmma_rs(sacc, ah, sdesc(ch + off, KB * 128, 1024));
          wgmma_commit();
          wgmma_wait<0>();
        }
        reg_fence(sacc);
      }
      __syncthreads();   // the split slice is rewritten by the next one
    }
  }

  // 3. the passing, from chunk c + 1 to chunk c
  int* flag = sync + 1 + ((long long)z * H + h) * nc + c;   // dS_c written
  if (!last) {
    if (tid == 0) {
      const volatile int* next = flag + 1;
      while (*next == 0) __nanosleep(100);
      __threadfence();
    }
    __syncthreads();
  }
  auto slot = [&](int k) {
    return dst + (((long long)bi * nc + k) * H + h) * P * N +
           (long long)p0 * N;
  };
  const long long own = ((long long)bi * H + h) * P * N + (long long)p0 * N;
  const float* din = last ? (gstate ? gstate + own : nullptr) : slot(c);
  float* copy = last ? slot(c) : nullptr;
  float* dout = c > 0 ? slot(c - 1) : local ? dinit + own : nullptr;
  const float dec = expf(cums[qc - 1]);
  // sacc[4 n + e]: row m0 + lane / 4 (+ 8 for e >= 2), column 64 wg + 8 n +
  // 2 (lane % 4) + e % 2
  if (wg < NB && m0 < pv) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * wg + 8 * n + tc;
      if (col >= N) break;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = (m0 + gr + 8 * r) * N + col;
        float2 v = make_float2(0.f, 0.f);
        if (din) v = __ldcg(reinterpret_cast<const float2*>(din + e));
        if (copy) store2(copy + e, v.x, v.y);
        if (dout)
          store2(dout + e, fmaf(v.x, dec, sacc[4 * n + 2 * r]),
                 fmaf(v.y, dec, sacc[4 * n + 2 * r + 1]));
      }
    }
  }
  __threadfence();
  __syncthreads();   // dS_c written
  if (tid == 0 && c > 0) atomicExch(flag, 1);
}

// ---------------------------------------------------------------------------
// 2. dxdt, dx and the row terms of the decay
// ---------------------------------------------------------------------------

template <typename T, int N>
constexpr size_t dx_smem_bytes() {
  return 1024 + 2 * (size_t)XT_BYTES + 2 * (size_t)box_bytes<N>(PT);
}

// One (head, chunk, b * npt + P tile) per block of two warpgroups, each
// owning 64-row tiles of the chunk (tiles wg and 3 - wg). dy of the chunk
// is split into a [q][p] tile; a state (64 rows of P, N) into a K-major
// [p][n] tile in turn:
//   1. With a state entering the chunk (chunk > 0 or an initial state):
//      y's state term C . S_c^T, as the forward forms it, against dy:
//      ypart[0][q] = exp(cums_q) sum_p dy_qp (C_q . S_c,p); and (staging
//      S_c) dot = exp(cums_last) <dS_{c+1}, S_c>.
//   2. dS_{c+1} (slot c).
//   3. dxdt = seg_s B_s . dS_{c+1}^T + sum_{q >= s} W[s][q] dy_q, W[s][q]
//      = (C.B^T)[q][s] exp(cums_q - cums_s) built in registers from the
//      forward's C.B^T scratch; ypart[1][s] = g_s = xdt_s . (its first
//      term), dx = dxdt dt, rpart[s] = x_s . dxdt_s.
// The partial sums are this tile of P's; pass 5 sums them in order.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 2)
ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const T* __restrict__ dy, const float* __restrict__ cb,
                  const float* __restrict__ states,
                  const float* __restrict__ init,
                  const float* __restrict__ state_out,
                  const float* __restrict__ dst,
                  const float* __restrict__ cums_in, T* __restrict__ dx,
                  float* __restrict__ rpart, float* __restrict__ ypart,
                  float* __restrict__ dot, int S, int H, int P, int G, int Q,
                  int QP, int has_gs) {
  constexpr int SB = box_bytes<N>(PT);   // a split state tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float cums[QMAX], dts[QMAX], ec[QMAX], seg[QMAX], red[WARPS];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t yh = base, yl = yh + XT_BYTES;    // dy
  const uint32_t sh = yl + XT_BYTES, sl = sh + SB;  // a state

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4, wl = warp % 4;
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const int h = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int npt = (P + PT - 1) / PT;
  const int bi = (int)blockIdx.z / npt, pt = (int)blockIdx.z % npt;
  const int p0 = pt * PT, pv = min(PT, P - p0);
  const int g = h / (H / G);
  const int s0 = c * Q, qc = min(Q, S - s0);
  const int xstride = H * P, bstride = G * N;
  const long long xoff =
      ((long long)bi * S + s0) * xstride + (long long)h * P + p0;
  const T* Bc = Bm + ((long long)bi * S + s0) * bstride + (long long)g * N;
  const T* Cc = Cm + ((long long)bi * S + s0) * bstride + (long long)g * N;
  const float* cbc = cb + (((long long)bi * G + g) * nc + c) * QP * QP;
  const long long bch = ((long long)bi * nc + c) * H + h;
  const long long hs = ((long long)bi * H + h) * P * N + (long long)p0 * N;
  const long long part = (bch * npt + pt) * QP;           // rpart
  const long long ypart0 = (bch * 2 * npt + pt) * QP;      // ypart[0]
  const long long ypart1 = ((bch * 2 + 1) * npt + pt) * QP;   // ypart[1]

  cums[tid] = tid < QP ? cums_in[bch * QP + tid] : 0.f;
  dts[tid] = tid < qc ? dt[((long long)bi * S + s0 + tid) * H + h] : 0.f;
  __syncthreads();
  const float clast = cums[qc - 1];
  ec[tid] = expf(cums[tid]);
  seg[tid] = expf(clast - cums[tid]);

  // dy of the chunk, [q][p]; each half's loads issued before its stores
  constexpr int XV = QMAX * PT / 4 / THREADS / 2;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float4 v[XV];
#pragma unroll
    for (int u = 0; u < XV; ++u) {
      const int e = tid + (u + half * XV) * THREADS;
      const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
      v[u] = (j < qc && q < pv) ? load4(dy + xoff + j * xstride + q) : z4;
    }
#pragma unroll
    for (int u = 0; u < XV; ++u) {
      const int e = tid + (u + half * XV) * THREADS;
      const int j = e / (PT / 4), q = (e % (PT / 4)) * 4;
      store_split4_sw(yh, yl, sw128(j, q, QMAX), v[u]);
    }
  }

  // rows p0 .. p0 + 63 of a (P, N) state, split K-major ([p][n]); with
  // `with`, also its inner product with the same rows of `with`
  auto stage_state = [&](const float* sp, const float* with) {
    float acc = 0.f;
    for (int e = tid; e < PT * N / 4; e += THREADS) {
      const int r = e / (N / 4), n = (e % (N / 4)) * 4;
      float4 v = z4;
      if (r < pv) {
        v = load4(sp + (long long)r * N + n);
        if (with) acc += dot4(v, load4(with + (long long)r * N + n));
      }
      store_split4_sw(sh, sl, sw128(r, n, PT), v);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    return acc;
  };

  // acc = Am . S^T for rows ia, ib of Am (a (b, S, G, N) input read from
  // global memory) against the staged state: A from registers, B K-major
  auto state_term = [&](const T* Am_, int ia, int ib, float (&acc)[32]) {
    const float2 z2 = make_float2(0.f, 0.f);
    const T* pa = Am_ + (long long)ia * bstride + tc;
    const T* pb = Am_ + (long long)ib * bstride + tc;
    const bool va = ia < qc, vb = ib < qc;
    uint32_t ah[2][4], al[2][4];
    auto build = [&](int k0, uint32_t (&h4)[4], uint32_t (&l4)[4]) {
      const float2 v0 = va ? load2(pa + k0) : z2;
      const float2 v1 = vb ? load2(pb + k0) : z2;
      const float2 v2 = va ? load2(pa + k0 + 8) : z2;
      const float2 v3 = vb ? load2(pb + k0 + 8) : z2;
      split2(v0.x, v0.y, h4[0], l4[0]);
      split2(v1.x, v1.y, h4[1], l4[1]);
      split2(v2.x, v2.y, h4[2], l4[2]);
      split2(v3.x, v3.y, h4[3], l4[3]);
    };
    build(0, ah[0], al[0]);
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
        build(16 * (kk + 1), ah[b ^ 1], al[b ^ 1]);
      }
    }
    wgmma_wait<0>();
    reg_fence(acc);
  };

  const int n64 = (qc + 63) / 64;           // 64-row tiles
  const int nr = (qc + 15) / 16 * 16;       // rows any k step reads
  const bool has_in = c > 0 || init != nullptr;
  const bool has_ds = c + 1 < nc || has_gs;

  const float* dsn =   // dS_{c+1}, this tile of P
      dst + (((long long)bi * nc + c) * H + h) * P * N + (long long)p0 * N;
  // 1. y's state term against dy; <dS_{c+1}, S_c>
  float dv = 0.f;
  if (has_in) {
    dv = stage_state(c > 0 ? states + (((long long)bi * (nc - 1) + c - 1) *
                                       H + h) * P * N + (long long)p0 * N
                           : init + hs,
                     has_ds ? dsn : nullptr);
    for (int r = 0; 2 * r < n64; ++r) {
      const int t = 2 * r + ((r & 1) ? 1 - wg : wg);
      if (t >= n64) continue;               // uniform across the warpgroup
      const int ia = 64 * t + 16 * wl + gr, ib = ia + 8;
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      state_term(Cc, ia, ib, acc);
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int n = 0; n < PT / 8; ++n) {
        if (8 * n >= pv) break;
        const int col = 8 * n + tc;
        if (ia < qc) {
          const float2 d = load2(dy + xoff + (long long)ia * xstride + col);
          va += acc[4 * n] * d.x + acc[4 * n + 1] * d.y;
        }
        if (ib < qc) {
          const float2 d = load2(dy + xoff + (long long)ib * xstride + col);
          vb += acc[4 * n + 2] * d.x + acc[4 * n + 3] * d.y;
        }
      }
      va += __shfl_xor_sync(0xffffffffu, va, 1);
      va += __shfl_xor_sync(0xffffffffu, va, 2);
      vb += __shfl_xor_sync(0xffffffffu, vb, 1);
      vb += __shfl_xor_sync(0xffffffffu, vb, 2);
      if ((lane & 3) == 0) {
        if (ia < qc) ypart[ypart0 + ia] = va * ec[ia];
        if (ib < qc) ypart[ypart0 + ib] = vb * ec[ib];
      }
    }
    __syncthreads();   // the state tile is rewritten below
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dv += __shfl_xor_sync(0xffffffffu, dv, o);
  if (lane == 0) red[warp] = dv;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    dot[bch * npt + pt] = s * expf(clast);
  }

  // 2. dS_{c+1}
  if (has_ds) stage_state(dsn, nullptr);

  // 3. dxdt, dx, x . dxdt
  for (int r = 0; 2 * r < n64; ++r) {
    const int t = 2 * r + ((r & 1) ? 1 - wg : wg);
    if (t >= n64) continue;                 // uniform across the warpgroup
    const int ia = 64 * t + 16 * wl + gr, ib = ia + 8;
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    float ga = 0.f, gb = 0.f;   // g: xdt . the state part of dxdt
    if (has_ds) {
      state_term(Bc, ia, ib, acc);
      const float sa = seg[ia], sb = seg[ib];
#pragma unroll
      for (int e = 0; e < 32; e += 4) {
        acc[e] *= sa;
        acc[e + 1] *= sa;
        acc[e + 2] *= sb;
        acc[e + 3] *= sb;
      }
#pragma unroll
      for (int n = 0; n < PT / 8; ++n) {
        if (8 * n >= pv) break;
        const int col = 8 * n + tc;
        if (ia < qc) {
          const float2 xv = load2(x + xoff + (long long)ia * xstride + col);
          ga += xv.x * acc[4 * n] + xv.y * acc[4 * n + 1];
        }
        if (ib < qc) {
          const float2 xv = load2(x + xoff + (long long)ib * xstride + col);
          gb += xv.x * acc[4 * n + 2] + xv.y * acc[4 * n + 3];
        }
      }
    }
    ga += __shfl_xor_sync(0xffffffffu, ga, 1);
    ga += __shfl_xor_sync(0xffffffffu, ga, 2);
    gb += __shfl_xor_sync(0xffffffffu, gb, 1);
    gb += __shfl_xor_sync(0xffffffffu, gb, 2);
    if ((lane & 3) == 0) {
      if (ia < qc) ypart[ypart1 + ia] = ga * dts[ia];
      if (ib < qc) ypart[ypart1 + ib] = gb * dts[ib];
    }

    // the intra-chunk product over the k steps of 16 rows q from the
    // tile's first row (and below qc); the decay is selected, never
    // multiplied. Step kk's C.B^T values (q = 16 kk + tc + {0, 1, 8, 9},
    // s = ia, ib; all in tiles the forward wrote) are loaded while the
    // step before it runs.
    const float ca = cums[ia], cbv = cums[ib];
    auto load_w = [&](int kk, float (&v)[8]) {
      const float* p = cbc + (long long)(16 * kk + tc) * QP;
      v[0] = p[ia];
      v[1] = p[QP + ia];
      v[2] = p[ib];
      v[3] = p[QP + ib];
      v[4] = p[8 * QP + ia];
      v[5] = p[9 * QP + ia];
      v[6] = p[8 * QP + ib];
      v[7] = p[9 * QP + ib];
    };
    auto build_w = [&](int kk, const float (&v)[8], uint32_t (&h4)[4],
                       uint32_t (&l4)[4]) {
      const int j = 16 * kk + tc;
      const float c0 = cums[j], c1 = cums[j + 1], c8 = cums[j + 8],
                  c9 = cums[j + 9];
      auto w = [&](float u, int s, float cs, int q, float cq) {
        return (q >= s && q < qc) ? u * __expf(cq - cs) : 0.f;
      };
      split2(w(v[0], ia, ca, j, c0), w(v[1], ia, ca, j + 1, c1), h4[0],
             l4[0]);
      split2(w(v[2], ib, cbv, j, c0), w(v[3], ib, cbv, j + 1, c1), h4[1],
             l4[1]);
      split2(w(v[4], ia, ca, j + 8, c8), w(v[5], ia, ca, j + 9, c9), h4[2],
             l4[2]);
      split2(w(v[6], ib, cbv, j + 8, c8), w(v[7], ib, cbv, j + 9, c9),
             h4[3], l4[3]);
    };
    uint32_t ah[2][4], al[2][4];
    float vn[8];
    auto mma3 = [&](int kk, const uint32_t (&hc)[4], const uint32_t (&lc)[4]) {
      const uint32_t off = kk * 16 * 128;
      reg_fence(acc);
      wgmma_fence();
      wgmma_rs(acc, lc, sdesc(yh + off, XT_BYTES, 1024));
      wgmma_rs(acc, hc, sdesc(yl + off, XT_BYTES, 1024));
      wgmma_rs(acc, hc, sdesc(yh + off, XT_BYTES, 1024));
      wgmma_commit();
    };
    auto step = [&](int kk, const uint32_t (&hc)[4], const uint32_t (&lc)[4],
                    uint32_t (&hn)[4], uint32_t (&ln)[4]) {
      mma3(kk, hc, lc);
      load_w(kk + 1, vn);
      wgmma_wait<1>();
      build_w(kk + 1, vn, hn, ln);
    };
    const int nk = nr / 16;
    int kk = 4 * t;
    load_w(kk, vn);
    build_w(kk, vn, ah[0], al[0]);
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
    float ra = 0.f, rb = 0.f;
#pragma unroll
    for (int n = 0; n < PT / 8; ++n) {
      if (8 * n >= pv) break;
      const int col = 8 * n + tc;
      if (ia < qc) {
        const long long o = xoff + (long long)ia * xstride + col;
        const float2 xv = load2(x + o);
        store2(dx + o, acc[4 * n] * dts[ia], acc[4 * n + 1] * dts[ia]);
        ra += xv.x * acc[4 * n] + xv.y * acc[4 * n + 1];
      }
      if (ib < qc) {
        const long long o = xoff + (long long)ib * xstride + col;
        const float2 xv = load2(x + o);
        store2(dx + o, acc[4 * n + 2] * dts[ib], acc[4 * n + 3] * dts[ib]);
        rb += xv.x * acc[4 * n + 2] + xv.y * acc[4 * n + 3];
      }
    }
    ra += __shfl_xor_sync(0xffffffffu, ra, 1);
    ra += __shfl_xor_sync(0xffffffffu, ra, 2);
    rb += __shfl_xor_sync(0xffffffffu, rb, 1);
    rb += __shfl_xor_sync(0xffffffffu, rb, 2);
    if ((lane & 3) == 0) {
      if (ia < qc) rpart[part + ia] = ra;
      if (ib < qc) rpart[part + ib] = rb;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dCB per (batch row, group, chunk), summed over the group's heads
// ---------------------------------------------------------------------------

constexpr int DCB_THREADS = 128;   // one warpgroup
constexpr int TILE_BYTES = CT * 128;   // a 64 x 64 split tile (hi or lo)
constexpr int DCB_SPLIT = 4;   // blocks a group's heads are cut into

// the parts a group's heads are summed in: min(DCB_SPLIT, heads a group)
__host__ __device__ __forceinline__ int dcb_parts(int H, int G) {
  return H / G < DCB_SPLIT ? H / G : DCB_SPLIT;
}

constexpr size_t dcb_smem_bytes() { return 1024 + 4 * (size_t)TILE_BYTES; }

// One 64 x 64 tile (qt, st) at or below the chunk's diagonal and one part
// of the group's heads (a run of H / G / parts) per block: grid (ntq (ntq
// + 1) / 2 tiles, nc chunks, b * G * parts), four blocks an SM. For each
// head of the part in order and each 64 columns of P: dy's rows of the
// tile and xdt's columns are split into K-major tiles ([q][p], [s][p]) and
// multiplied on wgmma (both from shared memory). Each head's dy . xdt^T is
// decayed by L (selected: s <= q < qc), added to the part's sum, and its M
// = C.B^T o (L o dy.xdt^T) summed over the tile's columns and over its
// rows into msum (rows of a head's tiles are summed in pass 5, as are
// columns). Below the diagonal every q of the tile is past every s, so L =
// exp(cums_q - cums_r) exp(cums_r - cums_s) with r the s tile's last row:
// both differences of cumulative sums, 128 exps a head instead of 4,096.
// The part's sum is written to dcb, zeros above the diagonal and past qc
// (pass 4 adds the parts in order); tiles wholly past qc are not written.
template <typename T>
__global__ void __launch_bounds__(DCB_THREADS, 4)
ssd_bwd_dcb_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ dy, const float* __restrict__ cb,
                   const float* __restrict__ cums, float* __restrict__ dcb,
                   float* __restrict__ msum, int S, int H, int P, int G,
                   int Q, int QP, int nc) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float colw[DCB_THREADS / 32][CT];   // column sums by warp
  __shared__ float frow[CT], fcol[CT];   // a head's decay factors
  const uint32_t yh = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t yl = yh + TILE_BYTES, xh = yl + TILE_BYTES,
                 xl = xh + TILE_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int st = (int)blockIdx.x - qt * (qt + 1) / 2;
  const int parts = dcb_parts(H, G);
  const int c = blockIdx.y, bg = (int)blockIdx.z / parts,
            part = (int)blockIdx.z % parts;
  const int bi = bg / G, g = bg % G;
  const int s0 = c * Q, qc = min(Q, S - s0);
  if (qt * CT >= qc) return;   // uniform across the block
  const bool diag = qt == st;
  const int hg = H / G, npb = (P + 63) / 64, ntq = QP / CT;
  const int h0 = g * hg + part * hg / parts,
            h1 = g * hg + (part + 1) * hg / parts;   // this part's heads
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const int qa = qt * CT + 16 * warp + gr, qb = qa + 8;   // this thread's rows
  const int sc = st * CT + tc;                            // its first column
  const long long xrow = (long long)H * P;
  const T* dyc = dy + ((long long)bi * S + s0) * xrow;
  const T* xc = x + ((long long)bi * S + s0) * xrow;
  const float* dtc = dt + ((long long)bi * S + s0) * H;
  const long long tile = ((long long)bg * nc + c) * QP * QP;
  const long long out = (((long long)bg * parts + part) * nc + c) * QP * QP;
  const float* cbt = cb + tile;   // the forward's C . B^T of the chunk

  // acc[4 n + e]: row qa (e < 2) or qb, column sc + 8 n + e % 2
  float dsum[32], acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dsum[e] = acc[e] = 0.f;
  const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const int nj = (h1 - h0) * npb;
  for (int j = 0; j < nj; ++j) {
    // step j: head h0 + j / npb, columns 64 (j % npb) .. of P
    const int h = h0 + j / npb, p0 = 64 * (j % npb);
    const float* chd = cums + (((long long)bi * nc + c) * H + h) * QP;
#pragma unroll 4
    for (int e = tid; e < CT * CT / 4; e += DCB_THREADS) {
      const int r = e / 16, k = (e % 16) * 4, p = p0 + k;
      const int q = qt * CT + r, s = st * CT + r;
      const uint32_t off = sw128(r, k, CT);
      store_split4_sw(yh, yl, off, (q < qc && p < P)
                                       ? load4(dyc + q * xrow + h * P + p)
                                       : z4);
      store_split4_sw(xh, xl, off,
                      (s < qc && p < P) ? scale4(load4(xc + s * xrow +
                                                       h * P + p),
                                                 dtc[s * H + h])
                                        : z4);
    }
    if (!diag && j % npb == 0) {   // the head's decay factors
      const float cr = chd[st * CT + CT - 1];
      if (tid < CT) frow[tid] = expf(chd[qt * CT + tid] - cr);
      else fcol[tid - CT] = expf(cr - chd[st * CT + tid - CT]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (j % npb == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    }
    reg_fence(acc);
    wgmma_fence();
    mma_kblock<0>(acc, yh, yl, xh, xl);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(acc);
    __syncthreads();   // the tiles are rewritten by the next step
    if (j % npb == npb - 1) {   // the head's product is complete
      const float ca = chd[qa], cbq = chd[qb];
      const float fa = qa < qc ? frow[qa - qt * CT] : 0.f,
                  fb = qb < qc ? frow[qb - qt * CT] : 0.f;
      float ra = 0.f, rb = 0.f, col[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 ma = load2(cbt + (long long)qa * QP + sc + 8 * n);
        const float2 mb = load2(cbt + (long long)qb * QP + sc + 8 * n);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = sc + 8 * n + e;
          float va, vb;
          if (diag) {   // uniform across the block
            const float cs = chd[s];
            va = (s <= qa && qa < qc) ? acc[4 * n + e] * expf(ca - cs) : 0.f;
            vb = (s <= qb && qb < qc) ? acc[4 * n + 2 + e] * expf(cbq - cs)
                                      : 0.f;
          } else {
            const float f = fcol[s - st * CT];
            va = acc[4 * n + e] * (fa * f);
            vb = acc[4 * n + 2 + e] * (fb * f);
          }
          dsum[4 * n + e] += va;
          dsum[4 * n + 2 + e] += vb;
          const float wa = (e ? ma.y : ma.x) * va, wb = (e ? mb.y : mb.x) * vb;
          ra += wa;
          rb += wb;
          col[2 * n + e] = wa + wb;
        }
      }
      ra += __shfl_xor_sync(0xffffffffu, ra, 1);
      ra += __shfl_xor_sync(0xffffffffu, ra, 2);
      rb += __shfl_xor_sync(0xffffffffu, rb, 1);
      rb += __shfl_xor_sync(0xffffffffu, rb, 2);
      // msum[b][c][h][0][st][q]: row sums; [1][qt][s]: column sums
      float* ms = msum + (((long long)bi * nc + c) * H + h) * 2 * ntq * QP;
      if ((lane & 3) == 0) {
        ms[(long long)st * QP + qa] = ra;
        ms[(long long)st * QP + qb] = rb;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        col[i] += __shfl_xor_sync(0xffffffffu, col[i], 4);
        col[i] += __shfl_xor_sync(0xffffffffu, col[i], 8);
        col[i] += __shfl_xor_sync(0xffffffffu, col[i], 16);
      }
      if (lane < 4) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          colw[warp][8 * n + tc] = col[2 * n];
          colw[warp][8 * n + tc + 1] = col[2 * n + 1];
        }
      }
      __syncthreads();   // the next head writes colw, frow, fcol after this
      if (tid < CT) {
        float v = colw[0][tid];
        for (int w = 1; w < DCB_THREADS / 32; ++w) v += colw[w][tid];
        ms[((long long)ntq + qt) * QP + st * CT + tid] = v;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    store2(dcb + out + (long long)qa * QP + sc + 8 * n, dsum[4 * n],
           dsum[4 * n + 1]);
    store2(dcb + out + (long long)qb * QP + sc + 8 * n, dsum[4 * n + 2],
           dsum[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// 4. dB and dC
// ---------------------------------------------------------------------------

constexpr int DBC_THREADS = 256;   // two warpgroups, 64 columns of N each
constexpr int DBC_STAGES = 3;      // k blocks of raw inputs in flight

// one stage of pass 4's ring: the raw A rows (64 x 64, float32 at most),
// the raw B rows (64 x N) and the rows' decay inputs (cumulative sums, dt
// and the chunk's last cumulative sum)
template <int N>
__host__ __device__ constexpr int dbc_stage_bytes() {
  return CT * CT * 4 + CT * N * 4 + 3 * CT * 4;
}

template <int N>
constexpr size_t dbc_smem_bytes() {
  return 1024 + 2 * (size_t)TILE_BYTES + 2 * (size_t)box_bytes<N>(CT) +
         DBC_STAGES * (size_t)dbc_stage_bytes<N>();
}

// cp.async of 4 bytes (zero-filled when pred is false)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// One (64 rows t, dC or dB, chunk, b * G) per block: grid (2 ntq, nc,
// b * G). Over k blocks of 64, the A rows (a K-major [m][k] tile) and B
// (an MN-major [k][n] tile) are split into shared memory and multiplied:
//   dC, rows q: k tiles s <= q of dCB[q][s] against B[s][n]; then, from a
//     state entering the chunk, for each head of the group and 64 of P,
//     exp(cums_q) dy[q][p] against S_c[p][n].
//   dB, rows s: k tiles q >= s of dCB[q][s] (read transposed) against
//     C[q][n]; then, where dS_{c+1} is not zero, seg_s dt_s x[s][p]
//     against dS_{c+1}[p][n].
// The raw rows come through a ring of DBC_STAGES stages filled by
// cp.async, two k blocks ahead of the one being split and multiplied; the
// dCB tiles (its parts added in order) are read at the split.
template <typename T, int N>
__global__ void __launch_bounds__(DBC_THREADS)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const T* __restrict__ Bm, const T* __restrict__ Cm,
                   const T* __restrict__ dy, const float* __restrict__ states,
                   const float* __restrict__ init,
                   const float* __restrict__ dst,
                   const float* __restrict__ cums,
                   const float* __restrict__ dcb, T* __restrict__ dB,
                   T* __restrict__ dC, int S, int H, int P, int G, int Q,
                   int QP, int has_gs) {
  constexpr int NB = (N + 63) / 64;
  constexpr int BB = box_bytes<N>(CT);
  constexpr int STAGE = dbc_stage_bytes<N>();
  constexpr int RB = CT * CT * 4, RW = RB + CT * N * 4;   // B, w offsets
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ah = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t al = ah + TILE_BYTES, bh = al + TILE_BYTES, bl = bh + BB;
  const uint32_t ring = bl + BB;
  unsigned char* ringp = smem_raw + (ring - smem_u32(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp / 4, wl = warp % 4;
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  const int t = blockIdx.x >> 1, which = blockIdx.x & 1;   // 0 dC, 1 dB
  const int c = blockIdx.y, nc = gridDim.y, bg = blockIdx.z;
  const int bi = bg / G, g = bg % G;
  const int s0 = c * Q, qc = min(Q, S - s0);
  if (t * CT >= qc) return;   // uniform across the block
  const int hg = H / G, npb = (P + 63) / 64, tl = (qc - 1) / CT;
  const long long xrow = (long long)H * P, bstride = (long long)G * N;
  const T* kin = (which ? Cm : Bm) + ((long long)bi * S + s0) * bstride +
                 (long long)g * N;   // the dCB product's B operand
  const T* ain = (which ? x : dy) + ((long long)bi * S + s0) * xrow;
  const float* dtc = dt + ((long long)bi * S + s0) * H;
  const int parts = dcb_parts(H, G);
  const long long pstride = (long long)nc * QP * QP;   // from part to part
  const float* dcbc = dcb + ((long long)bg * parts * nc + c) * QP * QP;
  auto dcb_at = [&](long long o) {   // dCB: the parts added in order
    float v = dcbc[o];
    for (int j = 1; j < parts; ++j) v += dcbc[o + j * pstride];
    return v;
  };
  const int n1 = which ? tl - t + 1 : t + 1;
  const bool use2 = which ? (c + 1 < nc || has_gs) : (c > 0 || init != nullptr);
  const int nkb = n1 + (use2 ? hg * npb : 0);
  constexpr int EA = 16 / (int)sizeof(T);   // elements of T a 16-byte copy

  // k block kb's raw rows into stage kb % DBC_STAGES, one commit group
  auto issue = [&](int kb) {
    const uint32_t st = ring + (kb % DBC_STAGES) * STAGE;
    if (kb < n1) {   // B: the rows 64 kt .. of B (dC) or C (dB), type T
      const int kt = which ? t + kb : kb;
      for (int e = tid; e < CT * N / EA; e += DBC_THREADS) {
        const int k = e / (N / EA), n = (e % (N / EA)) * EA, j = kt * CT + k;
        cp_async16(st + RB + (k * N + n) * (int)sizeof(T),
                   j < qc ? kin + j * bstride + n : kin, j < qc);
      }
    } else {
      const int jj = kb - n1, h = g * hg + jj / npb, p0 = 64 * (jj % npb);
      // A: 64 rows of dy (dC) or x (dB) of head h, columns p0 .., type T
      for (int e = tid; e < CT * CT / EA; e += DBC_THREADS) {
        const int m = e / (CT / EA), k = (e % (CT / EA)) * EA;
        const int r = t * CT + m, p = p0 + k;
        const bool ok = r < qc && p < P;
        cp_async16(st + (m * CT + k) * (int)sizeof(T),
                   ok ? ain + r * xrow + h * P + p : ain, ok);
      }
      // B: rows p0 .. of S_c (dC) or dS_{c+1} (dB) of head h, float32
      const float* sp =
          which ? dst + (((long long)bi * nc + c) * H + h) * P * N
          : c > 0 ? states + (((long long)bi * (nc - 1) + c - 1) * H + h) *
                                 P * N
                  : init + ((long long)bi * H + h) * P * N;
      for (int e = tid; e < CT * N / 4; e += DBC_THREADS) {
        const int k = e / (N / 4), n = (e % (N / 4)) * 4, p = p0 + k;
        cp_async16(st + RB + (k * N + n) * 4,
                   p < P ? sp + (long long)p * N + n : sp, p < P);
      }
      // the rows' decay inputs: cums (64), dt (64, dB), cums at qc - 1
      const float* chd = cums + (((long long)bi * nc + c) * H + h) * QP;
      if (tid < CT / 4) {
        cp_async16(st + RW + tid * 16, chd + t * CT + 4 * tid, true);
      } else if (which && tid < CT / 4 + CT) {
        const int r = tid - CT / 4;
        cp_async4(st + RW + (CT + r) * 4, dtc + (t * CT + r) * H + h,
                  t * CT + r < qc);
      } else if (tid == CT / 4 + CT) {
        cp_async4(st + RW + 2 * CT * 4, chd + qc - 1, true);
      }
    }
  };

  // split stage kb % DBC_STAGES (and, for the dCB blocks, dCB from global
  // memory) into the A and B tiles
  auto split = [&](int kb) {
    const unsigned char* st = ringp + (kb % DBC_STAGES) * STAGE;
    if (kb < n1) {
      const int kt = which ? t + kb : kb;
      for (int e = tid; e < CT * CT / 4; e += DBC_THREADS) {
        float4 v;
        int m, k;
        if (!which) {   // dCB[q = 64 t + m][s = 64 kt + k ..]
          m = e / 16;
          k = (e % 16) * 4;
          const long long o = (long long)(t * CT + m) * QP + kt * CT + k;
          v = make_float4(dcb_at(o), dcb_at(o + 1), dcb_at(o + 2),
                          dcb_at(o + 3));
        } else {        // dCB[q = 64 kt + k ..][s = 64 t + m], transposed
          m = e % 64;
          k = (e / 64) * 4;
          const long long o = (long long)(kt * CT + k) * QP + t * CT + m;
          v = make_float4(dcb_at(o), dcb_at(o + QP), dcb_at(o + 2 * QP),
                          dcb_at(o + 3 * QP));
        }
        store_split4_sw(ah, al, sw128(m, k, CT), v);
      }
      const T* rb = reinterpret_cast<const T*>(st + RB);
      for (int e = tid; e < CT * N / 4; e += DBC_THREADS) {
        const int k = e / (N / 4), n = (e % (N / 4)) * 4;
        store_split4_sw(bh, bl, sw128(k, n, CT), load4(rb + k * N + n));
      }
    } else {
      const float* w = reinterpret_cast<const float*>(st + RW);
      const float clast = w[2 * CT];
      const T* ra = reinterpret_cast<const T*>(st);
      for (int e = tid; e < CT * CT / 4; e += DBC_THREADS) {
        const int m = e / 16, k = (e % 16) * 4;
        const float wm = which ? expf(clast - w[m]) * w[CT + m] : expf(w[m]);
        store_split4_sw(ah, al, sw128(m, k, CT),
                        scale4(load4(ra + m * CT + k), wm));
      }
      const float* rb = reinterpret_cast<const float*>(st + RB);
      for (int e = tid; e < CT * N / 4; e += DBC_THREADS) {
        const int k = e / (N / 4), n = (e % (N / 4)) * 4;
        store_split4_sw(bh, bl, sw128(k, n, CT), load4(rb + k * N + n));
      }
    }
  };

  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;
  for (int kb = 0; kb < DBC_STAGES - 1; ++kb) {
    if (kb < nkb) issue(kb);
    cp_async_commit();
  }
  // at N = 128 both warpgroups multiply: no divergent path, which would
  // make ptxas serialize the wgmmas
  const bool mine = NB == 2 || wg == 0;
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<DBC_STAGES - 2>();   // this thread's copies of block kb
    __syncthreads();   // everyone's; the tiles' last readers are done
    split(kb);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (mine) {   // uniform across the warpgroup
      reg_fence(acc);
      wgmma_fence();
      mma_kblock<1>(acc, ah, al, bh + wg * TILE_BYTES, bl + wg * TILE_BYTES);
      wgmma_commit();
    }
    // the stage split one block ago is free: fill it
    if (kb + DBC_STAGES - 1 < nkb) issue(kb + DBC_STAGES - 1);
    cp_async_commit();
    if (mine) {
      wgmma_wait<0>();
      reg_fence(acc);
    }
  }

  // acc[4 n + e]: row 64 t + 16 wl + lane / 4 (+ 8 for e >= 2), column
  // 64 wg + 8 n + tc + e % 2
  if (mine) {
    T* out = (which ? dB : dC) + ((long long)bi * S + s0) * bstride +
             (long long)g * N;
    const int ra = t * CT + 16 * wl + gr, rb = ra + 8;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * wg + 8 * n + tc;
      if (col >= N) break;
      if (ra < qc) store2(out + ra * bstride + col, acc[4 * n], acc[4 * n + 1]);
      if (rb < qc)
        store2(out + rb * bstride + col, acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// 5. the decay: dcums, d(dt A), ddt, dA
// ---------------------------------------------------------------------------

// One head per block, a chunk's row per thread, the batch rows and chunks
// in order: dcums from the partial sums of passes 2 and 3 (each summed in
// order), its reverse cumulative sum d(dt A), ddt = x . dxdt + A d(dt A),
// and dA = sum dt d(dt A) over rows (a fixed tree), chunks and batch rows.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_decay_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ msum,
                     const float* __restrict__ rpart,
                     const float* __restrict__ ypart,
                     const float* __restrict__ dot, float* __restrict__ ddt,
                     float* __restrict__ dA, int b, int S, int H, int P,
                     int Q, int QP, int has_init) {
  __shared__ float wsum[WARPS], red[WARPS];
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, k = tid;
  const int nc = (S + Q - 1) / Q, ntq = QP / CT, npt = (P + PT - 1) / PT;
  const float Ah = A[h];
  // the sum of v over the block, in a fixed order, in every thread
  auto block_sum = [&](float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < WARPS; ++w) s += red[w];
    __syncthreads();   // red is rewritten by the next sum
    return s;
  };
  float total = 0.f;
  for (int bi = 0; bi < b; ++bi) {
    for (int c = 0; c < nc; ++c) {
      const int s0 = c * Q, qc = min(Q, S - s0), tl = (qc - 1) / CT;
      const long long bch = ((long long)bi * nc + c) * H + h;
      const float* ms = msum + bch * 2 * ntq * QP;
      const float* yp = ypart + bch * 2 * npt * QP;
      const bool yst = c > 0 || has_init;
      float dc = 0.f, rr = 0.f, dtv = 0.f, gk = 0.f;
      if (k < qc) {
        for (int st = 0; st <= k / CT; ++st) dc += ms[st * QP + k];
        for (int qt = k / CT; qt <= tl; ++qt) dc -= ms[(ntq + qt) * QP + k];
        for (int pt = 0; pt < npt; ++pt) {
          rr += rpart[(bch * npt + pt) * QP + k];
          if (yst) dc += yp[pt * QP + k];
          gk += yp[(npt + pt) * QP + k];
        }
        dc -= gk;
        dtv = dt[((long long)bi * S + s0 + k) * H + h];
      }
      const float gsum = block_sum(gk);
      if (k == qc - 1) {
        dc += gsum;
        for (int pt = 0; pt < npt; ++pt) dc += dot[bch * npt + pt];
      }
      // reverse inclusive cumulative sum over the chunk's rows
      float v = dc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += u;
      }
      if (lane == 0) wsum[warp] = v;
      __syncthreads();
      for (int w = warp + 1; w < WARPS; ++w) v += wsum[w];
      if (k < qc) ddt[((long long)bi * S + s0 + k) * H + h] = rr + Ah * v;
      total += block_sum(k < qc ? dtv * v : 0.f);   // wsum read before its
    }                                             // next write: two syncs
  }
  if (tid == 0) dA[h] = total;
}

template <typename T, int N>
int launch_bwd(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* cb, const void* states,
               const void* init, const void* state, const void* dy,
               const void* gstate, void* cums, void* dst, void* dcb,
               void* msum, void* rpart, void* ypart, void* dot, void* sync,
               void* dx, void* ddt, void* dA, void* dB, void* dC, void* dinit,
               int b, int S, int H, int P, int G, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, ntq = (Q + CT - 1) / CT, QP = ntq * CT;
  const int npt = (P + PT - 1) / PT;
  cudaError_t err;
  if ((err = set_smem(ssd_bwd_state_kernel<T, N>, chunk_smem_bytes<T, N>())) ||
      (err = set_smem(ssd_bwd_dx_kernel<T, N>, dx_smem_bytes<T, N>())) ||
      (err = set_smem(ssd_bwd_dcb_kernel<T>, dcb_smem_bytes())) ||
      (err = set_smem(ssd_bwd_dbc_kernel<T, N>, dbc_smem_bytes<N>())))
    return (int)err;
  const T* xt = static_cast<const T*>(x);
  const T* Bt = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* cbf = static_cast<const float*>(cb);
  const float* stf = static_cast<const float*>(states);
  const float* initf = static_cast<const float*>(init);
  const float* gsf = static_cast<const float*>(gstate);
  float* cumsf = static_cast<float*>(cums);
  float* dstf = static_cast<float*>(dst);
  float* dcbf = static_cast<float*>(dcb);
  float* msumf = static_cast<float*>(msum);
  float* rpf = static_cast<float*>(rpart);
  float* ypf = static_cast<float*>(ypart);
  float* dotf = static_cast<float*>(dot);
  int* syncp = static_cast<int*>(sync);
  const int has_gs = gstate != nullptr, has_init = init != nullptr;

  if ((err = cudaMemsetAsync(syncp, 0,
                             (1 + (size_t)b * npt * H * nc) * sizeof(int),
                             stream)))
    return (int)err;
  ssd_bwd_state_kernel<T, N><<<b * npt * H * nc, THREADS,
                               chunk_smem_bytes<T, N>(), stream>>>(
      dyt, dtf, Af, Ct, gsf, cumsf, dstf, syncp, static_cast<float*>(dinit),
      S, H, P, G, Q, QP);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_dx_kernel<T, N><<<dim3(H, nc, b * npt), THREADS,
                            dx_smem_bytes<T, N>(), stream>>>(
      xt, dtf, Bt, Ct, dyt, cbf, stf, initf, static_cast<const float*>(state),
      dstf, cumsf, static_cast<T*>(dx), rpf, ypf, dotf, S, H, P, G, Q, QP,
      has_gs);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_dcb_kernel<T><<<dim3(ntq * (ntq + 1) / 2, nc,
                                b * G * dcb_parts(H, G)),
                           DCB_THREADS, dcb_smem_bytes(), stream>>>(
      xt, dtf, dyt, cbf, cumsf, dcbf, msumf, S, H, P, G, Q, QP, nc);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_dbc_kernel<T, N><<<dim3(2 * ntq, nc, b * G), DBC_THREADS,
                             dbc_smem_bytes<N>(), stream>>>(
      xt, dtf, Bt, Ct, dyt, stf, initf, dstf, cumsf, dcbf,
      static_cast<T*>(dB), static_cast<T*>(dC), S, H, P, G, Q, QP, has_gs);
  if ((err = cudaGetLastError())) return (int)err;
  ssd_bwd_decay_kernel<<<H, THREADS, 0, stream>>>(
      dtf, Af, msumf, rpf, ypf, dotf, static_cast<float*>(ddt),
      static_cast<float*>(dA), b, S, H, P, Q, QP, has_init);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_n(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* cb, const void* states,
                 const void* init, const void* state, const void* dy,
                 const void* gstate, void* cums, void* dst, void* dcb,
                 void* msum, void* rpart, void* ypart, void* dot, void* sync,
                 void* dx, void* ddt, void* dA, void* dB, void* dC,
                 void* dinit, int b, int S, int H, int P, int G, int N, int Q,
                 cudaStream_t s) {
#define SSD_BWD_ARGS                                                       \
  x, dt, A, B, C, cb, states, init, state, dy, gstate, cums, dst, dcb, msum, \
      rpart, ypart, dot, sync, dx, ddt, dA, dB, dC, dinit, b, S, H, P, G, Q, s
  switch (N) {
    case 16:
      return launch_bwd<T, 16>(SSD_BWD_ARGS);
    case 32:
      return launch_bwd<T, 32>(SSD_BWD_ARGS);
    case 128:
      return launch_bwd<T, 128>(SSD_BWD_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SSD_BWD_ARGS
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

// The backward: the vector-Jacobian product of repro_ssd. x, B, C, dy and
// dx, dB, dC of type dtype; dt, A, ddt and dA float32; cb and states the
// scratch that repro_ssd filled in the forward call on these inputs, state
// its final state (read only with gstate); init null, or the forward's
// initial state with dinit its gradient ((b, H, P, N) float32); gstate null
// (a zero dL/d(final state)) or (b, H, P, N) float32; all contiguous and
// 16-byte aligned. Scratch (npt = ceil(P / 64), QP as repro_ssd's): cums
// of b * nc * H * QP floats, dst of b * nc * H * P * N, dcb of b * G *
// min(4, H / G) * nc * QP^2, msum of b * nc * H * 2 * (QP / 64) * QP, rpart
// of b * nc * H * npt * QP, ypart of twice that, dot of b * nc * H * npt
// floats, sync of 1 + b * npt * H * nc ints (zeroed here). The same shapes as repro_ssd; launches five kernels
// in order on the stream; returns the first CUDA error (0 = success).
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* cb,
                             const void* states, const void* init,
                             const void* state, const void* dy,
                             const void* gstate, void* cums, void* dst,
                             void* dcb, void* msum, void* rpart, void* ypart,
                             void* dot, void* sync, void* dx, void* ddt,
                             void* dA, void* dB, void* dC, void* dinit, int b,
                             int S, int H, int P, int G, int N, int Q,
                             int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 != 0 || G <= 0 ||
      H % G != 0 || Q <= 0 || Q > QMAX || (init == nullptr) != (dinit == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd_n<float>(x, dt, A, B, C, cb, states, init, state, dy,
                               gstate, cums, dst, dcb, msum, rpart, ypart, dot,
                               sync, dx, ddt, dA, dB, dC, dinit, b, S, H, P, G,
                               N, Q, s);
  if (dtype == 1)
    return launch_bwd_n<__nv_bfloat16>(
        x, dt, A, B, C, cb, states, init, state, dy, gstate, cums, dst, dcb,
        msum, rpart, ypart, dot, sync, dx, ddt, dA, dB, dC, dinit, b, S, H, P,
        G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
