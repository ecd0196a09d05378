// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:68
// (ssd_chunked_kernel; body _ssd_kernel at :20-65, pallas_call at :82).
// For each batch row b and head h (B/C group g = h / (H / G)), over chunks
// of Q rows in order, from a zero state (P x N):
//
//   cums_i  = sum_{k <= i} dt_k * A_h                  inclusive, per chunk
//   y_i     = sum_{j <= i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//           + exp(cums_i) C_i . state                  (state entering it)
//   state   = exp(cums_last) state + sum_j exp(cums_last - cums_j) dt_j x_j B_j^T
//
// and the final state is written after the last chunk. All math is float32
// on the CUDA cores; float32 or bfloat16 x / B / C are upcast on load and y
// is written in x's type. The decay is selected, never multiplied by a
// mask: for i < j the exponent is positive and may overflow, and inf * 0 is
// NaN.
//
// Unlike the Pallas kernel, S need not be a multiple of Q: the last chunk
// has qc = S - (nc - 1) Q rows. Its rows >= qc are loaded as zeros with
// dt = 0, so they neither decay nor inject anything, cums_last is the
// cumulative sum at row qc - 1, and only rows < qc are written.
//
// Two kernels. The first computes C . B^T once per (b, group, chunk): the
// 64 x 64 tiles at or below the diagonal of the chunk's Q x Q matrix, into
// a float32 scratch of b * G * nc * QP^2 floats (QP = Q rounded up to 64;
// 4 MB at mamba2-2.7b's 4,096-token prefill, which stays in L2). Every head
// of the group reads it there instead of recomputing it.
//
// The scan kernel runs one block per (b, h, PB = 16 of the P state rows):
// y[:, p] needs only state[p, :] and x[:, p], so the P rows split across
// blocks, which fills the card at batch 1 (mamba2-2.7b: 80 heads x 4 = 320
// blocks on 132 SMs). A loop over chunks inside the block takes the place
// of the TPU's sequential grid axis. A chunk of Q = 256 rows does not fit
// shared memory whole (its decayed C . B^T alone is 256 KB in float32), so
// it is walked in 64-row query tiles, each against the 64-row key tiles at
// or below it: the C . B^T tile is read from the scratch, decayed
// (__expf: at the exponents that matter, |x| < 20, its relative error is
// about 1e-6) and staged in shared memory, then multiplied into y with the
// key rows' x dt. The state stays in registers, 1/16 of the block's
// PB x N slice per thread, with a transposed copy in shared memory for the
// y_i term, whose C tile is staged transposed (n-major, rows padded to 68
// floats) so it is read without bank conflicts. Shared memory 68 KB at
// N = 128: three blocks per SM.
//
// Bound: operations. Per head and chunk the least float32 work is the
// lower triangle of (C B^T o L) . (x dt) (Q(Q+1)/2 x P multiply-adds), the
// y_i state term and the state update (Q x P x N each), and C . B^T once
// per group; at mamba2-2.7b's 4,096-token prefill that is about 16 GFLOP
// per layer against 176 MB moved, far past the card's float32 balance
// point. The loads are not pipelined and no tensor cores are used
// (PERF.md has the times; wgmma, TMA and a larger share of the state per
// block are later work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;         // query rows per tile
constexpr int TK = 64;         // key rows per tile (== TQ: square C . B^T tiles)
constexpr int PB = 16;         // state rows of P per block
constexpr int THREADS = 256;   // also the longest chunk: one scan row each
constexpr int QMAX = THREADS;
constexpr int TPAD = TQ + 4;   // row stride of the transposed C / B tiles
constexpr int SPAD = TK + 4;   // row stride of the decayed score tile
constexpr int STPAD = PB + 4;  // row stride of the transposed state

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

constexpr size_t cb_smem_floats(int N) { return 2 * (size_t)N * TPAD; }

// The scan's B rows (TK x N, state update) share the C tile's N x TPAD.
constexpr size_t scan_smem_floats(int N) {
  return (size_t)N * TPAD + (size_t)TQ * SPAD + (size_t)TK * PB +
         (size_t)N * STPAD + 2 * QMAX + THREADS / 32;
}

// dst[n * TPAD + i] = src[(row0 + i) * stride + n] for the 64 rows i of a
// tile, 0 for rows >= qc. Each warp reads 16 rows x 2 float4 (whole 32-byte
// sectors) and its transposed stores land in 32 distinct banks.
template <typename T, int N>
__device__ __forceinline__ void load_tile_t(float* dst, const T* src, int row0,
                                            int qc, long long stride,
                                            int tid) {
  constexpr int F = TQ * N / 4;
  for (int e = tid; e < F; e += THREADS) {
    const int w = e >> 5, lane = e & 31;
    const int i = (w & 3) * 16 + (lane & 15);
    const int n = ((w >> 2) * 2 + (lane >> 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + i < qc) v = load4(src + (long long)(row0 + i) * stride + n);
    dst[(n + 0) * TPAD + i] = v.x;
    dst[(n + 1) * TPAD + i] = v.y;
    dst[(n + 2) * TPAD + i] = v.z;
    dst[(n + 3) * TPAD + i] = v.w;
  }
}

// dst[r * N + n] = src[(row0 + r) * stride + n], row-major, 0 for rows >= qc.
template <typename T, int N>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int qc, long long stride, int tid) {
  constexpr int F = TK * N / 4;
  for (int e = tid; e < F; e += THREADS) {
    const int r = e / (N / 4), n = (e % (N / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < qc) v = load4(src + (long long)(row0 + r) * stride + n);
    store4(dst + r * N + n, v);
  }
}

// xw[r * PB + p] = x[row0 + r, p0 + p] * dt[row0 + r] * w_r with
// w_r = exp(clast - cums[row0 + r]) when weighted, else 1; 0 for rows >= qc.
// One float4 per thread (64 rows x 16 columns).
template <typename T>
__device__ __forceinline__ void load_xw(float* xw, const T* xc, int row0,
                                        int qc, long long stride,
                                        const float* dts, const float* cums,
                                        bool weighted, float clast, int tid) {
  const int r = tid >> 2, q = (tid & 3) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row0 + r < qc) {
    v = load4(xc + (long long)(row0 + r) * stride + q);
    float s = dts[row0 + r];
    if (weighted) s *= expf(clast - cums[row0 + r]);
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
  }
  store4(xw + r * PB + q, v);
}

// C . B^T of one chunk, one 64 x 64 tile at or below the diagonal per
// block: grid (ntq (ntq + 1) / 2 tiles, nc chunks, b * G). Rows >= qc of a
// short last chunk are zeros; tiles wholly past them are not written (the
// scan kernel never reads them).
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ cb, int S, int G, int Q, int QP, int nc) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;             // C tile, transposed: N x TPAD
  float* bt = ct + N * TPAD;    // B tile, transposed: N x TPAD
  const int tid = threadIdx.x;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= (int)blockIdx.x) ++qt;
  const int kt = (int)blockIdx.x - qt * (qt + 1) / 2;
  const int c = blockIdx.y, bg = blockIdx.z;
  const int bi = bg / G, g = bg % G;
  const int s0 = c * Q, qc = min(Q, S - s0);
  if (qt * TQ >= qc) return;   // uniform across the block

  const long long bstride = (long long)G * N;
  const long long boff = ((long long)bi * S + s0) * bstride + (long long)g * N;
  load_tile_t<T, N>(ct, Cm + boff, qt * TQ, qc, bstride, tid);
  load_tile_t<T, N>(bt, Bm + boff, kt * TK, qc, bstride, tid);
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;   // a 4 x 4 tile per thread
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float4 cv = *reinterpret_cast<const float4*>(ct + n * TPAD + ty * 4);
    const float4 bv = *reinterpret_cast<const float4*>(bt + n * TPAD + tx * 4);
    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(cr[a], br[b], acc[a][b]);
  }
  float* out = cb + ((long long)bg * nc + c) * QP * QP +
               (long long)(qt * TQ + ty * 4) * QP + kt * TK + tx * 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    store4(out + (long long)a * QP,
           make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ cb,
                T* __restrict__ y, float* __restrict__ state_out, int S,
                int H, int P, int G, int Q, int QP) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                  // C tile, transposed: N x TPAD
  float* br = smem;                  // or B rows of a key tile: TK x N
  float* ss = ct + N * TPAD;         // decayed C . B^T tile: TQ x SPAD
  float* xw = ss + TQ * SPAD;        // x dt (w) of the key rows: TK x PB
  float* st = xw + TK * PB;          // state, transposed: N x STPAD
  float* cums = st + N * STPAD;      // QMAX
  float* dts = cums + QMAX;          // QMAX
  float* wsum = dts + QMAX;          // one per warp

  constexpr int NK = N / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (H / G);
  const int nc = (S + Q - 1) / Q;
  const float Ah = A[h];
  const long long xstride = (long long)H * P;   // x / y row stride
  const long long bstride = (long long)G * N;   // B / C row stride
  const long long xoff = (long long)bi * S * xstride + (long long)h * P + p0;
  const long long boff = (long long)bi * S * bstride + (long long)g * N;
  const float* dtb = dt + (long long)bi * S * H + h;

  const int ty = tid >> 4, tx = tid & 15;        // 4 x 4 of the score tile
  const int yi = tid >> 2, yp = (tid & 3) * 4;   // 1 row x 4 columns of y
  const int sp = tid >> 4, sn = tid & 15;        // state row, columns sn + 16k

  float sreg[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    sreg[k] = 0.f;
    st[(sn + 16 * k) * STPAD + sp] = 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const int s0 = c * Q;
    const int qc = min(Q, S - s0);

    // inclusive cumulative sum of dt * A over the chunk (rows >= qc add 0)
    const float dtv = tid < qc ? dtb[(long long)(s0 + tid) * H] : 0.f;
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
    const float clast = cums[qc - 1];

    const T* xc = x + xoff + (long long)s0 * xstride;
    T* yc = y + xoff + (long long)s0 * xstride;
    const T* Bc = Bm + boff + (long long)s0 * bstride;
    const T* Cc = Cm + boff + (long long)s0 * bstride;
    const float* cbc = cb + ((long long)(bi * G + g) * nc + c) * QP * QP;

    const int nq = (qc + TQ - 1) / TQ;
    for (int qt = 0; qt < nq; ++qt) {
      const int r0 = qt * TQ;
      load_tile_t<T, N>(ct, Cc, r0, qc, bstride, tid);
      float yacc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * TK;
        load_xw<T>(xw, xc, k0, qc, xstride, dts, cums, false, 0.f, tid);
        const float* cbt = cbc + (long long)(r0 + ty * 4) * QP + k0 + tx * 4;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float4 cv = *reinterpret_cast<const float4*>(cbt + (long long)a * QP);
          const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
          const int ri = r0 + ty * 4 + a;
          const float ci = cums[ri];
          float o[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int rj = k0 + tx * 4 + b;
            o[b] = (ri >= rj && rj < qc) ? cr[b] * __expf(ci - cums[rj]) : 0.f;
          }
          store4(ss + (ty * 4 + a) * SPAD + tx * 4, make_float4(o[0], o[1], o[2], o[3]));
        }
        __syncthreads();

#pragma unroll 8
        for (int j = 0; j < TK; ++j) {
          const float s = ss[yi * SPAD + j];
          const float4 xv = *reinterpret_cast<const float4*>(xw + j * PB + yp);
          yacc[0] = fmaf(s, xv.x, yacc[0]);
          yacc[1] = fmaf(s, xv.y, yacc[1]);
          yacc[2] = fmaf(s, xv.z, yacc[2]);
          yacc[3] = fmaf(s, xv.w, yacc[3]);
        }
        __syncthreads();
      }

      // the state entering the chunk, decayed to row r0 + yi
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float cv = ct[n * TPAD + yi];
        const float4 sv = *reinterpret_cast<const float4*>(st + n * STPAD + yp);
        o[0] = fmaf(cv, sv.x, o[0]);
        o[1] = fmaf(cv, sv.y, o[1]);
        o[2] = fmaf(cv, sv.z, o[2]);
        o[3] = fmaf(cv, sv.w, o[3]);
      }
      const float e = expf(cums[r0 + yi]);
      if (r0 + yi < qc)
        store4(yc + (long long)(r0 + yi) * xstride + yp,
               make_float4(fmaf(e, o[0], yacc[0]), fmaf(e, o[1], yacc[1]),
                           fmaf(e, o[2], yacc[2]), fmaf(e, o[3], yacc[3])));
      __syncthreads();   // ct is reloaded by the next query tile
    }

    // state update: decay the whole chunk, inject the weighted inputs (the
    // B rows take the C tile's place)
    float inj[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) inj[k] = 0.f;
    const int nkt = (qc + TK - 1) / TK;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TK;
      load_rows<T, N>(br, Bc, k0, qc, bstride, tid);
      load_xw<T>(xw, xc, k0, qc, xstride, dts, cums, true, clast, tid);
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < TK; ++r) {
        const float xv = xw[r * PB + sp];
#pragma unroll
        for (int k = 0; k < NK; ++k)
          inj[k] = fmaf(xv, br[r * N + sn + 16 * k], inj[k]);
      }
      __syncthreads();
    }
    const float dec = expf(clast);
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      sreg[k] = fmaf(sreg[k], dec, inj[k]);
      st[(sn + 16 * k) * STPAD + sp] = sreg[k];
    }
    __syncthreads();   // st and cums are read / rewritten by the next chunk
  }

  float* so = state_out + (((long long)bi * H + h) * P + p0 + sp) * N + sn;
#pragma unroll
  for (int k = 0; k < NK; ++k) so[16 * k] = sreg[k];
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* cb, void* y, void* state, int b, int S,
           int H, int P, int G, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, ntq = (Q + TQ - 1) / TQ, QP = ntq * TQ;
  const size_t cb_smem = cb_smem_floats(N) * sizeof(float);
  const size_t scan_smem = scan_smem_floats(N) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cb_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_scan_kernel<T, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 cb_grid((unsigned)(ntq * (ntq + 1) / 2), (unsigned)nc,
                     (unsigned)(b * G));
  ssd_cb_kernel<T, N><<<cb_grid, THREADS, cb_smem, stream>>>(
      static_cast<const T*>(B), static_cast<const T*>(C),
      static_cast<float*>(cb), S, G, Q, QP, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(P / PB), (unsigned)H, (unsigned)b);
  ssd_scan_kernel<T, N><<<grid, THREADS, scan_smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(cb),
      static_cast<T*>(y), static_cast<float*>(state), S, H, P, G, Q, QP);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* x, const void* dt, const void* A, const void* B,
             const void* C, void* cb, void* y, void* state, int b, int S,
             int H, int P, int G, int N, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(x, dt, A, B, C, cb, y, state, b, S, H, P, G, Q, s);
    case 32: return launch<T, 32>(x, dt, A, B, C, cb, y, state, b, S, H, P, G, Q, s);
    case 128: return launch<T, 128>(x, dt, A, B, C, cb, y, state, b, S, H, P, G, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (b, S, H, P) and y (b, S, H, P) of type dtype (0 = float32, 1 =
// bfloat16), dt (b, S, H) and A (H,) float32, B and C (b, S, G, N) of type
// dtype, state (b, H, P, N) float32; all contiguous and 16-byte aligned.
// cb is float32 scratch of b * G * ceil(S / Q) * QP^2 floats, QP = Q
// rounded up to a multiple of 64. Needs P % 16 == 0, N in {16, 32, 128}
// (the Pallas tests' and mamba2-2.7b's), G dividing H and 1 <= Q <= 256. Launches the C . B^T kernel,
// then the scan; returns cudaGetLastError() after each launch (0 =
// success).
extern "C" int repro_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* cb, void* y,
                         void* state, int b, int S, int H, int P, int G,
                         int N, int Q, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || H <= 0 || P <= 0 || P % PB != 0 || G <= 0 ||
      H % G != 0 || Q <= 0 || Q > QMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_n<float>(x, dt, A, B, C, cb, y, state, b, S, H, P, G, N, Q,
                           s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(x, dt, A, B, C, cb, y, state, b, S, H, P,
                                   G, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
