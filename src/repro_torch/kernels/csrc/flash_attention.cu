// Flash (online-softmax) GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py:75
// (flash_attention; body _attn_kernel at :25, pallas_call at :96). Per query
// row i (position qpos = i + Sk - Sq, queries at the tail of the kv
// sequence) and head h (kv head h / (H / KV)):
//
//   s    = scale * (q . k)                      float32
//   s    = cap * tanhf(s / cap)                 when cap > 0
//   s    = -1e38 where not (kpos <= qpos       when causal
//                          and kpos > qpos - window   when window > 0
//                          and kpos < Sk)
//   m, l, acc: online softmax over kv tiles, f32 running max / sum / output
//   o    = acc / max(l, 1e-30)                  cast to q's type
//
// The masked value is the Pallas kernel's finite -1e38, never -inf: a row
// whose tiles so far were all masked has m = -1e38 and exp(s - m) = 1, and
// the first tile with a real score resets it through exp(-1e38 - m) = 0,
// where -inf would give inf - inf = NaN. Kv tiles that no query of the
// block can see are skipped; the result is the same, since every causal
// row holds its diagonal and a skipped tile would only add exact zeros or
// be reset. Unlike the Pallas kernel, any Sq <= Sk is taken: the ragged
// edges (query rows >= Sq, kv rows >= Sk) are masked here.
//
// Bound: operations. 4 * D FLOPs per visible (q, k) pair against 2 bytes
// per element of q, k, v, o moved once; at gemma2-27b's prefill (4,608
// tokens, 32 heads, D = 128) that is 174 GFLOP against 113 MB, far past
// the card's balance point.
//
// Two kernels, picked by the input type:
//
// bfloat16 (the serving path): tensor cores through mma.sync m16n8k16
// (bf16 in, float32 accumulate), FlashAttention-2 style. A block is 4 warps
// and 64 query rows, 16 per warp; q and k tiles are staged row-major in
// shared memory and v transposed (d-major), rows padded by 8 elements so
// every fragment load hits 32 distinct banks. Each warp keeps its 16 x 64
// scores and its 16 x D output accumulator in registers (the mma C layout:
// a thread holds rows g and g + 8 of its quad), does the softmax there
// (row max and sum across the quad's 4 lanes by shuffles), and feeds the
// probabilities, rounded to bf16, straight back as the A operand of P.V.
// Shared memory 53 KB at D = 128: four blocks per SM.
//
// float32: CUDA-core FMAs, so the result matches float32 math to 1e-5
// (tensor cores would round to tf32 or bf16). 256 threads per block of 64
// query rows, tiles staged as float32 (rows padded by one float), 4 x 4
// scores per thread, four threads per row's softmax, 4 rows x D/16 output
// columns per thread in registers. 116 KB of shared memory at D = 128.
//
// Shared memory above 48 KB is set with cudaFuncSetAttribute before each
// launch. No load is pipelined with compute yet (cp.async / TMA are later
// work).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // kv rows per tile
constexpr float NEG_INF = -1.0e38f;

struct TileRange {
  int t_begin, t_end;
};

// kv tiles some query of the block [q0, q0 + BQ) can see
__device__ __forceinline__ TileRange tile_range(int q0, int Sq, int Sk,
                                                int causal, int window) {
  const int seq_off = Sk - Sq;
  const int q_first = q0 + seq_off;
  const int q_last = min(q0 + BQ, Sq) - 1 + seq_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  return {k_begin / BK, (k_end + BK - 1) / BK};
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
// bfloat16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         (size_t)(BQ * (D + 8) + BK * (D + 8) + D * (BK + 8));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float d[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                         int KV, int causal, int window, float softcap,
                         float scale) {
  constexpr int QP = D + 8;   // row stride of Qs / Ks (elements)
  constexpr int VP = BK + 8;  // row stride of Vt (elements)
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int ND = D / 8;   // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // BQ x QP
  __nv_bfloat16* Ks = Qs + BQ * QP;                                 // BK x QP
  __nv_bfloat16* Vt = Ks + BK * QP;                                 // D x VP

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int seq_off = Sk - Sq;
  const int64_t q_row = (int64_t)H * D;
  const int64_t kv_row = (int64_t)KV * D;
  const __nv_bfloat16* qb = q + ((int64_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((int64_t)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * Sk * KV + kvh) * D;
  __nv_bfloat16* ob = o + ((int64_t)b * Sq * H + h) * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int e = tid; e < BQ * CPR; e += MMA_THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const int qi = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * QP + c) =
        qi < Sq ? *reinterpret_cast<const uint4*>(qb + qi * q_row + c) : zero;
  }

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = q0 + r0 + seq_off;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.0f, 0.0f};  // this thread's partial row sums
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  const TileRange tr = tile_range(q0, Sq, Sk, causal, window);
  for (int t = tr.t_begin; t < tr.t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of Ks / Vt are done
    for (int e = tid; e < BK * CPR; e += MMA_THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      const int ki = k0 + r;
      *reinterpret_cast<uint4*>(Ks + r * QP + c) =
          ki < Sk ? *reinterpret_cast<const uint4*>(kb + ki * kv_row + c)
                  : zero;
    }
    // v transposed: neighbouring lanes take neighbouring kv rows, so the
    // 2-byte stores into a d-major row land in distinct banks
    for (int e = tid; e < BK * CPR; e += MMA_THREADS) {
      const int r = e % BK, c = (e / BK) * 8;
      const int ki = k0 + r;
      uint4 val =
          ki < Sk ? *reinterpret_cast<const uint4*>(vb + ki * kv_row + c)
                  : zero;
      const __nv_bfloat16* x = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * VP + r] = x[i];
    }
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 kv rows
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = Qs + r0 * QP + kk + t4 * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * QP);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * QP + 8);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * QP + kk + t4 * 2;
        mma_bf16(s[n], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
      }
    }

    // online softmax on the registers: s[n][0..1] row r0, s[n][2..3] r0 + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + n * 8 + t4 * 2 + (i & 1);
        const int qpos = qpos0 + (i >> 1) * 8;
        s[n][i] = score(s[n][i], scale, softcap, qpos, kpos, Sk, causal,
                        window);
        mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m_r[j], mx[j]);
      alpha[j] = expf(m_r[j] - m_new);
      m_r[j] = m_new;
      l_r[j] *= alpha[j];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m_r[i >> 1]);
        l_r[i >> 1] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P . V, P from the score registers (the C layout of two
    // neighbouring n-tiles is the A layout of one k-step)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vr = Vt + (n * 8 + g) * VP + 16 * j + t4 * 2;
        mma_bf16(acc[n], a0, a1, a2, a3, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 2);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l_r[j], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      __nv_bfloat162 out = __floats2bfloat162_rn(acc[n][2 * j] / denom,
                                                 acc[n][2 * j + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * q_row + n * 8 + t4 * 2) =
          out;
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

  const TileRange tr = tile_range(q0, Sq, Sk, causal, window);
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

template <typename T, typename Kern>
int launch(Kern kern, size_t smem, int threads, const void* q, const void* k,
           const void* v, void* o, int B, int Sq, int Sk, int H, int KV,
           int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int KV, int causal, int window,
             float softcap, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float>(flash_fwd_f32_kernel<D>, f32_smem_bytes<D>(),
                         F32_THREADS, q, k, v, o, B, Sq, Sk, H, KV, causal,
                         window, softcap, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(flash_fwd_mma_kernel<D>, mma_smem_bytes<D>(),
                                 MMA_THREADS, q, k, v, o, B, Sq, Sk, H, KV,
                                 causal, window, softcap, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D), contiguous, all
// of one type: dtype 0 = float32, 1 = bfloat16 (16-byte aligned). window 0
// = none, softcap 0 = none. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
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
