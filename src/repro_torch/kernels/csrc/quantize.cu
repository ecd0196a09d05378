// Stochastic-rounding quantize and fused dequantize-mean for Hopper (sm_90a).
//
// quantize replaces the Pallas TPU kernel
// src/repro/kernels/quantize/kernel.py:65 (quantize_kernel; body
// _quant_kernel at :56, pallas_call at :78):
//
//   q[r, c] = clip(floor(y[r, c] / s[r] * qmax + bits[r, c] * 2^-32), +-qmax)
//
// over a whole (N, M) block of client deltas in one launch, with one scale
// per row (client). The TPU path launched once per client. The op order is
// the reference's: divide, then multiply by qmax, then add u, then floor,
// each rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn; the build also
// passes -fmad=false). An FMA of y * qmax + u would round once instead of
// twice and move floor() at integer boundaries, so the int8 codes would no
// longer equal the reference's. u = __uint2float_rn(bits) * 2^-32, so
// bits >= 2^32 - 128 give u = 1.0 exactly as on the reference. The bits
// arrive as int32 and are read as uint32.
// Bound: memory. 4 B of y + 4 B of bits in, 1 B of code out per element
// (9 B); (32, 784) is 0.23 MB, 0.07 us at 3.35 TB/s: launch-bound;
// (32, 2^20) is 302 MB, 90.15 us.
// Design: a 2-D grid, blockIdx.y over rows and blockIdx.x over column
// tiles, so a thread finds its row, the row's offset and its scale once
// per row, and no element pays a 64-bit division of its index. Each
// thread keeps 8 elements in flight: two float4 loads of y and two uint4
// loads of bits, a warp's each 512 contiguous bytes, all issued before the
// first division, then two 4-byte stores of codes. A block is 128
// threads on one row's tile of 1,024 columns, also for short rows: a
// block that took several short rows left the small leaves on fewer SMs
// and ran slower. Rows that are not 16-byte aligned (M % 4 != 0, or a
// view at an odd offset) take an all-scalar instantiation: 8 single
// elements a thread, 128 apart.
// __fdiv_rn stays per element: y * (1 / s) rounds differently.
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py phase
// 3, cold L2): 101.2 us at (32, 2^20) (1.12x the bound; 101.6 us from an
// odd-offset y), 12.4 us at (32, 75264), 6.1 us at (32, 784) against a
// 5.0 us launch floor; 1.7 and 2.0 us a launch inside the logreg and MLP
// local steps. 16 elements a thread (72 registers, 121 in the scalar
// instantiation), 16 contiguous elements with one 16-byte store, 64- or
// 256-thread blocks, and blocks that took several short rows each ran
// slower (PERF.md, section 6).
//
// dequant_mean replaces src/repro/kernels/quantize/kernel.py:98
// (dequant_mean_kernel; body _deq_kernel at :92, pallas_call at :110):
//
//   mean[c] = (sum_i q[i, c] * (s[i] / qmax)) * (1 / N)
//
// Bound: memory. 1 B of code per element in, 4 B per column out; (32, 784)
// is 28 KB, under 0.01 us, so there the launch and the latency of the
// loads are the floor; (32, 2^20) is 37.7 MB, 11.3 us.
// Design: each thread owns 4 adjacent columns and reads them with one
// 4-byte load per client row; the loads of 32 rows are all issued before
// the first add, and before the block forms w[i] = s[i] / qmax (the same
// __fdiv_rn, once per row per block, in shared memory) so that the
// division and the barrier run under them. Each column's sum runs over the
// clients in order in float32 in registers, every product and sum rounded
// on its own: no (N, M) float32 intermediate, no atomics, the same result
// on every run and the same bits as a plain loop over the rows. Where M is
// not a multiple of 4, q not 4-byte aligned or the output not 16-byte
// aligned, every row is read byte by byte and every column stored alone
// (one instantiation of the kernel each). The grid covers the columns, at
// most 16 blocks of 128 threads per SM, with a grid stride beyond that.
// On an H100, 16 columns a thread and 8 rows in flight both ran slower
// (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q_THREADS = 128;   // threads a block
constexpr int Q_VECS = 2;        // 16-byte vectors of y (and of bits) a thread
constexpr int Q_EPT = 4 * Q_VECS;   // elements a thread
// column offsets inside a row are 32-bit: a row, plus a tile past its end,
// stays below 2^31
constexpr int64_t Q_MAX_COLS = INT32_MAX - Q_THREADS * Q_EPT;

// One element's code, as the low byte of a word. Each operation rounds on
// its own, in the reference's order.
__device__ __forceinline__ uint32_t quant_code(float y, uint32_t b, float s,
                                               float qmax) {
  const float inv_2_32 = 2.3283064365386963e-10f;  // 2^-32, exact
  const float v = __fmul_rn(__fdiv_rn(y, s), qmax);
  const float u = __fmul_rn(__uint2float_rn(b), inv_2_32);
  const float c = fminf(fmaxf(floorf(__fadd_rn(v, u)), -qmax), qmax);
  return (uint32_t)(int)c & 0xFFu;
}

// A block covers a tile of Q_THREADS * Q_EPT columns of one row;
// blockIdx.x picks the tile, blockIdx.y the row (a row stride beyond
// 65,535 rows). The row's offset and scale are found once per row, the
// columns indexed with 32-bit offsets.
// VEC (cols % 4 == 0, y and bits 16-byte aligned, q 4-byte aligned): the
// thread's Q_VECS groups of 4 columns lie Q_THREADS groups apart, so each
// load instruction of a warp reads 512 contiguous bytes and each store
// writes 128; a row of a multiple of 4 columns has no partial group. Else
// Q_EPT single elements Q_THREADS apart. All of a thread's loads are
// issued before its first division.
template <bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
quantize_kernel(const float* __restrict__ y, const uint32_t* __restrict__ bits,
                const float* __restrict__ scales, int8_t* __restrict__ q,
                int64_t rows, int cols, float qmax) {
  const int tile = blockIdx.x * (Q_THREADS * Q_EPT);
  const int t = threadIdx.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t off = r * cols;
    const float* yr = y + off;
    const uint32_t* br = bits + off;
    int8_t* qr = q + off;
    const float s = scales[r];
    if (VEC) {
      float4 yv[Q_VECS];
      uint4 bv[Q_VECS];
#pragma unroll
      for (int k = 0; k < Q_VECS; ++k) {
        const int c = tile + 4 * (k * Q_THREADS + t);
        if (c < cols) {
          yv[k] = *reinterpret_cast<const float4*>(yr + c);
          bv[k] = *reinterpret_cast<const uint4*>(br + c);
        }
      }
#pragma unroll
      for (int k = 0; k < Q_VECS; ++k) {
        const int c = tile + 4 * (k * Q_THREADS + t);
        if (c < cols)
          *reinterpret_cast<uint32_t*>(qr + c) =
              quant_code(yv[k].x, bv[k].x, s, qmax) |
              quant_code(yv[k].y, bv[k].y, s, qmax) << 8 |
              quant_code(yv[k].z, bv[k].z, s, qmax) << 16 |
              quant_code(yv[k].w, bv[k].w, s, qmax) << 24;
      }
    } else {
      float yv[Q_EPT];
      uint32_t bv[Q_EPT];
#pragma unroll
      for (int k = 0; k < Q_EPT; ++k) {
        const int c = tile + k * Q_THREADS + t;
        yv[k] = c < cols ? yr[c] : 0.0f;
        bv[k] = c < cols ? br[c] : 0u;
      }
#pragma unroll
      for (int k = 0; k < Q_EPT; ++k) {
        const int c = tile + k * Q_THREADS + t;
        if (c < cols) qr[c] = (int8_t)quant_code(yv[k], bv[k], s, qmax);
      }
    }
  }
}

constexpr int DQ_THREADS = 128;
constexpr int DQ_ROWS = 256;   // rows of w in shared memory at a time
constexpr int DQ_BATCH = 32;   // rows whose loads are in flight together

// The four codes of columns c0 .. c0 + 3 of one row, as one word: one
// 4-byte load where every row's columns are 4-byte aligned (ALIGNED), else
// byte by byte, zeros past cols.
template <bool ALIGNED>
__device__ __forceinline__ uint32_t load_codes(const int8_t* row, int64_t c0,
                                               int64_t cols) {
  if (ALIGNED) return *reinterpret_cast<const uint32_t*>(row + c0);
  uint32_t c = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (c0 + k < cols) c |= (uint32_t)(uint8_t)row[c0 + k] << (8 * k);
  return c;
}

// Four adjacent columns a thread. Per chunk of up to 256 rows, batches of
// DQ_BATCH rows: all of a batch's loads are issued before its adds (the
// chunk's first batch before w is formed), the adds run over the rows in
// order.
template <bool ALIGNED>
__global__ void __launch_bounds__(DQ_THREADS)
dequant_mean_kernel(const int8_t* __restrict__ q,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int64_t rows, int64_t cols,
                    float qmax, float inv_n) {
  __shared__ float w[DQ_ROWS];
  const int64_t groups = (cols + 3) / 4;
  const int64_t stride = (int64_t)DQ_THREADS * gridDim.x;
  for (int64_t g0 = (int64_t)blockIdx.x * DQ_THREADS; g0 < groups;
       g0 += stride) {   // uniform across the block: it synchronises
    const int64_t c0 = (g0 + threadIdx.x) * 4;
    const bool active = c0 < cols;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    uint32_t c[DQ_BATCH];
    // a whole batch takes no per-row test; a short one (the last of a
    // chunk) loads and adds its first n rows only
    auto load = [&](const int8_t* qb, int n) {
      if (!active) return;
      if (n >= DQ_BATCH) {
#pragma unroll
        for (int u = 0; u < DQ_BATCH; ++u)
          c[u] = load_codes<ALIGNED>(qb + (int64_t)u * cols, c0, cols);
      } else {
#pragma unroll
        for (int u = 0; u < DQ_BATCH; ++u)
          if (u < n)
            c[u] = load_codes<ALIGNED>(qb + (int64_t)u * cols, c0, cols);
      }
    };
    auto add = [&](const float* wb, int n) {
#pragma unroll
      for (int u = 0; u < DQ_BATCH; ++u) {
        if (u >= n) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float qk = (float)(int8_t)(c[u] >> (8 * k));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(qk, wb[u]));
        }
      }
    };
    for (int64_t r0 = 0; r0 < rows; r0 += DQ_ROWS) {
      const int nr = (int)(rows - r0 < DQ_ROWS ? rows - r0 : DQ_ROWS);
      const int8_t* qc = q + r0 * cols;
      load(qc, nr);
      if (r0 > 0 || g0 != (int64_t)blockIdx.x * DQ_THREADS)
        __syncthreads();   // the last chunk's w has been read
      for (int i = threadIdx.x; i < nr; i += DQ_THREADS)
        w[i] = __fdiv_rn(scales[r0 + i], qmax);   // one division per row
      __syncthreads();
      if (!active) continue;
      for (int b0 = 0; b0 < nr; b0 += DQ_BATCH) {
        if (b0 > 0) load(qc + (int64_t)b0 * cols, nr - b0);
        add(w + b0, nr - b0);
      }
    }
    if (!active) continue;
    if (ALIGNED) {
      *reinterpret_cast<float4*>(out + c0) =
          make_float4(__fmul_rn(acc[0], inv_n), __fmul_rn(acc[1], inv_n),
                      __fmul_rn(acc[2], inv_n), __fmul_rn(acc[3], inv_n));
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < cols) out[c0 + k] = __fmul_rn(acc[k], inv_n);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int repro_quantize(const void* y, const void* bits,
                              const void* scales, void* q, int64_t rows,
                              int64_t cols, float qmax, void* stream) {
  if (rows <= 0 || cols <= 0 || cols > Q_MAX_COLS)
    return (int)cudaErrorInvalidValue;
  const int64_t tile = Q_THREADS * Q_EPT;
  const dim3 grid((unsigned)((cols + tile - 1) / tile),
                  (unsigned)(rows < 65535 ? rows : 65535));   // row stride
  const float* yp = static_cast<const float*>(y);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  const float* sp = static_cast<const float*>(scales);
  int8_t* qp = static_cast<int8_t*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols % 4 == 0 && (reinterpret_cast<uintptr_t>(yp) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(bp) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(qp) & 3) == 0)
    quantize_kernel<true><<<grid, Q_THREADS, 0, s>>>(yp, bp, sp, qp, rows,
                                                     (int)cols, qmax);
  else
    quantize_kernel<false><<<grid, Q_THREADS, 0, s>>>(yp, bp, sp, qp, rows,
                                                      (int)cols, qmax);
  return (int)cudaGetLastError();
}

extern "C" int repro_dequant_mean(const void* q, const void* scales,
                                  void* out, int64_t rows, int64_t cols,
                                  float qmax, float inv_n, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t blocks = (cols + 4 * DQ_THREADS - 1) / (4 * DQ_THREADS);
  if (blocks > 132 * 16) blocks = 132 * 16;   // a grid stride beyond that
  // every row's four columns 4-byte aligned, and the output 16-byte
  if (cols % 4 == 0 && (reinterpret_cast<uintptr_t>(qp) & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(op) & 15) == 0)
    dequant_mean_kernel<true><<<(unsigned)blocks, DQ_THREADS, 0, s>>>(
        qp, sp, op, rows, cols, qmax, inv_n);
  else
    dequant_mean_kernel<false><<<(unsigned)blocks, DQ_THREADS, 0, s>>>(
        qp, sp, op, rows, cols, qmax, inv_n);
  return (int)cudaGetLastError();
}
