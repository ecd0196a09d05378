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
// (9 B); (32, 784) is 0.23 MB, 0.07 us at 3.35 TB/s: launch-bound.
// Design: one grid-stride pass, coalesced, the row's scale read per
// element (it stays in L1).
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

__global__ void quantize_kernel(const float* __restrict__ y,
                                const uint32_t* __restrict__ bits,
                                const float* __restrict__ scales,
                                int8_t* __restrict__ q, int64_t rows,
                                int64_t cols, float qmax) {
  const int64_t n = rows * cols;
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  const float inv_2_32 = 2.3283064365386963e-10f;  // 2^-32, exact
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float s = scales[i / cols];
    const float v = __fmul_rn(__fdiv_rn(y[i], s), qmax);
    const float u = __fmul_rn(__uint2float_rn(bits[i]), inv_2_32);
    float c = floorf(__fadd_rn(v, u));
    c = fminf(fmaxf(c, -qmax), qmax);
    q[i] = (int8_t)c;
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

int64_t grid_for(int64_t n, int threads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  return blocks < 1 ? 1 : blocks;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int repro_quantize(const void* y, const void* bits,
                              const void* scales, void* q, int64_t rows,
                              int64_t cols, float qmax, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  quantize_kernel<<<(unsigned)grid_for(rows * cols, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const uint32_t*>(bits),
      static_cast<const float*>(scales), static_cast<int8_t*>(q), rows, cols,
      qmax);
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
