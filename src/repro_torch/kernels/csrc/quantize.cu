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
// One thread per column walks the N clients in order and accumulates in
// float32 in registers: no (N, M) float32 intermediate reaches memory, no
// atomics, so the result is the same on every run.
// Bound: memory. 1 B of code per element in, 4 B per column out; (32, 784)
// is 28 KB, under 0.01 us: launch-bound. Neighbouring threads read
// neighbouring bytes of one client row, so each warp's loads coalesce.
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

__global__ void dequant_mean_kernel(const int8_t* __restrict__ q,
                                    const float* __restrict__ scales,
                                    float* __restrict__ out, int64_t rows,
                                    int64_t cols, float qmax, float inv_n) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < cols;
       c += stride) {
    float acc = 0.0f;
    for (int64_t r = 0; r < rows; ++r) {
      const float w = __fdiv_rn(scales[r], qmax);
      acc = __fadd_rn(acc, __fmul_rn((float)q[r * cols + c], w));
    }
    out[c] = __fmul_rn(acc, inv_n);
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
  const int threads = 256;
  dequant_mean_kernel<<<(unsigned)grid_for(cols, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales),
      static_cast<float*>(out), rows, cols, qmax, inv_n);
  return (int)cudaGetLastError();
}
