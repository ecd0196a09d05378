// Fused momentum-SGD update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update/kernel.py:33
// (fused_sgd_update; body _upd_kernel at :21, pallas_call at :46).
//
//   g += wd * p;  m' = beta * m + g;  p' = p - eta * m'
//
// in float32, with p' and m' written back in p's and m's own types
// (float32 or bfloat16). The update runs IN PLACE over one flat (N * M)
// view: the N stacked client replicas of one parameter leaf in one launch.
// eta, beta and wd are run-time arguments (eta changes every local step),
// where the Pallas kernel baked them in.
//
// Bound: memory. Each element reads p, m, g and writes p, m: 20 bytes in
// float32 for 4 flops, so the kernel can at best run at 3.35 TB/s (H100 SXM
// HBM3). At the simulator's logreg leaf, (32, 784) floats, that is 0.5 MB
// and 0.15 us, far below a launch, so the slice's shapes are launch-bound.
// Design: one grid-stride pass, one element per thread per iteration,
// neighbouring threads on neighbouring addresses (coalesced); no shared
// memory, no atomics. Built with -fmad=false so beta * m + g is not fused
// into an FMA: the result then rounds as the plain version's does.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TP, typename TM>
__global__ void fused_sgd_update_kernel(TP* __restrict__ p,
                                        TM* __restrict__ m,
                                        const TP* __restrict__ g, int64_t n,
                                        float eta, float beta, float wd) {
  const int64_t stride = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pv = to_f32(p[i]);
    float gv = to_f32(g[i]);
    if (wd != 0.0f) gv = __fadd_rn(gv, __fmul_rn(wd, pv));
    const float m2 = __fadd_rn(__fmul_rn(beta, to_f32(m[i])), gv);
    const float p2 = __fsub_rn(pv, __fmul_rn(eta, m2));
    p[i] = from_f32<TP>(p2);
    m[i] = from_f32<TM>(m2);
  }
}

template <typename TP, typename TM>
void launch(void* p, void* m, const void* g, int64_t n, float eta, float beta,
            float wd, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  fused_sgd_update_kernel<TP, TM><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<TP*>(p), static_cast<TM*>(m), static_cast<const TP*>(g), n,
      eta, beta, wd);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. g has p's type.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int repro_fused_sgd_update(void* p, void* m, const void* g,
                                      int64_t n, int p_dtype, int m_dtype,
                                      float eta, float beta, float wd,
                                      void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == 0 && m_dtype == 0) {
    launch<float, float>(p, m, g, n, eta, beta, wd, s);
  } else if (p_dtype == 0 && m_dtype == 1) {
    launch<float, __nv_bfloat16>(p, m, g, n, eta, beta, wd, s);
  } else if (p_dtype == 1 && m_dtype == 0) {
    launch<__nv_bfloat16, float>(p, m, g, n, eta, beta, wd, s);
  } else if (p_dtype == 1 && m_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(p, m, g, n, eta, beta, wd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
