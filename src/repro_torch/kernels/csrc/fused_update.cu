// Fused momentum-SGD update for Hopper (sm_90a), over many leaves at once.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update/kernel.py:33
// (fused_sgd_update; body _upd_kernel at :21, pallas_call at :46).
//
//   g += wd * p;  m' = beta * m + g;  p' = p - eta * m'
//
// in float32, with p' and m' written back in p's and m's own types
// (float32 or bfloat16); g is of p's type or float32 (a float32
// accumulated microbatch gradient of a bfloat16 parameter is read as it
// is, as the reference adds it in float32). The update runs IN PLACE. One
// launch covers a whole table of leaves (each the N stacked client
// replicas of one parameter leaf) of one (p type, m type, g type) triple: the simulator's local step
// updates its whole parameter tree with one launch, where the TPU path and
// this kernel's first version launched once per leaf. eta, beta and wd are
// run-time arguments (eta changes every local step), where the Pallas
// kernel baked them in.
//
// Bound: memory. Each element reads p, m, g and writes p, m: 20 bytes in
// float32 for 4 flops, so the update of a tree can at best run at 3.35 TB/s
// (H100 SXM HBM3) over 20 B x the tree's elements. The logreg tree, (32,
// 784) floats, is 0.5 MB and 0.15 us: there the launch is the floor. The
// MLP tree (8 leaves, 32 x 94,081 floats) moves 60 MB, 18 us at that rate;
// inside a local step the gradient's kernels run between two updates, and
// the update reads its p, m and g from HBM.
//
// Design:
// - The leaf table travels by value as a __grid_constant__ kernel parameter
//   (three pointers, the element count and the first tile of each leaf), so
//   a launch needs no device allocation and no copy. A one-leaf launch
//   takes a one-leaf table, which names its leaf at compile time: that
//   keeps it as fast as a plain one-leaf kernel.
// - The work is cut into tiles of THREADS vectors of 16 bytes of p (4
//   floats or 8 bfloat16), each leaf into whole tiles; a block finds a
//   tile's leaf by a binary search of the tile prefix. A block per tile:
//   one wave of resident blocks with a grid stride was no faster on the MLP
//   tree and slower on a 400 MB one (PERF.md, section 6). The logreg leaf
//   takes 49 blocks.
// - A thread issues all its loads (16 bytes of p, and m's and g's 8, 16
//   or 32 bytes for the same elements) before its arithmetic. A leaf whose
//   pointers are not all 16-byte aligned takes a scalar loop in the same
//   launch (neighbouring threads on neighbouring elements); a vector cut by
//   a leaf's end is done element by element.
// - Built with -fmad=false, every operation rounded on its own, in the
//   plain version's order: p' and m' equal it bit for bit in float32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 64;   // per launch; a longer table takes more
constexpr int THREADS = 128;

// The leaf table, passed by value (a 64-leaf table is 2.4 KB of the
// kernel's parameter space)
template <int CAP>
struct LeafTable {
  void* p[CAP];
  void* m[CAP];
  const void* g[CAP];
  int64_t n[CAP];
  int tile0[CAP + 1];           // first tile of each leaf; then the total
  unsigned char aligned[CAP];   // p, m and g all 16-byte aligned
  int n_leaves;
};

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

__device__ __forceinline__ float update(float& pv, float mv, float gv,
                                        float eta, float beta, float wd) {
  if (wd != 0.0f) gv = __fadd_rn(gv, __fmul_rn(wd, pv));
  const float m2 = __fadd_rn(__fmul_rn(beta, mv), gv);
  pv = __fsub_rn(pv, __fmul_rn(eta, m2));
  return m2;
}

// V elements of type T as raw 16-byte words (V * sizeof(T) is 8, 16 or 32
// bytes): loaded and stored whole, unpacked to float32 in registers
template <typename T, int V>
struct Vec {
  static constexpr int WORDS = (V * (int)sizeof(T) + 15) / 16;
  static constexpr int BYTES = V * (int)sizeof(T);
  uint4 w[WORDS];
  __device__ __forceinline__ void load(const T* src) {
    if constexpr (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      w[0] = make_uint4(u.x, u.y, 0u, 0u);
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i)
        w[i] = reinterpret_cast<const uint4*>(src)[i];
    }
  }
  __device__ __forceinline__ void store(T* dst) const {
    if constexpr (BYTES == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0].x, w[0].y);
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) reinterpret_cast<uint4*>(dst)[i] = w[i];
    }
  }
  __device__ __forceinline__ T* elems() { return reinterpret_cast<T*>(w); }
  __device__ __forceinline__ const T* elems() const {
    return reinterpret_cast<const T*>(w);
  }
};

template <typename TP, typename TM, typename TG, int CAP>
__global__ void __launch_bounds__(THREADS)
fused_sgd_update_kernel(const __grid_constant__ LeafTable<CAP> t, float eta,
                        float beta, float wd) {
  constexpr int V = 16 / (int)sizeof(TP);   // elements per thread per tile
  constexpr int TILE = THREADS * V;
  const int tile = blockIdx.x;
  int lo = 0;   // the leaf holding this tile (a constant for one leaf)
  if constexpr (CAP > 1) {
    int hi = t.n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.tile0[mid] <= tile) lo = mid; else hi = mid - 1;
    }
  }
  TP* p = static_cast<TP*>(t.p[lo]);
  TM* m = static_cast<TM*>(t.m[lo]);
  const TG* g = static_cast<const TG*>(t.g[lo]);
  const int64_t n = t.n[lo];
  const int64_t base = (int64_t)(tile - t.tile0[lo]) * TILE;
  const int64_t e0 = base + (int64_t)threadIdx.x * V;
  if (t.aligned[lo] && e0 + V <= n) {
    Vec<TP, V> pv;
    Vec<TM, V> mv;
    Vec<TG, V> gv;
    pv.load(p + e0);
    mv.load(m + e0);
    gv.load(g + e0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float pk = to_f32(pv.elems()[k]);
      const float m2 = update(pk, to_f32(mv.elems()[k]),
                              to_f32(gv.elems()[k]), eta, beta, wd);
      pv.elems()[k] = from_f32<TP>(pk);
      mv.elems()[k] = from_f32<TM>(m2);
    }
    pv.store(p + e0);
    mv.store(m + e0);
  } else {
    // a leaf that is not 16-byte aligned: the whole tile element by
    // element, neighbouring threads on neighbouring elements; an aligned
    // leaf's vector cut by its end: that vector's elements
    const bool whole = !t.aligned[lo];
    const int64_t first = whole ? base + threadIdx.x : e0;
    const int64_t step = whole ? THREADS : 1;
    int64_t end = whole ? base + TILE : e0 + V;
    if (end > n) end = n;
    for (int64_t i = first; i < end; i += step) {
      float pk = to_f32(p[i]);
      const float m2 = update(pk, to_f32(m[i]), to_f32(g[i]), eta, beta, wd);
      p[i] = from_f32<TP>(pk);
      m[i] = from_f32<TM>(m2);
    }
  }
}

// Build the table of rows (p, m, g, n as int64 words) and launch.
template <typename TP, typename TM, typename TG, int CAP>
cudaError_t launch(const int64_t* leaves, int n_leaves, float eta, float beta,
                   float wd, cudaStream_t stream) {
  constexpr int64_t TILE = THREADS * (16 / (int)sizeof(TP));
  LeafTable<CAP> t;
  t.n_leaves = n_leaves;
  int64_t tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const int64_t* row = leaves + 4 * l;
    if (row[3] <= 0) return cudaErrorInvalidValue;
    t.p[l] = reinterpret_cast<void*>(row[0]);
    t.m[l] = reinterpret_cast<void*>(row[1]);
    t.g[l] = reinterpret_cast<const void*>(row[2]);
    t.n[l] = row[3];
    t.aligned[l] = ((row[0] | row[1] | row[2]) & 15) == 0;
    t.tile0[l] = (int)tiles;
    tiles += (row[3] + TILE - 1) / TILE;
    if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  }
  t.tile0[n_leaves] = (int)tiles;
  fused_sgd_update_kernel<TP, TM, TG, CAP>
      <<<(unsigned)tiles, THREADS, 0, stream>>>(t, eta, beta, wd);
  return cudaGetLastError();
}

// a one-leaf table for one leaf, else a full one
template <typename TP, typename TM, typename TG>
cudaError_t launch_cap(const int64_t* leaves, int n_leaves, float eta,
                       float beta, float wd, cudaStream_t stream) {
  if (n_leaves == 1)
    return launch<TP, TM, TG, 1>(leaves, 1, eta, beta, wd, stream);
  return launch<TP, TM, TG, MAX_LEAVES>(leaves, n_leaves, eta, beta, wd,
                                        stream);
}

// g of p's type, or float32 with a bfloat16 p
template <typename TP, typename TM>
cudaError_t launch_g(const int64_t* leaves, int n_leaves, int p_dtype,
                     int g_dtype, float eta, float beta, float wd,
                     cudaStream_t stream) {
  if (g_dtype == p_dtype)
    return launch_cap<TP, TM, TP>(leaves, n_leaves, eta, beta, wd, stream);
  if (p_dtype == 1 && g_dtype == 0)
    return launch_cap<TP, TM, float>(leaves, n_leaves, eta, beta, wd, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// leaves: n_leaves rows of four int64 words (p, m, g pointers, element
// count), 1 <= n_leaves <= 64, every count > 0; g has p's type, or is
// float32 with a bfloat16 p. dtype codes: 0 = float32, 1 = bfloat16. One
// launch for the whole table. Returns cudaGetLastError() after the launch
// (0 = cudaSuccess).
extern "C" int repro_fused_sgd_update(const int64_t* leaves, int n_leaves,
                                      int p_dtype, int m_dtype, int g_dtype,
                                      float eta, float beta, float wd,
                                      void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_dtype == 0 && m_dtype == 0) {
    err = launch_g<float, float>(leaves, n_leaves, p_dtype, g_dtype, eta,
                                 beta, wd, s);
  } else if (p_dtype == 0 && m_dtype == 1) {
    err = launch_g<float, __nv_bfloat16>(leaves, n_leaves, p_dtype, g_dtype,
                                         eta, beta, wd, s);
  } else if (p_dtype == 1 && m_dtype == 0) {
    err = launch_g<__nv_bfloat16, float>(leaves, n_leaves, p_dtype, g_dtype,
                                         eta, beta, wd, s);
  } else if (p_dtype == 1 && m_dtype == 1) {
    err = launch_g<__nv_bfloat16, __nv_bfloat16>(leaves, n_leaves, p_dtype,
                                                 g_dtype, eta, beta, wd, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
