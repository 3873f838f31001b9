// Grouped SwiGLU expert FFN for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gemm/kernel.py:61
// `moe_ffn_kernel` (its pallas_call is at :69).  For every stacked expert e
//
//     y[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e]
//
// with x: (E, C, D) fp32, Wg/Wu: (E, D, F), Wd: (E, F, D) in bf16 or fp32,
// y: (E, C, D) fp32.  The x side and every sum stay in fp32, as in the
// reference kernel on this path.
//
// Bound: on the decode path C is 1 (16 for a prompt), so each weight element
// feeds C multiply-adds: about 1 FLOP per byte, far under the card's ridge.
// The time is set by the weight bytes, 3*E*D*F*sizeof(W), over device memory
// bandwidth (3.35 TB/s): 0.21 ms for an E=2 bf16 Mixtral wave, 0.84 ms for
// all 8 experts.  Design for that bound: keep many 16-byte loads in flight.
// Each lane reads 16 contiguous bytes of a weight row (8 bf16 columns), a
// warp a 512-byte run, and each contraction is cut into segments of
// kSegRows rows, one warp per (expert, column tile, segment), so even a
// one- or two-expert wave puts a couple of thousand warps on the card.
// The passes and their summation order are in moe_ffn_common.cuh; this
// file holds the loaders for full-width weights.  The per-segment partials
// live in a workspace the caller allocates; nothing is atomic.  (The TPU
// kernel carried the down-projection sum across a sequential grid axis;
// blocks here run in no order, so the sum across segments is its own pass.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_ffn_common.cuh"

namespace {

template <typename T> struct RunCols;   // columns a lane reads with one 16-byte load
template <> struct RunCols<float> { static constexpr int cols = 4; };
template <> struct RunCols<__nv_bfloat16> { static constexpr int cols = 8; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// The V values of one 16-byte load, as floats, in register arithmetic only.
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[8]) {
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {       // bf16 -> fp32 is exact: the top 16 bits
    out[2 * j] = __uint_as_float(words[j] << 16);
    out[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
  }
}

// Columns [col, col + V) of a row of length n as floats, zero past the end.
// vec_ok: n % V == 0 and the row pointers are 16-byte aligned, so the run
// is one aligned 16-byte load; otherwise element by element.  Both paths
// hand the same values to the same sums.
template <typename T>
__device__ __forceinline__ void load_run(const T* __restrict__ row, int col, int n,
                                         bool vec_ok, float (&out)[RunCols<T>::cols]) {
  constexpr int V = RunCols<T>::cols;
  if (vec_ok) {
    if (col < n) {
      unpack16(__ldg(reinterpret_cast<const uint4*>(row + col)), out);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) out[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = col + i < n ? to_float(row[col + i]) : 0.f;
  }
}

// Full-width weight rows of T: (E, K, N) contiguous.
template <typename T>
struct DenseWeight {
  static constexpr int kCols = RunCols<T>::cols;
  static constexpr int kAcc = 8 * kCols;
  const T* w;
  struct Lane { const T* rows; };
  __device__ __forceinline__ void setup(float*) const {}
  __device__ __forceinline__ Lane lane(const float*, int e, int, int K, int N) const {
    return {w + (size_t)e * K * N};
  }
  __device__ __forceinline__ static void load(const Lane& l, int k, int col, int n, bool vec_ok,
                                              float (&out)[kCols]) {
    load_run(l.rows + (size_t)k * n, col, n, vec_ok, out);
  }
};

template <typename T>
int launch(const float* x, const T* wg, const T* wu, const T* wd, float* ws, float* y,
           int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int V = RunCols<T>::cols;
  const bool vec_a = F % V == 0 && aligned16(wg) && aligned16(wu);
  const bool vec_b = D % V == 0 && aligned16(wd);
  return run_ffn(x, DenseWeight<T>{wg}, DenseWeight<T>{wu}, DenseWeight<T>{wd}, ws, y,
                 E, C, D, F, vec_a, vec_b, stream);
}

}  // namespace

// fp32 elements of the workspace moe_ffn_launch needs for these sizes.
extern "C" long long moe_ffn_workspace_floats(int E, int C, int D, int F) {
  return (long long)workspace_floats(E, C, D, F);
}

// weight_dtype: 0 = fp32, 1 = bf16.  ws is caller-allocated fp32 workspace of
// moe_ffn_workspace_floats(E, C, D, F) elements.  Launches on `stream` and
// returns the cudaError_t of the launches (0 = success).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu, const void* wd,
                              void* ws, void* y, int E, int C, int D, int F,
                              int weight_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* wsf = static_cast<float*>(ws);
  float* yf = static_cast<float*>(y);
  if (weight_dtype == 1)
    return launch(xf, static_cast<const __nv_bfloat16*>(wg), static_cast<const __nv_bfloat16*>(wu),
                  static_cast<const __nv_bfloat16*>(wd), wsf, yf, E, C, D, F, s);
  if (weight_dtype == 0)
    return launch(xf, static_cast<const float*>(wg), static_cast<const float*>(wu),
                  static_cast<const float*>(wd), wsf, yf, E, C, D, F, s);
  return (int)cudaErrorInvalidValue;
}
