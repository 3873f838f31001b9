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
// bf16 weights (the bf16 models' engine waves, reference and shadow calls
// and prefill) run on tensor cores: moe_ffn_mma.cuh says how, and why its
// bits depend on neither E nor C.
//
// fp32 weights (the packed slice's model dtype) keep the CUDA-core passes of
// moe_ffn_common.cuh, shared with the packed kernel, which must equal this
// one bit for bit on dequantized weights.  Bound: each weight element feeds
// C multiply-adds, about 1 FLOP per byte at decode, so the time is set by
// the weight bytes, 3*E*D*F*4, over device memory bandwidth (3.35 TB/s).
// Each lane reads 16 contiguous bytes of a weight row (4 fp32 columns), a
// warp a 512-byte run, and each contraction is cut into segments of
// kSegRows rows, one warp per (expert, column tile, segment).  The
// per-segment partials live in a workspace the caller allocates; nothing is
// atomic.  (The TPU kernel carried the down-projection sum across a
// sequential grid axis; blocks here run in no order, so the sum across
// segments is its own pass.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_ffn_common.cuh"
#include "moe_ffn_mma.cuh"

namespace {

template <typename T> struct RunCols;   // columns a lane reads with one 16-byte load
template <> struct RunCols<float> { static constexpr int cols = 4; };

__device__ __forceinline__ float to_float(float v) { return v; }

// The 4 values of one 16-byte load, as floats.
__device__ __forceinline__ void unpack16(uint4 raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
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

int launch(const float* x, const float* wg, const float* wu, const float* wd, float* ws,
           float* y, int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int V = RunCols<float>::cols;
  const bool vec_a = F % V == 0 && aligned16(wg) && aligned16(wu);
  const bool vec_b = D % V == 0 && aligned16(wd);
  return run_ffn(x, DenseWeight<float>{wg}, DenseWeight<float>{wu}, DenseWeight<float>{wd}, ws,
                 y, E, C, D, F, vec_a, vec_b, stream);
}

}  // namespace

// fp32 elements of the workspace moe_ffn_launch needs for these sizes.
extern "C" long long moe_ffn_workspace_floats(int E, int C, int D, int F) {
  return (long long)workspace_floats(E, C, D, F);
}

// fp32 weights.  ws is caller-allocated fp32 workspace of
// moe_ffn_workspace_floats(E, C, D, F) elements.  Launches on `stream` and
// returns the cudaError_t of the launches (0 = success).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu, const void* wd,
                              void* ws, void* y, int E, int C, int D, int F, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(wg),
                static_cast<const float*>(wu), static_cast<const float*>(wd),
                static_cast<float*>(ws), static_cast<float*>(y), E, C, D, F,
                static_cast<cudaStream_t>(stream));
}

// bf16 weights: bytes of workspace and int32 counters a call on the current
// device needs (the counters zero before the first call; every call leaves
// them zero, so calls in order on one stream can share them).
extern "C" long long moe_ffn_bf16_workspace_bytes(int E, int C, int D, int F) {
  return (long long)mma::make_plan(E, C, D, F).bytes;
}

extern "C" long long moe_ffn_bf16_counters(int E, int C, int D, int F) {
  return mma::make_plan(E, C, D, F).counters;
}

// bf16 weights: three launches on `stream`; returns the first cudaError_t (0
// = success).
extern "C" int moe_ffn_bf16_launch(const void* x, const void* wg, const void* wu, const void* wd,
                                   void* ws, void* counters, void* y, int E, int C, int D, int F,
                                   void* stream) {
  return mma::run_ffn_bf16(static_cast<const float*>(x),
                           static_cast<const __nv_bfloat16*>(wg),
                           static_cast<const __nv_bfloat16*>(wu),
                           static_cast<const __nv_bfloat16*>(wd), ws,
                           static_cast<int*>(counters), static_cast<float*>(y), E, C, D, F,
                           static_cast<cudaStream_t>(stream));
}
