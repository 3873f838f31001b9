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
// fp32 weights (the packed slice's model dtype, its SEP shadow and its
// greedy_generate reference) run on CUDA cores, through the passes of
// moe_ffn_common.cuh, which the packed kernel shares and must equal bit for
// bit on dequantized weights.  Bound: each weight element feeds C
// multiply-adds, about 1 FLOP per byte at decode, so the time is set by the
// weight bytes, 3*E*D*F*4, over device memory bandwidth (3.35 TB/s): 0.42 ms
// for an E=2 Mixtral wave.  The passes keep enough bytes in flight with a
// producer warp filling a ring of shared-memory stages with tensor-map boxes,
// feed every row of x from each staged weight row, draw their work units
// from a counter, and fold SwiGLU and the segment sums into two launches
// (moe_ffn_common.cuh says how).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_ffn_common.cuh"
#include "moe_ffn_mma.cuh"

namespace {

// fp32 rows: (E, K, N) floats, one column a word.
struct Fp32Fmt {
  static constexpr int kV = 1;
  static constexpr int kColsPerAmax = 0;
  static constexpr int kConsumers = 8, kStagesGateUp = 3, kStagesDown = 4;
  static constexpr bool kLut = false;
  static constexpr int kUnroll = 2;
  static constexpr int kRowsGateUp = 16;
  static constexpr int kRowsDown = 16;
  struct Cols {};
  __device__ __forceinline__ static Cols cols(const fpass::Operand&, int, int, int) { return {}; }
  __device__ __forceinline__ static void deq(const Cols&, uint32_t word, float, const float*,
                                             float (&out)[kV]) {
    out[0] = __uint_as_float(word);
  }
};
static_assert(Fp32Fmt::kRowsGateUp * 2 * Fp32Fmt::kV <= fpass::kAcc, "accumulator budget");

fpass::Operand operand(const void* w) {
  return {static_cast<const unsigned char*>(w), nullptr, nullptr, nullptr};
}

}  // namespace

// fp32 weights: fp32 elements of workspace and int32 counters a call on the
// current device needs (the counters zero before the first call; every call
// leaves them zero, so calls in order on one stream can share them).
extern "C" long long moe_ffn_workspace_floats(int E, int C, int D, int F) {
  return fpass::make_plan<Fp32Fmt>(E, C, D, F).floats;
}

extern "C" long long moe_ffn_counters(int E, int C, int D, int F) {
  return fpass::make_plan<Fp32Fmt>(E, C, D, F).counters;
}

// fp32 weights: two launches on `stream`; returns the first cudaError_t (0 =
// success).
extern "C" int moe_ffn_launch(const void* x, const void* wg, const void* wu, const void* wd,
                              void* ws, void* counters, void* y, int E, int C, int D, int F,
                              void* stream) {
  return fpass::run_ffn<Fp32Fmt>(static_cast<const float*>(x), operand(wg), operand(wu),
                                 operand(wd), static_cast<float*>(ws),
                                 static_cast<int*>(counters), static_cast<float*>(y), E, C, D, F,
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
