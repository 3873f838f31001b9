// Grouped SwiGLU expert FFN on wire-format weights, dequantized as they are
// read from shared memory, for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/moe_gemm/packed.py:147
// `moe_ffn_packed_kernel` (its pallas_call is at :172).  For every stacked
// expert e
//
//     y[e] = (silu(x[e] @ deq(Wg[e])) * (x[e] @ deq(Wu[e]))) @ deq(Wd[e])
//
// with x: (E, C, D) fp32, y: (E, C, D) fp32, fp32 sums, and the weights in
// the tile-aligned device layout of repro_torch.quant.transport.device_layout:
//
//   fp16  Wg/Wu (E, D, F) halves, Wd (E, F, D) halves;
//   int8  codes (E, D, F) + scales (E, 1, F) f32, Wd codes (E, F, D) +
//         scales (E, 1, D): deq = code * scale of the column;
//   nf4   codes (E, D, F/2) + absmax (E, D, F/64), Wd codes (E, F, D/2) +
//         absmax (E, F, D/64); two codes per byte along the row, high nibble
//         first: deq = NF4_LEVELS[code] * absmax of the 64-column run.
//
// Bound: the decode path has C = 1, so each weight byte feeds at most a few
// multiply-adds, and the time is set by the packed bytes (x, codes, scales,
// y) over device memory bandwidth: for an E=2 Mixtral wave about 0.105 ms
// at int8, 0.059 ms at nf4 and 0.21 ms at fp16, against 0.42 ms for fp32
// weights.  So the kernel has to keep as many bytes in flight as the fp32
// one, for fewer of them, and spend few instructions on each code.
//
// Design: the passes, their staging ring, work units, tickets and summation
// order are kernel 1's fp32 ones (moe_ffn_common.cuh); only the format
// differs.  A tile is one run of each packed row, so the same bytes in
// flight carry 2x (fp16), 4x (int8) or 8x (nf4) the columns; int8 and nf4,
// whose codes cost more instructions, run two blocks of four consumer warps
// an SM with shallower rings, fp16 one block of eight as fp32.  A consumer
// thread turns the 32-bit word it reads from shared memory into fp32 values:
// fp16 by conversion; int8 by the exact byte-to-float trick (the code, biased
// by 128, placed by __byte_perm in the mantissa of 2^23, minus 2^23 + 128,
// which equals (float)code); nf4 through the 16 levels in shared memory,
// with the row's absmax of the run staged beside the codes.  The multiply by
// the scale is __fmul_rn, never contracted into the following fmaf.  Each
// weight therefore reaches the fmaf chain with the value dequantize_tiles
// gives it, and the output equals, bit for bit, kernel 1's on the
// dequantized weights.  Wider formats hold more columns a thread, so a row
// tile covers fewer rows of x (the accumulator budget); that changes no sum.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_ffn_common.cuh"

namespace {

using fpass::Operand;
constexpr int kFp16 = 0, kInt8 = 1, kNf4 = 2;    // scheme ids of the C interface
constexpr int kNf4Block = 64;                     // columns per nf4 absmax

struct NoCols {};

// fp16 rows: (E, K, N) halves; element 2j of a word is its low half.
struct Fp16Fmt {
  static constexpr int kV = 2;
  static constexpr int kColsPerAmax = 0;
  static constexpr int kConsumers = 8, kStagesGateUp = 3, kStagesDown = 4;
  static constexpr bool kLut = false;
  static constexpr int kUnroll = 2;
  static constexpr int kRowsGateUp = 8;
  static constexpr int kRowsDown = 16;
  using Cols = NoCols;
  __device__ __forceinline__ static Cols cols(const Operand&, int, int, int) { return {}; }
  __device__ __forceinline__ static void deq(const Cols&, uint32_t word, float, const float*,
                                             float (&out)[kV]) {
    out[0] = __half2float(__ushort_as_half((unsigned short)(word & 0xffffu)));
    out[1] = __half2float(__ushort_as_half((unsigned short)(word >> 16)));
  }
};

// int8 rows: codes (E, K, N), one f32 scale per column (E, 1, N); byte j of
// a word is column n + j.
struct Int8Fmt {
  static constexpr int kV = 4;
  static constexpr int kColsPerAmax = 0;
  static constexpr int kConsumers = 4, kStagesGateUp = 2, kStagesDown = 3;
  static constexpr bool kLut = false;
  static constexpr int kUnroll = 2;
  static constexpr int kRowsGateUp = 4;
  static constexpr int kRowsDown = 8;
  struct Cols { float s[kV]; };
  __device__ __forceinline__ static Cols cols(const Operand& w, int e, int n, int N) {
    Cols c;
    const float* se = w.s + (size_t)e * N;
#pragma unroll
    for (int i = 0; i < kV; ++i) c.s[i] = n + i < N ? __ldg(se + n + i) : 0.f;
    return c;
  }
  __device__ __forceinline__ static void deq(const Cols& c, uint32_t word, float, const float*,
                                             float (&out)[kV]) {
    const uint32_t biased = word ^ 0x80808080u;    // each byte: code + 128
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      // 0x4B0000bb is 2^23 + bb exactly; minus 2^23 + 128 leaves the code
      const float f = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | j));
      out[j] = __fmul_rn(__fsub_rn(f, 8388736.f), c.s[j]);
    }
  }
};

// nf4 rows: codes (E, K, N/2), two per byte along the row, high nibble
// first; absmax (E, K, N/64), one per 64-column run of a row, staged beside
// the codes (a thread's 8 columns share one).  N % 64 == 0.
struct Nf4Fmt {
  static constexpr int kV = 8;
  static constexpr int kColsPerAmax = kNf4Block;
  static constexpr int kConsumers = 4, kStagesGateUp = 2, kStagesDown = 3;
  static constexpr bool kLut = true;
  static constexpr int kUnroll = 1;
  static constexpr int kRowsGateUp = 2;
  static constexpr int kRowsDown = 4;
  using Cols = NoCols;
  __device__ __forceinline__ static Cols cols(const Operand&, int, int, int) { return {}; }
  __device__ __forceinline__ static void deq(const Cols&, uint32_t word, float amax,
                                             const float* lut, float (&out)[kV]) {
    // each byte's high and low code times 4: byte offsets into the levels
    const uint32_t hi = (word >> 2) & 0x3c3c3c3cu, lo = (word << 2) & 0x3c3c3c3cu;
    const char* base = reinterpret_cast<const char*>(lut);
#pragma unroll
    for (int b = 0; b < 4; ++b) {    // byte b holds columns n + 2b (high), n + 2b + 1 (low)
      const uint32_t oh = __byte_perm(hi, 0u, 0x4440u | b);
      const uint32_t ol = __byte_perm(lo, 0u, 0x4440u | b);
      out[2 * b] = __fmul_rn(*reinterpret_cast<const float*>(base + oh), amax);
      out[2 * b + 1] = __fmul_rn(*reinterpret_cast<const float*>(base + ol), amax);
    }
  }
};

template <class F> constexpr bool in_budget() {
  return F::kRowsGateUp * 2 * F::kV <= fpass::kAcc && F::kRowsDown * F::kV <= fpass::kAcc;
}
static_assert(in_budget<Fp16Fmt>() && in_budget<Int8Fmt>() && in_budget<Nf4Fmt>(),
              "accumulator budget");

// The three matrices of a call as operands of its format.
struct Mats {
  Operand g, u, d;
};

Mats mats(const void* g0, const void* g1, const void* u0, const void* u1, const void* d0,
          const void* d1, const void* levels, int scheme) {
  auto op = [&](const void* q, const void* p) {
    const float* f = static_cast<const float*>(p);
    return Operand{static_cast<const unsigned char*>(q), scheme == kNf4 ? f : nullptr,
                   scheme == kInt8 ? f : nullptr, static_cast<const float*>(levels)};
  };
  return {op(g0, g1), op(u0, u1), op(d0, d1)};
}

bool known(int scheme, int D, int F) {
  if (scheme == kNf4) return F % kNf4Block == 0 && D % kNf4Block == 0;
  return scheme == kFp16 || scheme == kInt8;
}

fpass::Plan plan_of(int scheme, int E, int C, int D, int F) {
  if (scheme == kFp16) return fpass::make_plan<Fp16Fmt>(E, C, D, F);
  if (scheme == kInt8) return fpass::make_plan<Int8Fmt>(E, C, D, F);
  return fpass::make_plan<Nf4Fmt>(E, C, D, F);
}

}  // namespace

// scheme: 0 = fp16, 1 = int8, 2 = nf4.  fp32 elements of workspace and int32
// counters a call on the current device needs (-1 for a scheme or widths the
// kernel does not take).  The counters are zero before the first call and
// every call leaves them zero, so calls in order on one stream can share
// them.
extern "C" long long moe_ffn_packed_workspace_floats(int scheme, int E, int C, int D, int F) {
  return known(scheme, D, F) ? plan_of(scheme, E, C, D, F).floats : -1;
}

extern "C" long long moe_ffn_packed_counters(int scheme, int E, int C, int D, int F) {
  return known(scheme, D, F) ? plan_of(scheme, E, C, D, F).counters : -1;
}

// g0/u0/d0 are the codes (halves for fp16) of w_gate/w_up/w_down, g1/u1/d1
// their scales (int8) or absmax (nf4), null for fp16; levels: 16 fp32 NF4
// levels on the device (nf4 only).  Two launches on `stream`; returns the
// first cudaError_t (0 = success).
extern "C" int moe_ffn_packed_launch(int scheme, const void* x, const void* g0, const void* g1,
                                     const void* u0, const void* u1, const void* d0,
                                     const void* d1, const void* levels, void* ws,
                                     void* counters, void* y, int E, int C, int D, int F,
                                     void* stream) {
  if (!known(scheme, D, F)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  float* yf = static_cast<float*>(y);
  const Mats m = mats(g0, g1, u0, u1, d0, d1, levels, scheme);
  if (scheme == kFp16)
    return fpass::run_ffn<Fp16Fmt>(xf, m.g, m.u, m.d, wsf, cnt, yf, E, C, D, F, s);
  if (scheme == kInt8)
    return fpass::run_ffn<Int8Fmt>(xf, m.g, m.u, m.d, wsf, cnt, yf, E, C, D, F, s);
  return fpass::run_ffn<Nf4Fmt>(xf, m.g, m.u, m.d, wsf, cnt, yf, E, C, D, F, s);
}
