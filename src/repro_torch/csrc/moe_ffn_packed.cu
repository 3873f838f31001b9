// Grouped SwiGLU expert FFN on wire-format weights, dequantized in registers,
// for Hopper (sm_90a), plain C interface.
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
// at int8 and 0.059 ms at nf4 against 0.42 ms for fp32 weights.  Design:
// the passes, their summation order and the one-warp-per-(expert, column
// tile, 256-row segment) grid are kernel 1's (moe_ffn_common.cuh); only the
// loaders differ.  A lane reads one run of a packed row (16 bytes: 8 fp16
// or 16 int8 columns; 8 bytes: 16 nf4 columns) and turns it into fp32
// values in registers.
// Dequantization is elementwise and exact: the multiply is __fmul_rn, so it
// is never contracted into the following fmaf, and the nf4 table is the
// caller's copy of NF4_LEVELS.  Each weight therefore reaches the fmaf loop
// with the value dequantize_tiles gives it, and the output equals, bit for
// bit, kernel 1's on the dequantized weights.  Wider runs hold more columns
// per lane, so fewer rows of x share a pass over the weights (kAcc), which
// keeps the accumulators in registers; that changes no sum.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_ffn_common.cuh"

namespace {

constexpr int kFp16 = 0, kInt8 = 1, kNf4 = 2;    // scheme ids of the C interface
constexpr int kNf4Block = 64;                     // columns per nf4 absmax

__device__ __forceinline__ void words(uint4 raw, uint32_t (&w)[4]) {
  w[0] = raw.x;
  w[1] = raw.y;
  w[2] = raw.z;
  w[3] = raw.w;
}

// fp16 rows: (E, K, N) halves.
struct Fp16Weight {
  static constexpr int kCols = 8;
  static constexpr int kRunBytes = 16;
  static constexpr int kAcc = 64;
  const __half* q;
  struct Lane { const __half* rows; };
  __device__ __forceinline__ void setup(float*) const {}
  __device__ __forceinline__ Lane lane(const float*, int e, int, int K, int N) const {
    return {q + (size_t)e * K * N};
  }
  __device__ __forceinline__ static void load(const Lane& l, int k, int col, int n, bool vec_ok,
                                              float (&out)[kCols]) {
    const __half* row = l.rows + (size_t)k * n;
    if (vec_ok) {
      if (col < n) {
        uint32_t w[4];
        words(__ldg(reinterpret_cast<const uint4*>(row + col)), w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {   // element 2j is the low half of word j
          out[2 * j] = __half2float(__ushort_as_half((unsigned short)(w[j] & 0xffffu)));
          out[2 * j + 1] = __half2float(__ushort_as_half((unsigned short)(w[j] >> 16)));
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) out[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) out[i] = col + i < n ? __half2float(row[col + i]) : 0.f;
    }
  }
};

// int8 rows: codes (E, K, N), one f32 scale per column (E, 1, N).
struct Int8Weight {
  static constexpr int kCols = 16;
  static constexpr int kRunBytes = 16;
  static constexpr int kAcc = 64;
  const int8_t* q;
  const float* scale;
  struct Lane { const int8_t* rows; float s[kCols]; };
  __device__ __forceinline__ void setup(float*) const {}
  __device__ __forceinline__ Lane lane(const float*, int e, int col, int K, int N) const {
    Lane l;
    l.rows = q + (size_t)e * K * N;
    const float* se = scale + (size_t)e * N;
#pragma unroll
    for (int i = 0; i < kCols; ++i) l.s[i] = col + i < N ? __ldg(se + col + i) : 0.f;
    return l;
  }
  __device__ __forceinline__ static void load(const Lane& l, int k, int col, int n, bool vec_ok,
                                              float (&out)[kCols]) {
    const int8_t* row = l.rows + (size_t)k * n;
    if (vec_ok) {
      if (col < n) {
        uint32_t w[4];
        words(__ldg(reinterpret_cast<const uint4*>(row + col)), w);
#pragma unroll
        for (int b = 0; b < kCols; ++b) {   // byte b of the run is column col + b
          const int8_t code = (int8_t)(uint8_t)(w[b >> 2] >> (8 * (b & 3)));
          out[b] = __fmul_rn((float)code, l.s[b]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) out[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        out[i] = col + i < n ? __fmul_rn((float)row[col + i], l.s[i]) : 0.f;
    }
  }
};

// nf4 rows: codes (E, K, N/2), two per byte along the row, high nibble first;
// absmax (E, K, N/64), one per 64-column run of a row.  N % 64 == 0.  A lane
// reads 8 bytes (16 columns) per row: 32 columns would need 64 accumulators
// and 64 dequantized values per weight pair, which spills.
struct Nf4Weight {
  static constexpr int kCols = 16;
  static constexpr int kRunBytes = 8;
  static constexpr int kAcc = 64;
  const uint8_t* q;
  const float* absmax;
  const float* levels;    // the 16 NF4 levels, fp32, on the device
  struct Lane { const uint8_t* rows; const float* amax; const float* lut; };
  __device__ __forceinline__ void setup(float* smem) const {
    if (threadIdx.x < 16) smem[threadIdx.x] = __ldg(levels + threadIdx.x);
  }
  __device__ __forceinline__ Lane lane(const float* smem, int e, int, int K, int N) const {
    return {q + (size_t)e * K * (N / 2), absmax + (size_t)e * K * (N / kNf4Block), smem};
  }
  __device__ __forceinline__ static void load(const Lane& l, int k, int col, int n, bool vec_ok,
                                              float (&out)[kCols]) {
    const uint8_t* row = l.rows + (size_t)k * (n / 2);
    const float* am = l.amax + (size_t)k * (n / kNf4Block);
    if (vec_ok) {
      if (col < n) {            // col % 16 == 0: the whole run shares one absmax
        const uint2 raw = __ldg(reinterpret_cast<const uint2*>(row + col / 2));
        const uint32_t w[2] = {raw.x, raw.y};
        const float a = __ldg(am + col / kNf4Block);
#pragma unroll
        for (int b = 0; b < 8; ++b) {   // byte b holds columns col + 2b, col + 2b + 1
          const uint32_t byte = (w[b >> 2] >> (8 * (b & 3))) & 0xffu;
          out[2 * b] = __fmul_rn(l.lut[byte >> 4], a);
          out[2 * b + 1] = __fmul_rn(l.lut[byte & 0xfu], a);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCols; ++i) out[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = col + i;
        if (c < n) {
          const uint32_t byte = row[c / 2];
          const uint32_t code = (c & 1) ? (byte & 0xfu) : (byte >> 4);
          out[i] = __fmul_rn(l.lut[code], __ldg(am + c / kNf4Block));
        } else {
          out[i] = 0.f;
        }
      }
    }
  }
};

// Whether rows of n columns can be read as aligned runs: whole runs per row
// and aligned row starts.
template <class W>
bool vec_rows(int n, const void* codes) {
  return n % W::kCols == 0 && (reinterpret_cast<uintptr_t>(codes) % W::kRunBytes) == 0;
}

}  // namespace

// fp32 elements of the workspace moe_ffn_packed_launch needs for these sizes.
extern "C" long long moe_ffn_packed_workspace_floats(int E, int C, int D, int F) {
  return (long long)workspace_floats(E, C, D, F);
}

// scheme: 0 = fp16, 1 = int8, 2 = nf4.  g0/u0/d0 are the codes (halves for
// fp16) of w_gate/w_up/w_down, g1/u1/d1 their scales (int8) or absmax (nf4),
// null for fp16; levels: 16 fp32 NF4 levels on the device (nf4 only).  ws is
// caller-allocated fp32 workspace of moe_ffn_packed_workspace_floats(E, C,
// D, F) elements.  Launches on `stream` and returns the cudaError_t of the
// launches (0 = success).
extern "C" int moe_ffn_packed_launch(int scheme, const void* x, const void* g0, const void* g1,
                                     const void* u0, const void* u1, const void* d0,
                                     const void* d1, const void* levels, void* ws, void* y,
                                     int E, int C, int D, int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* wsf = static_cast<float*>(ws);
  float* yf = static_cast<float*>(y);
  if (scheme == kFp16) {
    using W = Fp16Weight;
    const W wg{static_cast<const __half*>(g0)}, wu{static_cast<const __half*>(u0)},
        wd{static_cast<const __half*>(d0)};
    return run_ffn(xf, wg, wu, wd, wsf, yf, E, C, D, F, vec_rows<W>(F, g0) && vec_rows<W>(F, u0),
                   vec_rows<W>(D, d0), s);
  }
  if (scheme == kInt8) {
    using W = Int8Weight;
    const W wg{static_cast<const int8_t*>(g0), static_cast<const float*>(g1)},
        wu{static_cast<const int8_t*>(u0), static_cast<const float*>(u1)},
        wd{static_cast<const int8_t*>(d0), static_cast<const float*>(d1)};
    return run_ffn(xf, wg, wu, wd, wsf, yf, E, C, D, F, vec_rows<W>(F, g0) && vec_rows<W>(F, u0),
                   vec_rows<W>(D, d0), s);
  }
  if (scheme == kNf4) {
    if (F % kNf4Block != 0 || D % kNf4Block != 0) return (int)cudaErrorInvalidValue;
    using W = Nf4Weight;
    const float* lv = static_cast<const float*>(levels);
    const W wg{static_cast<const uint8_t*>(g0), static_cast<const float*>(g1), lv},
        wu{static_cast<const uint8_t*>(u0), static_cast<const float*>(u1), lv},
        wd{static_cast<const uint8_t*>(d0), static_cast<const float*>(d1), lv};
    return run_ffn(xf, wg, wu, wd, wsf, yf, E, C, D, F, vec_rows<W>(F, g0) && vec_rows<W>(F, u0),
                   vec_rows<W>(D, d0), s);
  }
  return (int)cudaErrorInvalidValue;
}
