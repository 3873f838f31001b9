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
//
//   1. grid (E, column tiles of F, D segments): x.Wg and x.Wu per segment.
//   2. elementwise: hu = silu(sum of gate segments) * (sum of up segments).
//   3. grid (E, column tiles of D, F segments): hu.Wd per segment.
//   4. elementwise: y = sum of down segments.
// The per-segment partials live in a workspace the caller allocates; nothing
// is atomic.  (The TPU kernel carried the down-projection sum across a
// sequential grid axis; blocks here run in no order, so the sum across
// segments is its own pass.)
//
// Summation order (load-bearing): a lane sums its segment in row order and
// the segments are added in segment order.  Segment boundaries are fixed
// multiples of kSegRows, so an output's summation order is a function of
// (D, F) alone: it does not depend on E, C, which block holds the row, or
// which experts were stacked.  The OD-MoE engine stacks only a wave's one or
// two experts while the dense reference stacks all of them; equal
// per-(row, expert) bits in both is what makes the engine's tokens equal the
// reference's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegRows = 256;      // contraction rows per segment
constexpr int kElemThreads = 256;

template <typename T> struct Lane;   // columns a lane reads with one 16-byte load
template <> struct Lane<float> { static constexpr int cols = 4; };
template <> struct Lane<__nv_bfloat16> { static constexpr int cols = 8; };

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
                                         bool vec_ok, float (&out)[Lane<T>::cols]) {
  constexpr int V = Lane<T>::cols;
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

__host__ __device__ __forceinline__ int segments(int k) { return (k + kSegRows - 1) / kSegRows; }

// One warp: expert e = blockIdx.x, columns of tile blockIdx.y, contraction
// rows [s * kSegRows, (s + 1) * kSegRows) with s = blockIdx.z.  x: (E, C, K)
// fp32 rows; w0 (and w1 when NW == 2): (E, K, N).  Writes the segment's
// partial products to part[e][s][m][c][n].
template <typename T, int NW>
__global__ void __launch_bounds__(32)
segment_kernel(const float* __restrict__ x, const T* __restrict__ w0,
               const T* __restrict__ w1, float* __restrict__ part, int C, int K, int N,
               int vec_ok) {
  constexpr int V = Lane<T>::cols;
  constexpr int ROWS = 8 / NW;     // rows of x per pass over the weights
  const int e = blockIdx.x, s = blockIdx.z, nseg = gridDim.z;
  const int col = (blockIdx.y * 32 + threadIdx.x) * V;
  const int k0 = s * kSegRows, k1 = min(K, k0 + kSegRows);
  const float* xe = x + (size_t)e * C * K;
  const T* w[NW];
  w[0] = w0 + (size_t)e * K * N;
  if (NW > 1) w[NW - 1] = w1 + (size_t)e * K * N;
  for (int c0 = 0; c0 < C; c0 += ROWS) {
    const int nc = min(ROWS, C - c0);
    float acc[NW][ROWS][V];
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int c = 0; c < ROWS; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[m][c][i] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float wv[NW][V];
#pragma unroll
      for (int m = 0; m < NW; ++m) load_run(w[m] + (size_t)k * N, col, N, vec_ok != 0, wv[m]);
#pragma unroll
      for (int c = 0; c < ROWS; ++c) {
        if (c < nc) {
          const float xv = __ldg(xe + (size_t)(c0 + c) * K + k);
#pragma unroll
          for (int m = 0; m < NW; ++m)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[m][c][i] = fmaf(xv, wv[m][i], acc[m][c][i]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < NW; ++m)
#pragma unroll
      for (int c = 0; c < ROWS; ++c) {
        if (c >= nc) continue;
        float* out = part + (((size_t)(e * nseg + s) * NW + m) * C + c0 + c) * N;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (col + i < N) out[col + i] = acc[m][c][i];
      }
  }
}

// hu[e][c][f] = silu(sum_s gate[e][s]) * sum_s up[e][s], segments in order.
__global__ void swiglu_kernel(const float* __restrict__ part, float* __restrict__ hu,
                              int E, int C, int F, int nseg) {
  const size_t per_e = (size_t)C * F;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)E * per_e) return;
  const size_t e = i / per_e, r = i % per_e;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < nseg; ++s) {
    g += part[((e * nseg + s) * 2 + 0) * per_e + r];
    u += part[((e * nseg + s) * 2 + 1) * per_e + r];
  }
  hu[i] = g / (1.f + expf(-g)) * u;
}

// y[e][c][d] = sum_s down[e][s][c][d], segments in order.
__global__ void sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                           int E, int C, int D, int nseg) {
  const size_t per_e = (size_t)C * D;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)E * per_e) return;
  const size_t e = i / per_e, r = i % per_e;
  float v = 0.f;
  for (int s = 0; s < nseg; ++s) v += part[(e * nseg + s) * per_e + r];
  y[i] = v;
}

size_t gate_up_floats(int E, int C, int D, int F) { return (size_t)E * segments(D) * 2 * C * F; }
size_t hu_floats(int E, int C, int F) { return (size_t)E * C * F; }
size_t down_floats(int E, int C, int D, int F) { return (size_t)E * segments(F) * C * D; }

unsigned elem_blocks(size_t n) { return (unsigned)((n + kElemThreads - 1) / kElemThreads); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const float* x, const T* wg, const T* wu, const T* wd, float* ws, float* y,
           int E, int C, int D, int F, cudaStream_t stream) {
  constexpr int V = Lane<T>::cols;
  float* part_a = ws;
  float* hu = part_a + gate_up_floats(E, C, D, F);
  float* part_b = hu + hu_floats(E, C, F);
  const int vec_a = F % V == 0 && aligned16(wg) && aligned16(wu);
  const int vec_b = D % V == 0 && aligned16(wd);
  cudaError_t err;
  segment_kernel<T, 2><<<dim3(E, (F + 32 * V - 1) / (32 * V), segments(D)), 32, 0, stream>>>(
      x, wg, wu, part_a, C, D, F, vec_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  swiglu_kernel<<<elem_blocks(hu_floats(E, C, F)), kElemThreads, 0, stream>>>(
      part_a, hu, E, C, F, segments(D));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  segment_kernel<T, 1><<<dim3(E, (D + 32 * V - 1) / (32 * V), segments(F)), 32, 0, stream>>>(
      hu, wd, wd, part_b, C, F, D, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_kernel<<<elem_blocks((size_t)E * C * D), kElemThreads, 0, stream>>>(
      part_b, y, E, C, D, segments(F));
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 elements of the workspace moe_ffn_launch needs for these sizes.
extern "C" long long moe_ffn_workspace_floats(int E, int C, int D, int F) {
  return (long long)(gate_up_floats(E, C, D, F) + hu_floats(E, C, F) + down_floats(E, C, D, F));
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
