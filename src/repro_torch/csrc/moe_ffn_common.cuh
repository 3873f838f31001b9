// The grouped SwiGLU expert FFN's passes, shared by the full-width kernel
// (moe_ffn.cu) and the packed-weight kernel (moe_ffn_packed.cu).
//
// For every stacked expert e:  y[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e]
//
//   1. segment_kernel<gate/up loader, 2>: grid (E, column tiles of F, D
//      segments), x.Wg and x.Wu per segment of kSegRows contraction rows.
//   2. swiglu_kernel: hu = silu(sum of gate segments) * (sum of up segments).
//   3. segment_kernel<down loader, 1>: grid (E, column tiles of D, F
//      segments), hu.Wd per segment.
//   4. sum_kernel: y = sum of down segments.
//
// Summation order (load-bearing): a lane sums its segment with fmaf in row
// order; the segments are added in segment order.  Segment boundaries are
// fixed multiples of kSegRows, so an output's summation order is a function
// of (D, F) alone: not of E, C, the columns a lane holds, or the weight
// format.  A loader only turns a stored run of a weight row into fp32
// values; two loaders that produce the same values therefore give the
// same bits.  That is what makes the packed kernel equal, bit for bit, the
// full-width kernel on the dequantized weights, and the engine's one- or
// two-expert waves equal the reference's all-expert call.
//
// A loader L provides:
//   L::kCols   columns one lane covers: one run (one vector load) of the row;
//   L::kAcc    accumulators a lane may hold; rows of x per pass over the
//              weights = max(1, kAcc / (NW * kCols)) (register budget only:
//              it changes how often the weights are read, never a sum);
//   L::Lane    what a lane keeps for one expert (row base, per-column scales);
//   void setup(float* smem16) const      fill block-shared state (a LUT);
//   Lane lane(smem16, e, col, K, N) const
//   static void load(const Lane&, k, col, N, vec_ok, float (&out)[kCols])
//              columns [col, col + kCols) of row k as fp32, zero past N.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegRows = 256;      // contraction rows per segment
constexpr int kElemThreads = 256;

__host__ __device__ __forceinline__ int segments(int k) { return (k + kSegRows - 1) / kSegRows; }

// One warp: expert e = blockIdx.x, columns of tile blockIdx.y, contraction
// rows [s * kSegRows, (s + 1) * kSegRows) with s = blockIdx.z.  x: (E, C, K)
// fp32 rows; w0 (and w1 when NW == 2): K rows of N columns per expert.
// Writes the segment's partial products to part[e][s][m][c][n].
template <class L, int NW>
__global__ void __launch_bounds__(32)
segment_kernel(const float* __restrict__ x, const L w0, const L w1, float* __restrict__ part,
               int C, int K, int N, int vec_ok) {
  constexpr int V = L::kCols;
  constexpr int ROWS = L::kAcc / (NW * V) > 0 ? L::kAcc / (NW * V) : 1;
  __shared__ float smem[16];
  w0.setup(smem);
  __syncwarp();
  const int e = blockIdx.x, s = blockIdx.z, nseg = gridDim.z;
  const int col = (blockIdx.y * 32 + threadIdx.x) * V;
  const int k0 = s * kSegRows, k1 = min(K, k0 + kSegRows);
  const float* xe = x + (size_t)e * C * K;
  typename L::Lane lanes[NW];
  lanes[0] = w0.lane(smem, e, col, K, N);
  if (NW > 1) lanes[NW - 1] = w1.lane(smem, e, col, K, N);
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
      for (int m = 0; m < NW; ++m) L::load(lanes[m], k, col, N, vec_ok != 0, wv[m]);
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

// fp32 elements of the workspace run_ffn needs for these sizes.
size_t workspace_floats(int E, int C, int D, int F) {
  return gate_up_floats(E, C, D, F) + hu_floats(E, C, F) + down_floats(E, C, D, F);
}

unsigned elem_blocks(size_t n) { return (unsigned)((n + kElemThreads - 1) / kElemThreads); }

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The four passes on `stream`.  LG loads gate/up ((E, D, F) logical),
// LD loads down ((E, F, D) logical); vec_a / vec_b: their rows may be read
// as aligned runs.  Returns the first cudaError_t of the launches.
template <class LG, class LD>
int run_ffn(const float* x, const LG& wg, const LG& wu, const LD& wd, float* ws, float* y,
            int E, int C, int D, int F, bool vec_a, bool vec_b, cudaStream_t stream) {
  float* part_a = ws;
  float* hu = part_a + gate_up_floats(E, C, D, F);
  float* part_b = hu + hu_floats(E, C, F);
  constexpr int VA = LG::kCols, VB = LD::kCols;
  cudaError_t err;
  segment_kernel<LG, 2><<<dim3(E, (F + 32 * VA - 1) / (32 * VA), segments(D)), 32, 0, stream>>>(
      x, wg, wu, part_a, C, D, F, vec_a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  swiglu_kernel<<<elem_blocks(hu_floats(E, C, F)), kElemThreads, 0, stream>>>(
      part_a, hu, E, C, F, segments(D));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  segment_kernel<LD, 1><<<dim3(E, (D + 32 * VB - 1) / (32 * VB), segments(F)), 32, 0, stream>>>(
      hu, wd, wd, part_b, C, F, D, vec_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_kernel<<<elem_blocks((size_t)E * C * D), kElemThreads, 0, stream>>>(
      part_b, y, E, C, D, segments(F));
  return (int)cudaGetLastError();
}

}  // namespace
