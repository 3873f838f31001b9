// w8a16 dequantizing matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/int8_matmul/kernel.py:56
// `int8_matmul_kernel` (its pallas_call is at :64).  It computes
//
//     y[m, n] = (sum_k x[m, k] * float(w_q[k, n])) * scale[n]
//
// with x: (M,K) fp32 or bf16, w_q: (K,N) int8, scale: (N,) fp32 and y: (M,N)
// fp32, all row-major and contiguous.  As in the TPU kernel every partial
// sum is fp32 and the scale is applied once, after the whole sum over K.
// Any M, K and N are computed; ragged edges are masked.
//
// Bound: at decode shapes (M of a few rows) the int8 weights are nearly all
// the bytes, K*N + M*K*itemsize + 4*N + 4*M*N over device memory bandwidth
// (3.35 TB/s), against 2*M*K*N fp32 operations.  Design for that: read each
// weight byte once, in long coalesced rows, with many loads in flight.
//
// Structure.  The TPU kernel walked K as its last, sequential grid axis and
// accumulated into a revisited output tile.  Blocks here run in parallel and
// in no order, so:
//   * K is split into runs of kSplitK = 256 over gridDim.z (the column tiles
//     alone are far too few blocks for 132 SMs at decode shapes).  Each split
//     writes its partial sums to a workspace and a second kernel adds the
//     splits in order 0..S-1 and applies the scale; with one split the block
//     applies it.  The workspace costs S*M*N*8 bytes of traffic, an eighth
//     of the weights' at M=4;
//   * a block owns kCols = 512 columns and up to kRows = 4 rows of x over one
//     split, and stages the split's x (converted to fp32) in shared memory;
//   * each of its 4 warps reads whole 512-byte weight rows, a lane 16 bytes
//     (16 columns), widened to fp32 in registers; warp w takes the rows
//     w, w + 4, ... of the split, 8 rows' loads in flight before their
//     multiply-adds;
//   * the 4 warps' partial sums are added in shared memory in warp order.
// Every sum is taken in one fixed order, whatever the launch: repeated
// launches are bitwise equal.  The weight loads are 16-byte where
// N % 16 == 0 and w_q is 16-byte aligned, with byte loads at the column tail
// and otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;                        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLaneCols = 16;                        // one 16-byte weight load a lane
constexpr int kCols = 32 * kLaneCols;                // 512 columns per block
constexpr int kRows = 4;                             // rows of x per block
constexpr int kSplitK = 256;                         // K rows per split
constexpr int kBatch = 8;                            // weight rows a lane loads at once
static_assert(kSplitK % (kWarps * kBatch) == 0, "whole batches per split");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Byte i of v, sign-extended, as fp32.
__device__ __forceinline__ float byte_f32(int v, int i) {
  return static_cast<float>((v << (24 - 8 * i)) >> 24);
}

int k_splits(int K) { return (K + kSplitK - 1) / kSplitK; }

template <typename XT>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ ws, int M, int N, int K) {
  __shared__ float xs[kRows][kSplitK];
  __shared__ __align__(16) float red[kWarps][kRows][kCols];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * kCols + lane * kLaneCols;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, M - row0);
  const int kbeg = blockIdx.z * kSplitK;
  const int klen = min(kSplitK, K - kbeg);
  const bool vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0) &&
                   (col0 + kLaneCols <= N);

  for (int i = threadIdx.x; i < kRows * kSplitK; i += kThreads) {
    const int r = i / kSplitK, kk = i % kSplitK;
    xs[r][kk] = (r < rows && kk < klen) ? to_f32(x[(long long)(row0 + r) * K + kbeg + kk]) : 0.f;
  }
  __syncthreads();

  float acc[kRows][kLaneCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) acc[r][j] = 0.f;
  const int8_t* wsplit = w + (long long)kbeg * N + col0;
  for (int k0 = 0; k0 < kSplitK; k0 += kWarps * kBatch) {
    int4 wq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int kk = k0 + warp + u * kWarps;
      const int8_t* wr = wsplit + (long long)kk * N;
      if (kk >= klen) {
        wq[u] = make_int4(0, 0, 0, 0);
      } else if (vec) {
        wq[u] = *reinterpret_cast<const int4*>(wr);
      } else {
        int b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j)
          if (col0 + j < N) b[j / 4] |= static_cast<int>(static_cast<uint8_t>(wr[j])) << (8 * (j % 4));
        wq[u] = make_int4(b[0], b[1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int kk = k0 + warp + u * kWarps;
      const int words[4] = {wq[u].x, wq[u].y, wq[u].z, wq[u].w};
      float wv[kLaneCols];
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) wv[j] = byte_f32(words[j / 4], j % 4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float xv = xs[r][kk];               // zero past klen: adds exact zeros
#pragma unroll
          for (int j = 0; j < kLaneCols; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kLaneCols; j += 4)
      *reinterpret_cast<float4*>(&red[warp][r][lane * kLaneCols + j]) =
          make_float4(acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int col = blockIdx.x * kCols + c;
    if (r >= rows || col >= N) continue;
    float s = 0.f;
    for (int q = 0; q < kWarps; ++q) s += red[q][r][c];
    const long long o = (long long)(row0 + r) * N + col;
    if (split)
      ws[(long long)blockIdx.z * M * N + o] = s;
    else
      out[o] = s * scale[col];
  }
}

// out[i] = (sum over splits s = 0..S-1 of ws[s][i]) * scale[i % N]
__global__ void __launch_bounds__(kThreads)
int8_matmul_reduce(const float* __restrict__ ws, const float* __restrict__ scale,
                   float* __restrict__ out, long long MN, int N, int splits) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += ws[(long long)q * MN + i];
  out[i] = s * scale[i % N];
}

}  // namespace

// The number of K splits for (M, N, K): the caller allocates a workspace of
// splits * M * N floats when it is above 1.
extern "C" int int8_matmul_splits(int M, int N, int K) { return k_splits(K); }

// x_bf16: 0 for fp32 x, 1 for bf16 x.  ws may be null when
// int8_matmul_splits(M, N, K) == 1.  Launches on `stream` and returns the
// cudaError_t of the launches (0 = success).
extern "C" int int8_matmul_launch(const void* x, int x_bf16, const void* w, const void* scale,
                                  void* out, void* ws, int M, int N, int K, void* stream) {
  const int splits = k_splits(K);
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws), M,
        N, K);
  else
    int8_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(ws), M,
        N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = (long long)M * N;
  int8_matmul_reduce<<<(unsigned)((MN + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<const float*>(scale), static_cast<float*>(out),
      MN, N, splits);
  return static_cast<int>(cudaGetLastError());
}
