// Single-token GQA decode attention over a ring-buffer KV cache, for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/flash_decode/kernel.py:74
// `flash_decode_kernel` (its pallas_call is at :81).  For every batch row b,
// kv head kh and query head g of that kv head's group
//
//     s[j]  = dot(q[b,kh,g,:], k[b,j,kh,:]) / sqrt(Hd)     for slots j < W
//     valid = kpos[b,j] >= 0 && kpos[b,j] <= pos[b]
//             && (window == 0 || pos[b] - kpos[b,j] < window)
//     out[b,kh,g,:] = sum_j softmax(s)[j] * v[b,j,kh,:]    over valid j
//
// with q: (B,K,G,Hd), k/v: (B,W,K,Hd) in bf16 or fp32, kpos: (B,W) int32,
// pos: (B,) int32, out: (B,K,G,Hd) fp32, every sum in fp32.  The TPU kernel
// divides by max(l, 1e-30); so does this one.  A row with no valid slot
// gives 0 (never on the decode path: the slot just written is valid).
//
// Bound: each cached K and V element is read once and feeds G multiply-adds,
// about G/2 FLOP per byte, far under the card's ridge, so the time is set by
// 2*B*W*K*Hd*sizeof(T) + 4*B*W bytes over device memory bandwidth
// (3.35 TB/s).  Design for that: spread a row's cache over many blocks, and
// keep the loads of a block independent of each other so they pipeline.
//
// Structure.  W is cut into fixed chunks of kChunk slots, numbered from slot
// 0.  Pass 1 runs one block per (chunk, kv head, batch row); each of its
// warps owns a fixed run of the chunk's slots and each lane a fixed set of
// head-dim columns.  A warp reads each of its K rows once, in one coalesced
// pass, for all G query heads of the kv head (several rows in flight),
// then each of its V rows the same way, and the block writes the chunk's
// max m_c, exp-sum l_c and unnormalised P.V sums acc_c to a workspace.
// Pass 2 runs one block per (kv head, batch row, head) and combines the
// chunks in index order.  (The TPU kernel carried (m, l, acc) across a
// sequential grid axis; blocks here run in no order, so the combine is its
// own pass.)
//
// Invariance.  The order of every sum depends only on the slot index and
// kChunk: a score adds a lane's columns in order, then the lanes in a fixed
// shuffle tree; l_c adds slots lane by lane in order, then a fixed tree;
// acc_c adds each warp's slots in index order, then the warps' sums in warp
// order; pass 2 adds chunks in index order.  A masked or out-of-bounds slot
// contributes p = 0 and no product (a select, not an add of zero), and a
// chunk with no valid slot adds nothing in pass 2.  So a row's output does
// not depend on B (each row has its own blocks), on W, or on masked tail
// slots.  That is what lets a request decoded in a composed batch equal its
// solo decode bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;               // slots per pass-1 block
constexpr int kThreads = 256;             // threads per pass-1 block
constexpr int kWarps = kThreads / 32;
constexpr int kSlotsPerWarp = kChunk / kWarps;
constexpr int kSlotUnroll = 4;            // K rows a warp has in flight
constexpr int kMaxG = 16;                 // query heads per kv head
constexpr int kHeadTile = 8;              // heads a P.V pass accumulates at once
constexpr int kMaxCols = 8;               // head-dim columns per lane: Hd <= 256
constexpr int kCombineThreads = 128;
constexpr int kCombineTile = 256;         // chunks whose scales pass 2 stages at once
constexpr float kNegInf = -1e30f;
static_assert(kThreads == kChunk, "pass 1 reads one kpos per thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1.  Grid (n_chunks, K, B).  Dynamic shared memory: sq[G*Hd] (the
// query heads as fp32), sp[G*kChunk] (scores, then probabilities) and
// sacc[kWarps*G*Hd] (each warp's P.V sums).  CPL = ceil(Hd / 32): lane l
// owns head-dim columns l, l + 32, ... of every K and V row; warp w owns the
// chunk's slots [w * kSlotsPerWarp, (w + 1) * kSlotsPerWarp).
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kpos, const int* __restrict__ pos, int W, int K, int G,
             int Hd, int window, float scale_div, float* __restrict__ part_m,
             float* __restrict__ part_l, float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sp = sq + G * Hd;
  float* sacc = sp + G * kChunk;
  __shared__ unsigned char svalid[kChunk];

  const int c = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p_b = pos[b];
  const int hi = min(kChunk, W - c * kChunk);         // in-bounds slots of this chunk
  const size_t slot_stride = (size_t)K * Hd;
  const T* kb = k + ((size_t)b * W + (size_t)c * kChunk) * slot_stride + (size_t)kh * Hd;
  const T* vb = v + ((size_t)b * W + (size_t)c * kChunk) * slot_stride + (size_t)kh * Hd;

  const T* qb = q + ((size_t)b * K + kh) * G * Hd;
  for (int i = tid; i < G * Hd; i += kThreads) sq[i] = to_float(qb[i]);
  {
    bool valid = false;
    if (tid < hi) {
      const int kp = kpos[(size_t)b * W + (size_t)c * kChunk + tid];
      valid = kp >= 0 && kp <= p_b && (window == 0 || p_b - kp < window);
    }
    svalid[tid] = valid;
  }
  __syncthreads();

  // Scores: a warp reads each of its K rows in one coalesced pass, kSlotUnroll
  // rows in flight; a score sums the lane's columns in order, then the lanes
  // in a fixed shuffle tree.
  const int j0 = warp * kSlotsPerWarp;
  const int j1 = min(j0 + kSlotsPerWarp, hi);
  for (int jb = j0; jb < j1; jb += kSlotUnroll) {
    float kv[kSlotUnroll][CPL];
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int j = jb + u;
      const bool ok = j < j1 && svalid[j];
      const T* krow = kb + (size_t)j * slot_stride;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int h = lane + 32 * i;
        kv[u][i] = (ok && h < Hd) ? to_float(krow[h]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kSlotUnroll; ++u) {
      const int j = jb + u;
      if (j >= j1) break;
      const bool ok = svalid[j];
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int h = lane + 32 * i;
          if (h < Hd) part = fmaf(sq[g * Hd + h], kv[u][i], part);
        }
        part = warp_sum(part);
        if (lane == 0) sp[g * kChunk + j] = ok ? part / scale_div : kNegInf;
      }
    }
  }
  for (int j = max(j1, j0); j < j0 + kSlotsPerWarp; ++j)      // out-of-bounds slots
    for (int g = lane; g < G; g += 32) sp[g * kChunk + j] = kNegInf;
  __syncthreads();

  // Per head: chunk max (exact in any order), probabilities (exactly 0 for
  // masked and out-of-bounds slots) and l_c (lane l adds slots l, l + 32,
  // ... in order, then a fixed shuffle tree).  Warp w takes heads w, w + 8.
  const size_t part = (((size_t)b * K + kh) * n_chunks + c) * G;
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int j = lane; j < kChunk; j += 32) m = fmaxf(m, sp[g * kChunk + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < kChunk; j += 32) {
      const float s = sp[g * kChunk + j];
      const float p = (s == kNegInf) ? 0.f : expf(s - m);
      sp[g * kChunk + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[part + g] = m;
      part_l[part + g] = l;
    }
  }
  __syncthreads();

  // P.V: warp w adds its slots in index order (a slot with p = 0 adds
  // nothing), lane l its columns; loads are unconditional within the
  // chunk's in-bounds slots so they pipeline.
  for (int g0 = 0; g0 < G; g0 += kHeadTile) {
    float acc[kHeadTile][CPL];
#pragma unroll
    for (int gg = 0; gg < kHeadTile; ++gg)
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[gg][i] = 0.f;
#pragma unroll 8
    for (int j = j0; j < j1; ++j) {
      const T* vrow = vb + (size_t)j * slot_stride;
      float vv[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int h = lane + 32 * i;
        vv[i] = h < Hd ? to_float(vrow[h]) : 0.f;
      }
#pragma unroll
      for (int gg = 0; gg < kHeadTile; ++gg) {
        if (g0 + gg < G) {
          const float p = sp[(g0 + gg) * kChunk + j];
#pragma unroll
          for (int i = 0; i < CPL; ++i)
            acc[gg][i] = p != 0.f ? fmaf(p, vv[i], acc[gg][i]) : acc[gg][i];
        }
      }
    }
#pragma unroll
    for (int gg = 0; gg < kHeadTile; ++gg) {
      if (g0 + gg < G) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) {
          const int h = lane + 32 * i;
          if (h < Hd) sacc[(warp * G + g0 + gg) * Hd + h] = acc[gg][i];
        }
      }
    }
  }
  __syncthreads();
  // acc_c: the warps' sums added in warp order.
  for (int idx = tid; idx < G * Hd; idx += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sacc[w * G * Hd + idx];
    part_acc[part * Hd + idx] = a;
  }
}

// Pass 2.  Grid (G, K, B): combine the chunks of one (row, kv head, head)
// in index order.  A chunk with no valid slot has scale 0 and adds nothing.
__global__ void __launch_bounds__(kCombineThreads)
combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
               const float* __restrict__ part_acc, int n_chunks, int K, int G, int Hd,
               float* __restrict__ out) {
  __shared__ float red[kCombineThreads / 32];
  __shared__ float scale[kCombineTile];
  __shared__ float s_l;
  const int g = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = ((size_t)b * K + kh) * n_chunks;

  float m = kNegInf;
  for (int c = tid; c < n_chunks; c += kCombineThreads)
    if (part_l[(base + c) * G + g] > 0.f) m = fmaxf(m, part_m[(base + c) * G + g]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = kNegInf;
  for (int w = 0; w < kCombineThreads / 32; ++w) m = fmaxf(m, red[w]);

  float l = 0.f;                           // thread 0: the head's exp-sum
  float acc[kMaxCols / 4] = {0.f, 0.f};    // columns tid and tid + kCombineThreads
  for (int c0 = 0; c0 < n_chunks; c0 += kCombineTile) {
    const int nt = min(kCombineTile, n_chunks - c0);
    for (int ci = tid; ci < nt; ci += kCombineThreads) {
      const float lc = part_l[(base + c0 + ci) * G + g];
      scale[ci] = lc > 0.f ? expf(part_m[(base + c0 + ci) * G + g] - m) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      for (int ci = 0; ci < nt; ++ci)
        if (scale[ci] != 0.f) l = fmaf(part_l[(base + c0 + ci) * G + g], scale[ci], l);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = tid + r * kCombineThreads;
      if (h < Hd) {
        const float* pa = part_acc + ((base + c0) * G + g) * Hd + h;
#pragma unroll 8
        for (int ci = 0; ci < nt; ++ci) {
          const float sc = scale[ci];
          const float x = pa[(size_t)ci * G * Hd];
          acc[r] = sc != 0.f ? fmaf(x, sc, acc[r]) : acc[r];
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) s_l = fmaxf(l, 1e-30f);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int h = tid + r * kCombineThreads;
    if (h < Hd) out[(((size_t)b * K + kh) * G + g) * Hd + h] = acc[r] / s_l;
  }
}

template <typename T, int CPL>
int launch_cpl(const void* q, const void* k, const void* v, const int* kpos, const int* pos,
               float* part_m, float* part_l, float* part_acc, int n_chunks, int B, int W, int K,
               int G, int Hd, int window, cudaStream_t stream) {
  const size_t smem = (size_t)G * (Hd + kChunk + kWarps * Hd) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chunk_kernel<T, CPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  chunk_kernel<T, CPL><<<dim3(n_chunks, K, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpos, pos,
      W, K, G, Hd, window, sqrtf((float)Hd), part_m, part_l, part_acc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kpos, const int* pos,
           float* ws, float* out, int B, int W, int K, int G, int Hd, int window,
           cudaStream_t stream) {
  if (G > kMaxG || Hd > 32 * kMaxCols) return (int)cudaErrorInvalidValue;
  const int n_chunks = (W + kChunk - 1) / kChunk;
  float* part_m = ws;
  float* part_l = part_m + (size_t)B * K * n_chunks * G;
  float* part_acc = part_l + (size_t)B * K * n_chunks * G;
  int err;
  switch ((Hd + 31) / 32) {
    case 1: err = launch_cpl<T, 1>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 2: err = launch_cpl<T, 2>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 3: err = launch_cpl<T, 3>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 4: err = launch_cpl<T, 4>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 5: err = launch_cpl<T, 5>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 6: err = launch_cpl<T, 6>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    case 7: err = launch_cpl<T, 7>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
    default: err = launch_cpl<T, 8>(q, k, v, kpos, pos, part_m, part_l, part_acc, n_chunks, B, W, K, G, Hd, window, stream); break;
  }
  if (err != 0) return err;
  combine_kernel<<<dim3(G, K, B), kCombineThreads, 0, stream>>>(part_m, part_l, part_acc,
                                                                n_chunks, K, G, Hd, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

extern "C" int flash_decode_max_group() { return kMaxG; }

extern "C" int flash_decode_max_head_dim() { return 32 * kMaxCols; }

// Floats of the workspace: m and l per (row, kv head, chunk, head), then the
// (row, kv head, chunk, head, Hd) partial sums.
extern "C" long long flash_decode_workspace_floats(int B, int W, int K, int G, int Hd) {
  const long long n_chunks = (W + kChunk - 1) / kChunk;
  return (long long)B * K * n_chunks * G * (2 + (long long)Hd);
}

// dtype: 0 = fp32, 1 = bf16 (q, k and v share it).  Launches both passes on
// `stream` and returns the cudaError_t of the launches (0 = success).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kpos, const void* pos, void* ws, void* out,
                                   int B, int W, int K, int G, int Hd, int window, int dtype,
                                   void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  const int* ps = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kp, ps, w, o, B, W, K, G, Hd, window, s);
  return launch<float>(q, k, v, kp, ps, w, o, B, W, K, G, Hd, window, s);
}
