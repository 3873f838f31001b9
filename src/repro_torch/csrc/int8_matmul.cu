// w8a16 dequantizing matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/int8_matmul/kernel.py:56
// `int8_matmul_kernel` (its pallas_call is at :64).  It computes
//
//     y[m, n] = (sum_k x[m, k] * float(w_q[k, n])) * scale[n]
//
// with x: (M,K) fp32 or bf16 (widened exactly), w_q: (K,N) int8, scale: (N,)
// fp32 and y: (M,N) fp32, all row-major and contiguous.  As in the TPU kernel
// every partial sum is fp32 and the scale is applied once, after the whole
// sum over K.  Any M, K and N are computed; the weight base may be off its
// alignment and N ragged.
//
// Bound: at decode shapes (M of a few rows) the int8 codes are nearly all
// the bytes, K*N + M*K*itemsize + 4*N + 4*M*N over device memory bandwidth
// (3.35 TB/s): 17.6 us for a Mixtral-8x7B expert matrix (58.7 MB of codes).
// Each code feeds M multiply-adds and a few instructions of dequantization,
// so from M of about 4 the FMA issue of the busiest SMs, not memory, sets
// the time: the design reads each code byte once, with many bytes in
// flight, and spends few instructions on each.
//
// Design: one launch of clusters of blocks; nothing but `out` is written.
//  * K is cut into G segments of L rows (below); a cluster owns one column
//    tile and walks row tiles of at most 16 rows of x (one at decode; more
//    re-read the codes); its blocks hold the G segments, one a block for
//    G <= 8, else four ("slots"), so a cluster has at most 8 blocks;
//  * a block is four consumer warps and one producer warp.  A consumer
//    thread owns one 32-bit word (4 columns) of each weight row of its
//    slot's tile: a tile is 512 codes wide with one slot (the four warps
//    side by side), 128 with four (a warp a segment).  The slot count is a
//    template parameter, so every shared-memory offset in the hot loop is a
//    constant.  At a Mixtral expert's two shapes that is 224 blocks either
//    way (28 tiles x 8 segments; 32 tiles x 7 blocks of 4 segments);
//  * the producer keeps a ring of stages in shared memory full, a stage 32
//    contraction rows of each slot's tile and its x rows at those
//    contraction rows, each a tensor-map box (cp.async.bulk.tensor,
//    256-byte L2 fetches, zeros past the edges) completing on the stage's
//    mbarrier; consumers read codes and x from shared memory only, and each
//    word of codes feeds every row of the row tile;
//  * dequantization is the exact byte-to-float trick of the packed FFN
//    (moe_ffn_packed.cu): the code, biased by 128, placed by __byte_perm in
//    the mantissa of 2^23, minus 2^23 + 128; no int-to-float conversion;
//  * at the end each consumer thread stores its segment sums straight into
//    the shared memory of the blocks that fold them (distributed shared
//    memory; block q folds every S-th float4 of the tile's outputs); after
//    one cluster barrier each block adds the G segment sums of its outputs,
//    multiplies by the scale and writes y;
//  * operands a tensor map cannot describe (N % 16 != 0 or a code base off
//    16 bytes; K * itemsize % 16 != 0 or an x base off 16 bytes) are staged
//    by the producer element by element into the same stage layout, so they
//    feed the same sums.
//
// Summation order (load-bearing): L = 512 for K <= 16384, else
// 32 * ceil(K / 1024); G = ceil(K / L) <= 32;
// segment g holds contraction rows [g*L, min(K, (g+1)*L)).  For each (row,
// column): an fmaf chain from 0.f over a segment's rows in contraction
// order; the G segment sums added in segment order starting from 0.f; then
// one multiply by scale[n].  The boundaries are a function of K alone: not
// of M, the row tile, the tile width, the SM count, cluster placement, the
// staging path or x's dtype.  So a row's output bits do not depend on M or
// on the other rows, bf16 x gives the bits of the same values in fp32, and
// launches repeat bitwise.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "moe_ffn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using fpass::cdiv;

constexpr int kConsumers = 4;                    // consumer warps a block
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kBK = 32;                          // contraction rows a stage
constexpr int kRowBytes = 4 * 32 * kConsumers;   // a word per consumer lane: 512 codes
constexpr int kStageCodes = kBK * kRowBytes;     // a stage's codes, over its slots
constexpr int kSegRows = 512;                    // segment rows up to K = kSegRows * kMaxSegs
constexpr int kMaxSegs = 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxRows = 16;                     // rows of x a row tile covers
constexpr int kMaxStages = 4;
constexpr int kGridMax = 65535;                  // tiles a grid spreads (y, z); clusters walk the rest
static_assert(kMaxSegs <= kMaxCluster * kConsumers, "a cluster holds every segment");

// A call's plan: how K is cut (L, G: a function of K alone) and how the work
// is laid out (nothing of which changes a sum).
struct Plan {
  int M, N, K;
  int L, G;              // segment rows, segments
  int S;                 // blocks a cluster
  int slots;             // segments a block: 1 or 4 (the kernel's SLOTS)
  int R;                 // rows of x a row tile covers (the kernel's R)
  int tiles, rtiles;     // column tiles (512 / slots codes), row tiles
  int own;               // float4s of a tile's outputs that each block of a cluster folds
  unsigned long long s_magic;   // ceil(2^32 / S): i / S == (i * s_magic) >> 32 for i < 2^16
  int bulk_w, bulk_x;    // staged as tensor-map boxes (else element by element)
};

Plan make_plan(int M, int N, int K) {
  Plan P{};
  P.M = M;
  P.N = N;
  P.K = K;
  P.L = K <= kSegRows * kMaxSegs ? kSegRows : kBK * cdiv(K, kBK * kMaxSegs);
  P.G = cdiv(K, P.L);
  P.slots = P.G <= kMaxCluster ? 1 : kConsumers;
  P.S = cdiv(P.G, P.slots);
  P.R = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : M <= 8 ? 8 : kMaxRows;
  P.tiles = cdiv(N, kRowBytes / P.slots);
  P.rtiles = cdiv(M, P.R);
  P.own = cdiv(P.R * kRowBytes / P.slots / 4, P.S);
  P.s_magic = (0x100000000ull + P.S - 1) / P.S;
  return P;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class XT> __device__ __forceinline__ XT zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}

// The four int8 codes of a word as exact fp32 values: 0x4B0000bb is
// 2^23 + bb, and bb is the code plus 128.
__device__ __forceinline__ void deq4(uint32_t word, float (&q)[4]) {
  const uint32_t biased = word ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    q[j] = __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | j)), 8388736.f);
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

// n (4 or 8) consecutive values of a staged x row at shared address a, as
// fp32 (bf16 -> fp32 is exact).
template <int n> __device__ __forceinline__ void ldsx(const float*, uint32_t a, float* v) {
#pragma unroll
  for (int h = 0; h < n; h += 4) {
    const float4 f = lds128(a + 4 * h);
    v[h] = f.x;
    v[h + 1] = f.y;
    v[h + 2] = f.z;
    v[h + 3] = f.w;
  }
}
template <int n> __device__ __forceinline__ void ldsx(const __nv_bfloat16*, uint32_t a, float* v) {
  uint32_t u[4];
  if (n == 8)
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(u[0]), "=r"(u[1]), "=r"(u[2]), "=r"(u[3])
                 : "r"(a));
  else
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(u[0]), "=r"(u[1]) : "r"(a));
#pragma unroll
  for (int h = 0; h < n / 2; ++h) {
    v[2 * h] = __uint_as_float(u[h] << 16);
    v[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
  }
}

// Elements of a slot's x rows in a stage: R rows of kBK, padded to 128
// bytes (a tensor copy's destination is 128-byte aligned).
template <class XT, int R> __host__ __device__ constexpr int x_slot() {
  return cdiv(R * kBK * (int)sizeof(XT), 128) * 128 / (int)sizeof(XT);
}
// A stage: every slot's codes (kStageCodes bytes in all), then each slot's
// x rows.
template <class XT, int R, int SLOTS> __host__ __device__ constexpr int stage_bytes() {
  return kStageCodes + SLOTS * x_slot<XT, R>() * (int)sizeof(XT);
}
// The fold's buffer: a block's share of a tile's outputs, for every segment.
template <int R> __host__ __device__ constexpr int red_bytes() {
  return R * kRowBytes * 4 + 16 * kMaxSegs;
}
// The ring's depth: as deep as keeps a block within 74 KB (three blocks an
// SM) up to R = 8, within 110 KB (two) at R = 16, up to kMaxStages.
template <class XT, int R, int SLOTS> __host__ __device__ constexpr int ring_stages() {
  return ((R >= kMaxRows ? 110 : 74) * 1024 - red_bytes<R>() - 2 * kMaxStages * 8) /
                     stage_bytes<XT, R, SLOTS>() >
                 kMaxStages
             ? kMaxStages
             : ((R >= kMaxRows ? 110 : 74) * 1024 - red_bytes<R>() - 2 * kMaxStages * 8) /
                   stage_bytes<XT, R, SLOTS>();
}
template <class XT, int R, int SLOTS> constexpr size_t smem_bytes() {
  return (size_t)ring_stages<XT, R, SLOTS>() * stage_bytes<XT, R, SLOTS>() + red_bytes<R>() +
         2 * ring_stages<XT, R, SLOTS>() * sizeof(uint64_t);
}

// Grid: (S, column tiles, row tiles), at most kGridMax of each tile;
// clusters of S blocks along x, so blockIdx.x is a block's rank; a cluster
// walks column tiles blockIdx.y, blockIdx.y + gridDim.y, ... and row tiles
// likewise.  A tile is 512 / SLOTS codes wide, so the kernel divides by
// nothing but constants.
template <class XT, int R, int SLOTS>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const __grid_constant__ CUtensorMap mw, const __grid_constant__ CUtensorMap mx,
                   const XT* __restrict__ x, const unsigned char* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out, const Plan P) {
  constexpr int kTile = kRowBytes / SLOTS;       // codes (columns) of a tile row
  constexpr int kWc = kConsumers / SLOTS;        // consumer warps across a tile
  constexpr int kStage = stage_bytes<XT, R, SLOTS>();
  constexpr int kStages = ring_stages<XT, R, SLOTS>();
  constexpr int kX = x_slot<XT, R>();
  constexpr int kXs = (int)sizeof(XT);
  constexpr int kUnits = R * kTile / 4;          // float4s of a tile's outputs
  constexpr int kRun = R >= 8 ? 4 : 8;           // contraction rows whose loads go out together
  static_assert(kStages >= 2, "ring depth");
  extern __shared__ __align__(128) unsigned char smem[];   // 128-byte aligned: tensor copies
  float4* red = reinterpret_cast<float4*>(smem + (size_t)kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStage + red_bytes<R>());
  uint64_t* empty = full + kStages;
  const uint32_t sbase = fpass::smem_u32(smem);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = rank * SLOTS;                           // the block's first segment (< G)
  const int nst = cdiv(min(P.L, P.K - g0 * P.L), kBK);   // stages: its first segment is its longest
  // ring position, carried from one tile to the next
  int stage = 0;
  uint32_t phase = 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      fpass::mbar_init(&full[s], 32);            // the producer's lanes
      fpass::mbar_init(&empty[s], kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (int ct = blockIdx.y; ct < P.tiles; ct += gridDim.y) {
  for (int rt = blockIdx.z; rt < P.rtiles; rt += gridDim.z) {
    const int n0 = ct * kTile, row0 = rt * R;
    if (warp == kConsumers) {
      // ---------------------------------------------------------- producer
      const int cols = min(kTile, P.N - n0);
      for (int j = 0; j < nst; ++j) {
        fpass::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + (size_t)stage * kStage;
        XT* xs = reinterpret_cast<XT*>(st + kStageCodes);
        uint32_t ntx = 0;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int g = g0 + s;
          const int k0 = g * P.L + j * kBK;
          const int nk = g < P.G ? min(kBK, min(P.K, (g + 1) * P.L) - k0) : 0;
          if (nk <= 0) continue;
          if (P.bulk_w) {
            ntx += kBK * kTile;
          } else {
            const unsigned char* src = w + (size_t)k0 * P.N + n0;
            unsigned char* dst = st + s * kBK * kTile;
            for (int i = lane; i < kBK * kTile; i += 32) {
              const int k = i / kTile, b = i % kTile;
              dst[i] = k < nk && b < cols ? src[(size_t)k * P.N + b] : 0;
            }
          }
          if (P.bulk_x) {
            ntx += R * kBK * kXs;
          } else {
            XT* dst = xs + s * kX;
            for (int i = lane; i < R * kBK; i += 32) {
              const int r = i / kBK, k = i % kBK;
              dst[i] = k < nk && row0 + r < P.M ? x[(size_t)(row0 + r) * P.K + k0 + k]
                                                : zero<XT>();
            }
          }
        }
        __syncwarp();
        if (lane == 0) fpass::mbar_arrive_expect_tx(&full[stage], ntx);
        else fpass::mbar_arrive(&full[stage]);
        if (lane == 0) {
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            const int g = g0 + s;
            const int k0 = g * P.L + j * kBK;
            if (g >= P.G || k0 >= min(P.K, (g + 1) * P.L)) continue;
            if (P.bulk_w) fpass::tma_load(st + s * kBK * kTile, &mw, n0 / 4, k0, 0, &full[stage]);
            if (P.bulk_x) fpass::tma_load(xs + s * kX, &mx, k0, row0, 0, &full[stage]);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {
      // ---------------------------------------------------------- consumers
      const int wc = warp % kWc, s = warp / kWc;
      const int g = g0 + s;
      const int kseg = g * P.L;
      const int kend = g < P.G ? min(P.K, kseg + P.L) : kseg;
      const int u4 = wc * 32 + lane;               // the thread's float4 of a tile row
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
      for (int j = 0; j < nst; ++j) {
        fpass::mbar_wait(&full[stage], phase);
        const uint32_t sst = sbase + (uint32_t)(stage * kStage);
        // this thread's word of the slot's row 0, and the slot's x rows
        const uint32_t aw = sst + (uint32_t)(s * kBK * kTile + u4 * 4);
        const uint32_t ax = sst + (uint32_t)(kStageCodes + s * kX * kXs);
        const int nk = kend - (kseg + j * kBK);
        if (nk >= kBK) {
          // a whole stage: kRun rows' codes and x go out, then their FMAs
#pragma unroll 2
          for (int k0 = 0; k0 < kBK; k0 += kRun) {
            uint32_t wv[kRun];
            float xq[R][kRun];
#pragma unroll
            for (int u = 0; u < kRun; ++u) wv[u] = lds32(aw + (uint32_t)((k0 + u) * kTile));
#pragma unroll
            for (int r = 0; r < R; ++r)
              ldsx<kRun>((const XT*)nullptr, ax + (uint32_t)((r * kBK + k0) * kXs), xq[r]);
#pragma unroll
            for (int u = 0; u < kRun; ++u) {
              float q[4];
              deq4(wv[u], q);
#pragma unroll
              for (int r = 0; r < R; ++r)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(xq[r][u], q[i], acc[r][i]);
            }
          }
        } else {
          // the segment's last, partial stage: row by row
          const XT* xs = reinterpret_cast<const XT*>(smem + (ax - sbase));
          for (int k = 0; k < nk; ++k) {
            float q[4];
            deq4(lds32(aw + (uint32_t)(k * kTile)), q);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float xv = to_f32(xs[r * kBK + k]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(xv, q[i], acc[r][i]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) fpass::mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (g < P.G) {
        // the segment's sums to the blocks that fold them: float4 i of the
        // tile's outputs to block i % S, at red[g][i / S]
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const unsigned i = (unsigned)(r * (kTile / 4) + u4);
          const unsigned q = (unsigned)((i * P.s_magic) >> 32);
          *(cluster.map_shared_rank(red, i - q * P.S) + g * P.own + q) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        }
      }
    }
    cluster.sync();

    // -------------------------------------------------------------- the fold
    // Each block adds, for its share of the tile's outputs (four columns a
    // thread), the G segment sums in segment order from 0.f, and applies
    // the scale.
    if (warp < kConsumers) {
      for (int q = threadIdx.x; q < P.own; q += 32 * kConsumers) {
        const int i = q * P.S + rank;
        if (i >= kUnits) break;
        const int r = i / (kTile / 4), n = n0 + (i % (kTile / 4)) * 4;
        if (row0 + r >= P.M || n >= P.N) continue;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        const uint32_t a = fpass::smem_u32(red + q);
        for (int g = 0; g < P.G; ++g) {
          const float4 v = lds128(a + (uint32_t)(g * P.own * 16));
          sum[0] = __fadd_rn(sum[0], v.x);
          sum[1] = __fadd_rn(sum[1], v.y);
          sum[2] = __fadd_rn(sum[2], v.z);
          sum[3] = __fadd_rn(sum[3], v.w);
        }
        float* o = out + (size_t)(row0 + r) * P.N + n;
#pragma unroll
        for (int h = 0; h < 4; ++h)
          if (n + h < P.N) o[h] = __fmul_rn(sum[h], __ldg(scale + n + h));
      }
    }
    // another tile's sums may arrive only once every block has folded this one's
    if (rt + (int)gridDim.z < P.rtiles || ct + (int)gridDim.y < P.tiles) cluster.sync();
  }
  }
}

// Set the kernel's shared-memory limit and carveout once per device.
template <class XT, int R, int SLOTS> cudaError_t prepare() {
  static int done[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<XT, R, SLOTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<XT, R, SLOTS>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_matmul_kernel<XT, R, SLOTS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done[dev] = 1;
  return err;
}

template <class XT, int R, int SLOTS>
int launch_slots(const Plan& P, const CUtensorMap& mw, const CUtensorMap& mx, const void* x,
                 const void* w, const void* scale, void* out, cudaStream_t stream) {
  cudaError_t err = prepare<XT, R, SLOTS>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)P.S, (unsigned)std::min(P.tiles, kGridMax),
                     (unsigned)std::min(P.rtiles, kGridMax));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<XT, R, SLOTS>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<XT, R, SLOTS>, mw, mx,
                           static_cast<const XT*>(x), static_cast<const unsigned char*>(w),
                           static_cast<const float*>(scale), static_cast<float*>(out), P);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class XT, int R>
int launch_rows(const Plan& P, const CUtensorMap& mw, const CUtensorMap& mx, const void* x,
                const void* w, const void* scale, void* out, cudaStream_t stream) {
  if (P.slots == 1) return launch_slots<XT, R, 1>(P, mw, mx, x, w, scale, out, stream);
  return launch_slots<XT, R, kConsumers>(P, mw, mx, x, w, scale, out, stream);
}

template <class XT>
int launch_x(const Plan& P, const CUtensorMap& mw, const CUtensorMap& mx, const void* x,
             const void* w, const void* scale, void* out, cudaStream_t stream) {
  switch (P.R) {
    case 1: return launch_rows<XT, 1>(P, mw, mx, x, w, scale, out, stream);
    case 2: return launch_rows<XT, 2>(P, mw, mx, x, w, scale, out, stream);
    case 4: return launch_rows<XT, 4>(P, mw, mx, x, w, scale, out, stream);
    case 8: return launch_rows<XT, 8>(P, mw, mx, x, w, scale, out, stream);
    default: return launch_rows<XT, kMaxRows>(P, mw, mx, x, w, scale, out, stream);
  }
}

}  // namespace

// The plan of a call, for reports: plan[0..6] = segment rows L, segments G,
// blocks a cluster, segments a block, column tile (codes), row tile, blocks
// launched.  Returns 0.
extern "C" int int8_matmul_plan(int M, int N, int K, int* plan) {
  const Plan P = make_plan(M, N, K);
  const int v[7] = {P.L, P.G, P.S, P.slots, kRowBytes / P.slots, P.R,
                    P.S * std::min(P.tiles, kGridMax) * std::min(P.rtiles, kGridMax)};
  memcpy(plan, v, sizeof(v));
  return 0;
}

// x_bf16: 0 for fp32 x, 1 for bf16 x.  One launch on `stream`, which writes
// every element of `out`.  Returns the cudaError_t of the launch (0 =
// success).
extern "C" int int8_matmul_launch(const void* x, int x_bf16, const void* w, const void* scale,
                                  void* out, int M, int N, int K, void* stream) {
  Plan P = make_plan(M, N, K);
  const size_t xsize = x_bf16 ? 2 : 4;
  P.bulk_w = N % 16 == 0 && fpass::aligned16(w);
  P.bulk_x = ((size_t)K * xsize) % 16 == 0 && fpass::aligned16(x);
  CUtensorMap mw, mx;
  memset(&mw, 0, sizeof(mw));
  memset(&mx, 0, sizeof(mx));
  // codes as (N / 4, K) words, boxes of a tile's run of 32 rows; x as (K, M),
  // boxes of 32 contraction rows of a row tile
  if (P.bulk_w && !fpass::make_map(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT32, N / 4, K, 1, N,
                                   (uint64_t)N * K, kRowBytes / P.slots / 4, kBK))
    return (int)cudaErrorInvalidValue;
  if (P.bulk_x &&
      !fpass::make_map(&mx, x,
                       x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                       K, M, 1, (uint64_t)K * xsize, (uint64_t)K * xsize * M, kBK, P.R))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch_x<__nv_bfloat16>(P, mw, mx, x, w, scale, out, st);
  return launch_x<float>(P, mw, mx, x, w, scale, out, st);
}
