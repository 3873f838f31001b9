// The grouped SwiGLU expert FFN on bf16 weights, on tensor cores, for Hopper
// (sm_90a).  Included by moe_ffn.cu; the fp32-weight variant keeps the
// passes of moe_ffn_common.cuh.
//
//     y[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e]
//
// x: (E, C, D) fp32, Wg/Wu: (E, D, F) bf16, Wd: (E, F, D) bf16, y: (E, C, D)
// fp32.
//
// Bound: at decode (C = 1 or a few rows) each weight byte feeds C
// multiply-adds and the time is set by the weight bytes over device memory
// bandwidth; a prefill block (C = 64 or more rows) reuses each weight tile
// over all of its rows and is bound by the products.  Design for both with
// one arithmetic:
//
//  * swap-AB mma.sync m16n8k16 (bf16 in, fp32 accumulate): weight columns on
//    the MMA's M side, the C rows on its N side (padded to 8), so C = 1
//    wastes no weight bytes and a 64-row block reads each weight tile once;
//  * fp32 precision from bf16 products: x is split into kSplit bf16 terms
//    (hi = bf16(x), lo = bf16(x - hi), ...) that run as kSplit MMAs into the
//    same accumulator; the bf16 weights are exact in both, so only x loses
//    bits (at most 2^-18 relative with two terms).  hu = silu(g) * u is split
//    the same way before the down projection.  (TF32 would keep 10 bits.)
//  * weight tiles (64 columns x 64 contraction rows, 128-byte swizzled) and
//    the split x tiles arrive by TMA (cp.async.bulk.tensor) into a ring of
//    shared-memory stages; one producer warp keeps the ring full, four
//    consumer warps run the MMAs, full/empty mbarriers between them; a
//    persistent grid of two or three blocks per SM walks the work units,
//    each block the same number of them;
//  * units that run at the same time read neighbouring 128-byte runs of the
//    same weight rows (at decode every column tile of a row band side by
//    side); the row tiles of a prefill block share each weight tile in L2;
//  * three launches: split x into its bf16 terms; gate/up with SwiGLU in the
//    epilogue, writing hu's split terms; down, writing y.  When a pass's
//    column tiles alone cannot fill the card (decode shapes, C <= 16), its
//    contraction is also cut across units: each writes the sums of its
//    segments as partials, and the last unit of a tile to finish (a ticket
//    from a per-tile counter, released and acquired at device scope) adds
//    them in segment order, so the workspace holds partials only then.
//
// Summation order (load-bearing): an output's contraction runs in segments
// of kSeg rows, numbered from row 0; inside a segment, k16 steps in order,
// each as kSplit MMAs (hi, lo, ...) into one fp32 accumulator that starts at
// zero; the segments are then added in index order in fp32.  Every MMA row
// and column is independent, so an output's bits depend on its own x row,
// its weight column and (D, F) alone: not on C, E, the tile's rows, whether
// the segments were split across blocks, or whether the weights came by TMA
// or by the element-by-element loader (used when a weight row is not a
// whole number of 16-byte runs or a base pointer is not 16-byte aligned),
// which fills the same swizzled tile.  That is what lets an engine wave of
// one or two experts equal the reference's all-expert call, and a served
// row equal its solo decode.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace mma {

constexpr int kSplit = 2;          // bf16 terms of x and of hu
constexpr int kBM = 64;            // weight columns a block tile covers (4 warps x m16)
constexpr int kSeg = 256;          // contraction rows a segment (one accumulator) covers
constexpr int kConsumers = 4;      // MMA warps; warp 4 is the producer
constexpr int kThreads = 32 * (kConsumers + 1);
constexpr int kBKGateUp = 64;     // contraction rows a stage holds: gate/up ...
constexpr int kBKDown = 64;       // ... and down
constexpr int kStageKBGateUp = 100;  // shared memory of a block's ring (KB): gate/up ...
constexpr int kStageKBDown = 64;     // ... and down
constexpr int kMaxStages = 8;
constexpr int kSplitBelowPct = 50;  // split a pass when its tiles < this % of the SMs ...
constexpr int kSplitMaxRows = 16;   // ... and C <= this
constexpr int kSplitUnits = 8;      // split work units per SM to aim for
constexpr int kFoldBatch = 32;      // partials a fold has in flight
constexpr int kGroup = 8;           // column tiles side by side when there are row tiles
static_assert(kBM == 4 * 16, "a block tile is four warps of m16");
static_assert(kSeg % kBKGateUp == 0 && kSeg % kBKDown == 0 && kBKGateUp % 64 == 0 &&
              kBKDown % 64 == 0, "a stage is whole 64-row x boxes; a segment whole stages");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete.  A wait that lasts seconds
// means an arrival was lost: trap, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (4ll << 30)) __trap();
  }
}

// A 3-d box of `map` at coordinates (c0 innermost, c1, c2) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Add `v` to *p with release and acquire semantics at device scope: the
// writes that the block made before a barrier are visible to whoever reads
// the sum after it, and what was released before the sum is visible here.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumers) : "memory");
}

// Byte offset of (row, byte column) in a tile of 128-byte rows under TMA's
// 128-byte swizzle: the 16-byte run j of row r sits at run j ^ (r % 8).
__host__ __device__ __forceinline__ uint32_t swz(int row, int col_byte) {
  return (uint32_t)(row * 128 + ((((col_byte >> 4) ^ row) & 7) << 4) + (col_byte & 15));
}

// x = t[0] + t[1] + ... to about 2^-(9 * kSplit) relative, each term bf16.
__device__ __forceinline__ void split_terms(float x, __nv_bfloat16 (&t)[kSplit]) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    t[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(t[i]);
  }
}

// ------------------------------------------------------------------- kernels
// x (rows, K) fp32 -> kSplit planes (rows, Kp) bf16 of its split terms.
__global__ void split_rows_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ planes,
                                  long long rows, int K, int Kp) {
  const long long n = rows * K;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / K;
    const int k = (int)(i % K);
    __nv_bfloat16 t[kSplit];
    split_terms(x[i], t);
#pragma unroll
    for (int p = 0; p < kSplit; ++p) planes[((long long)p * rows + r) * Kp + k] = t[p];
  }
}

struct Pass {
  int E, C, K, N;       // experts, rows, contraction, output columns
  int Kp;               // row length of the x planes (K rounded up to 8)
  int bk;               // contraction rows a stage (k-step) holds
  int mt, ct, nks;      // column tiles, row tiles, k-steps
  int group;            // column tiles that run side by side
  int mtg;              // column tiles rounded up to whole groups
  int nseg, split;      // segments; 1 = segments split across work units
  int spu, nsu;         // segments a split unit takes; split units per tile
  int units;
  int stages;
  int tma_w;            // weights by TMA (else element by element)
  int xrows;            // rows of an x box: min(row tile, C) (rows past C are never
                        // written out, so they may hold anything)
  long long part_floats;  // split partials
};

// One pass of the FFN.  NMAT = 2: gate and up (K = D, N = F), SwiGLU in the
// epilogue, hu's split terms to `hs` (planes (kSplit, E, C, Np)); NMAT = 1:
// down (K = F, N = D), y to `y`.  Units (expert, column group, row tile[,
// run of segments], column tile in the group), the last fastest: units that
// run at the same time read neighbouring 128-byte runs of the same weight
// rows (a group is every column tile when there is one row tile), and the
// row tiles of one column group share its weight tiles in L2.  Units past
// the last column tile (a ragged group) do nothing.  A split unit writes
// each of its segments' sums as a partial; the last unit of a tile adds
// all of the tile's partials in segment order.
template <int NMAT, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
ffn_pass(const __grid_constant__ CUtensorMap map_w0, const __grid_constant__ CUtensorMap map_w1,
         const __grid_constant__ CUtensorMap map_x, const __nv_bfloat16* __restrict__ w0,
         const __nv_bfloat16* __restrict__ w1, const Pass P, float* __restrict__ part,
         int* __restrict__ counters, __nv_bfloat16* __restrict__ hs, int Np,
         float* __restrict__ y) {
  constexpr int NT = BN / 8;                        // n8 tiles of the row tile
  constexpr int kWeightTile = BK * kBM * 2;         // BK rows of 128 bytes
  constexpr int kXBox = BN * 128;                   // one 64-column box of x rows
  constexpr int kXTile = (BK / 64) * kXBox;         // one x plane's tile
  constexpr int kStage = NMAT * kWeightTile + kSplit * kXTile;
  constexpr int kSegSteps = kSeg / BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)P.stages * kStage);
  uint64_t* empty = full + P.stages;
  __shared__ int s_last;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(&full[s], P.tma_w ? 1 : 32);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto decode = [&](int u, int& e, int& mt, int& ct, int& r) {
    const int lo = u % P.group;
    u /= P.group;
    r = 0;
    if (P.split) {
      r = u % P.nsu;
      u /= P.nsu;
    }
    ct = u % P.ct;
    u /= P.ct;
    const int groups = P.mtg / P.group;
    mt = (u % groups) * P.group + lo;
    e = u / groups;
  };
  auto ksteps = [&](int r, int& k0, int& k1) {
    k0 = P.split ? r * P.spu * kSegSteps : 0;
    k1 = P.split ? min(P.nks, k0 + P.spu * kSegSteps) : P.nks;
  };

  if (warp == kConsumers) {
    // ------------------------------------------------------------ producer
    if (!P.tma_w || lane == 0) {
      const uint32_t xbytes = (uint32_t)(kSplit * (BK / 64) * P.xrows * 128);
      const uint32_t tx = P.tma_w ? (uint32_t)(NMAT * kWeightTile) + xbytes : xbytes;
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
        int e, mt, ct, r, k0, k1;
        decode(u, e, mt, ct, r);
        if (mt >= P.mt) continue;
        ksteps(r, k0, k1);
        for (int ks = k0; ks < k1; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + (size_t)stage * kStage;
          unsigned char* xt = st + NMAT * kWeightTile;
          if (lane == 0) {
            if (P.tma_w) mbar_arrive_expect_tx(&full[stage], tx);
            else mbar_expect_tx(&full[stage], tx);
            if (P.tma_w) {
              tma_load(st, &map_w0, mt * kBM, ks * BK, e, &full[stage]);
              if (NMAT == 2) tma_load(st + kWeightTile, &map_w1, mt * kBM, ks * BK, e, &full[stage]);
            }
#pragma unroll
            for (int p = 0; p < kSplit; ++p)
#pragma unroll
              for (int sub = 0; sub < BK / 64; ++sub)
                tma_load(xt + p * kXTile + sub * kXBox, &map_x, ks * BK + sub * 64, ct * BN,
                         p * P.E + e, &full[stage]);
          }
          if (!P.tma_w) {
            // the same swizzled tiles, element by element, zero past K and N
            for (int m = 0; m < NMAT; ++m) {
              const __nv_bfloat16* w = (m == 0 ? w0 : w1) + (size_t)e * P.K * P.N;
              __nv_bfloat16* t = reinterpret_cast<__nv_bfloat16*>(st + m * kWeightTile);
              for (int i = lane; i < BK * kBM; i += 32) {
                const int r = i / kBM, c = i % kBM;
                const int k = ks * BK + r, n = mt * kBM + c;
                const __nv_bfloat16 v =
                    (k < P.K && n < P.N) ? w[(size_t)k * P.N + n] : __float2bfloat16(0.f);
                t[swz(r, 2 * c) / 2] = v;
              }
            }
            mbar_arrive(&full[stage]);
          }
          if (++stage == P.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < P.units; u += gridDim.x) {
    int e, mt, ct, r, k0, k1;
    decode(u, e, mt, ct, r);
    if (mt >= P.mt) continue;
    ksteps(r, k0, k1);
    float chain[NMAT][NT][4], tot[NMAT][NT][4];
    // fragment element i of n8 tile nt: column n_base + (i / 2) * 8, row
    // c_base + nt * 8 + i % 2
    const int n_base = mt * kBM + warp * 16 + g;
    const int c_base = ct * BN + 2 * t4;
#pragma unroll
    for (int m = 0; m < NMAT; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) chain[m][nt][i] = tot[m][nt][i] = 0.f;
    bool first = true;
    for (int ks = k0; ks < k1; ++ks) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + (size_t)stage * kStage;
      const uint32_t wbase = smem_u32(st);
      const uint32_t xbase = smem_u32(st + NMAT * kWeightTile);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (ks * BK + kk * 16 < P.K) {
          // A: W^T (16 columns x 16 rows) of each matrix; lane l gives row
          // (l % 8) + 8 * (l / 16) of the k16 step, column run l / 8 % 2.
          uint32_t a[NMAT][4];
          const int ar = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int ac = (warp * 16 + ((lane >> 3) & 1) * 8) * 2;
#pragma unroll
          for (int m = 0; m < NMAT; ++m)
            ldmatrix_x4_trans(a[m], wbase + m * kWeightTile + swz(ar, ac));
          // B: rows of x (8 per n8 tile) x 16 contraction columns, per term.
          const int br = lane & 7;
          const int bc = ((kk & 3) * 16 + ((lane >> 3) & 1) * 8) * 2;
          const uint32_t xsub = xbase + (kk >> 2) * kXBox;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int p = 0; p < kSplit; ++p) {
              uint32_t b[2];
              ldmatrix_x2(b, xsub + p * kXTile + swz(nt * 8 + br, bc));
#pragma unroll
              for (int m = 0; m < NMAT; ++m) mma_bf16(chain[m][nt], a[m], b);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == P.stages) {
        stage = 0;
        phase ^= 1;
      }
      if ((ks + 1) % kSegSteps == 0 || ks + 1 == P.nks) {     // a segment ends
        const int seg = ks / kSegSteps;
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (P.split) {                    // its partial sums
                const int n = n_base + (i >> 1) * 8, c = c_base + nt * 8 + (i & 1);
                if (c < P.C && n < P.N)
                  part[((((size_t)e * P.nseg + seg) * NMAT + m) * P.C + c) * P.N + n] =
                      chain[m][nt][i];
              } else {                          // folded in, in segment order
                tot[m][nt][i] = first ? chain[m][nt][i] : tot[m][nt][i] + chain[m][nt][i];
              }
              chain[m][nt][i] = 0.f;
            }
        first = false;
      }
    }

    // Epilogue.
    if (P.split) {
      // the tile's ticket: the unit that completes its segments adds them
      bar_consumers();
      if (threadIdx.x == 0) {
        int* cnt = counters + ((size_t)e * P.mt + mt) * P.ct + ct;
        const int mine = (k1 - k0 + kSegSteps - 1) / kSegSteps;
        const bool last = atomic_add_acq_rel(cnt, mine) + mine == P.nseg;
        if (last) *cnt = 0;                     // every other ticket is drawn
        s_last = last;
      }
      bar_consumers();
      if (!s_last) continue;
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = n_base + (i >> 1) * 8, c = c_base + nt * 8 + (i & 1);
            if (c < P.C && n < P.N) {
              // v = p0, then + p1, + p2, ... in segment order, the partials
              // read kFoldBatch at a time
              const float* src = part + (((size_t)e * P.nseg * NMAT + m) * P.C + c) * P.N + n;
              const size_t stride = (size_t)NMAT * P.C * P.N;
              float v = 0.f;
              for (int q0 = 0; q0 < P.nseg; q0 += kFoldBatch) {
                float buf[kFoldBatch];
#pragma unroll
                for (int q = 0; q < kFoldBatch; ++q)
                  buf[q] = q0 + q < P.nseg ? __ldcg(src + (size_t)(q0 + q) * stride) : 0.f;
#pragma unroll
                for (int q = 0; q < kFoldBatch; ++q)
                  if (q0 + q < P.nseg) v = q0 + q == 0 ? buf[q] : v + buf[q];
              }
              tot[m][nt][i] = v;
            }
          }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n_base + (i >> 1) * 8, c = c_base + nt * 8 + (i & 1);
        if (c >= P.C || n >= P.N) continue;
        if (NMAT == 2) {
          const float gv = tot[0][nt][i], uv = tot[NMAT - 1][nt][i];
          __nv_bfloat16 t[kSplit];
          split_terms(gv / (1.f + expf(-gv)) * uv, t);
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            hs[(((size_t)p * P.E + e) * P.C + c) * Np + n] = t[p];
        } else {
          y[((size_t)e * P.C + c) * P.N + n] = tot[0][nt][i];
        }
      }
  }
}

// ------------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-d bf16 tensor (d0 innermost, d1, d2) with row stride `row` elements
// and plane stride `plane` elements; boxes of (b0, b1, 1), 128-byte swizzle,
// zero fill outside.
inline bool make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint64_t row, uint64_t plane, uint32_t b0, uint32_t b1) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row * 2, plane * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int row_tile(int C) { return C <= 8 ? 8 : C <= 16 ? 16 : C <= 32 ? 32 : 64; }

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

inline Pass plan_pass(int E, int C, int K, int N, int nmat, int bk, int sms) {
  Pass P{};
  P.bk = bk;
  P.xrows = std::min(C, row_tile(C));
  P.E = E;
  P.C = C;
  P.K = K;
  P.N = N;
  P.Kp = cdiv(K, 8) * 8;
  const int bn = row_tile(C);
  P.mt = cdiv(N, kBM);
  P.ct = cdiv(C, bn);
  P.group = P.ct == 1 ? P.mt : std::min(kGroup, P.mt);
  P.mtg = cdiv(P.mt, P.group) * P.group;
  P.nks = cdiv(K, bk);
  P.nseg = cdiv(K, kSeg);
  const int tiles = E * P.mt * P.ct;
  P.split = P.nseg > 1 && C <= kSplitMaxRows && 100 * tiles < kSplitBelowPct * sms;
  P.nsu = P.split ? std::min(P.nseg, cdiv(kSplitUnits * sms, tiles)) : 1;
  P.spu = cdiv(P.nseg, P.nsu);
  P.nsu = cdiv(P.nseg, P.spu);
  P.units = E * P.mtg * P.ct * P.nsu;
  const int stage = nmat * bk * kBM * 2 + kSplit * (bk / 64) * bn * 128;
  const int budget = 1024 * (nmat == 1 ? kStageKBDown : kStageKBGateUp);
  P.stages = std::max(2, std::min(kMaxStages, budget / stage));
  P.part_floats = P.split ? (long long)E * P.nseg * nmat * C * N : 0;
  return P;
}

// Everything a call needs beyond its inputs and output, in one byte buffer:
// x's split terms, hu's split terms, the two passes' split partials.
struct Plan {
  Pass gu, dn;
  size_t xs, hs, part_gu, part_dn, bytes;
  long long counters;                      // gate/up tiles, then down tiles
};

inline size_t up256(size_t b) { return (b + 255) / 256 * 256; }

inline Plan make_plan(int E, int C, int D, int F) {
  const int sms = sm_count();
  Plan pl;
  pl.gu = plan_pass(E, C, D, F, 2, kBKGateUp, sms);
  pl.dn = plan_pass(E, C, F, D, 1, kBKDown, sms);
  pl.xs = 0;
  pl.hs = pl.xs + up256((size_t)kSplit * E * C * pl.gu.Kp * 2);
  pl.part_gu = pl.hs + up256((size_t)kSplit * E * C * pl.dn.Kp * 2);
  pl.part_dn = pl.part_gu + up256((size_t)pl.gu.part_floats * 4);
  pl.bytes = pl.part_dn + up256((size_t)pl.dn.part_floats * 4);
  pl.counters = (long long)E * pl.gu.mt * pl.gu.ct + (long long)E * pl.dn.mt * pl.dn.ct;
  return pl;
}

template <int NMAT, int BN, int BK>
int launch_pass(const Pass& P, const CUtensorMap& m0, const CUtensorMap& m1, const CUtensorMap& mx,
                const __nv_bfloat16* w0, const __nv_bfloat16* w1, float* part, int* counters,
                __nv_bfloat16* hs, int Np, float* y, cudaStream_t stream) {
  constexpr int kStage = NMAT * BK * kBM * 2 + kSplit * (BK / 64) * BN * 128;
  const size_t smem = 1024 + (size_t)P.stages * kStage + 2 * P.stages * sizeof(uint64_t);
  auto kern = ffn_pass<NMAT, BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  // As many blocks as fit, but each with the same number of units (a last
  // round of a few units would leave most SMs idle).
  const int fit = std::max(1, per_sm) * sm_count();
  const int rounds = cdiv(P.units, fit);
  const int grid = cdiv(P.units, rounds);
  kern<<<grid, kThreads, smem, stream>>>(m0, m1, mx, w0, w1, P, part, counters, hs, Np, y);
  return (int)cudaGetLastError();
}

template <int NMAT, int BK>
int launch_pass_bn(const Pass& P, const CUtensorMap& m0, const CUtensorMap& m1,
                   const CUtensorMap& mx, const __nv_bfloat16* w0, const __nv_bfloat16* w1,
                   float* part, int* counters, __nv_bfloat16* hs, int Np, float* y,
                   cudaStream_t stream) {
  switch (row_tile(P.C)) {
    case 8: return launch_pass<NMAT, 8, BK>(P, m0, m1, mx, w0, w1, part, counters, hs, Np, y, stream);
    case 16: return launch_pass<NMAT, 16, BK>(P, m0, m1, mx, w0, w1, part, counters, hs, Np, y, stream);
    case 32: return launch_pass<NMAT, 32, BK>(P, m0, m1, mx, w0, w1, part, counters, hs, Np, y, stream);
    default: return launch_pass<NMAT, 64, BK>(P, m0, m1, mx, w0, w1, part, counters, hs, Np, y, stream);
  }
}

// The three launches on `stream`: split x, gate/up + SwiGLU, down.
inline int run_ffn_bf16(const float* x, const __nv_bfloat16* wg, const __nv_bfloat16* wu,
                        const __nv_bfloat16* wd, void* ws, int* counters, float* y, int E, int C,
                        int D, int F, cudaStream_t stream) {
  Plan pl = make_plan(E, C, D, F);
  unsigned char* base = static_cast<unsigned char*>(ws);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base + pl.xs);
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(base + pl.hs);
  float* part_gu = reinterpret_cast<float*>(base + pl.part_gu);
  float* part_dn = reinterpret_cast<float*>(base + pl.part_dn);
  int* cnt_gu = counters;
  int* cnt_dn = counters + (size_t)E * pl.gu.mt * pl.gu.ct;
  pl.gu.tma_w = F % 8 == 0 && aligned16(wg) && aligned16(wu);
  pl.dn.tma_w = D % 8 == 0 && aligned16(wd);

  const long long rows = (long long)E * C;
  const long long n = rows * D;
  const int blocks = (int)std::min<long long>((n + 255) / 256, 4096);
  split_rows_kernel<<<blocks, 256, 0, stream>>>(x, xs, rows, D, pl.gu.Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap mg{}, mu{}, md{}, mx{}, mh{};
  const int bn = row_tile(C);
  if (!make_map(&mx, xs, D, C, (uint64_t)kSplit * E, pl.gu.Kp, (uint64_t)C * pl.gu.Kp, 64,
                pl.gu.xrows) ||
      !make_map(&mh, hs, F, C, (uint64_t)kSplit * E, pl.dn.Kp, (uint64_t)C * pl.dn.Kp, 64,
                pl.dn.xrows))
    return (int)cudaErrorInvalidValue;
  if (pl.gu.tma_w && (!make_map(&mg, wg, F, D, E, F, (uint64_t)D * F, kBM, kBKGateUp) ||
                      !make_map(&mu, wu, F, D, E, F, (uint64_t)D * F, kBM, kBKGateUp)))
    return (int)cudaErrorInvalidValue;
  if (pl.dn.tma_w && !make_map(&md, wd, D, F, E, D, (uint64_t)F * D, kBM, kBKDown))
    return (int)cudaErrorInvalidValue;

  int e = launch_pass_bn<2, kBKGateUp>(pl.gu, mg, mu, mx, wg, wu, part_gu, cnt_gu, hs, pl.dn.Kp,
                                       nullptr, stream);
  if (e != 0) return e;
  return launch_pass_bn<1, kBKDown>(pl.dn, md, md, mh, wd, wd, part_dn, cnt_dn, nullptr, 0, y,
                                    stream);
}

}  // namespace mma
