// The grouped SwiGLU expert FFN's CUDA-core passes for Hopper (sm_90a),
// shared by the full-width kernel on fp32 weights (moe_ffn.cu) and the
// packed-weight kernel (moe_ffn_packed.cu).  Together they replace the
// Pallas kernels src/repro/kernels/moe_gemm/kernel.py:61 `moe_ffn_kernel`
// (fp32 weights) and src/repro/kernels/moe_gemm/packed.py:147
// `moe_ffn_packed_kernel`.  For every stacked expert e
//
//     y[e] = (silu(x[e] @ Wg[e]) * (x[e] @ Wu[e])) @ Wd[e]
//
// with x: (E, C, D) fp32, y: (E, C, D) fp32, every sum in fp32, and the
// weights in one of the formats a Fmt class describes (below).
//
// Bound.  At decode (C = 1, or a few rows) each weight byte feeds C
// multiply-adds, so the time is set by the weight bytes over device memory
// bandwidth (3.35 TB/s): 1.41 GB for an fp32 Mixtral wave of two experts
// (0.42 ms), 0.35 GB at int8, 0.20 GB at nf4.  Reaching it takes some
// 3.35 MB in flight across the card (bandwidth x a microsecond of latency):
// a pass whose loads are what a warp holds in registers stays far below it,
// whatever the format.
//
// Design: two launches, gate/up (with SwiGLU in its epilogue, writing hu)
// and down (writing y; launched while gate/up drains, as a programmatic
// dependent launch that stages its first weight rows before it waits for
// hu).  Each is a persistent grid of blocks of consumer warps (eight for fp32
// and fp16, four for int8 and nf4) and one producer warp that draw work
// units (expert, column tile, row tile, run of 256-row segments) from a
// counter:
//
//  * a column tile is one run of each weight row, a 32-bit word of codes
//    per consumer thread (1024 bytes: 256 fp32 or 512 fp16 columns; 512
//    bytes: 512 int8 or 1024 nf4 columns);
//  * the producer keeps a ring of stages in shared memory full (about 200 KB
//    an SM, in one or two blocks), each stage kBK weight rows of the tile per
//    matrix, their nf4 absmax runs and the tile's x rows at those
//    contraction rows, each as one tensor-map box (cp.async.bulk.tensor,
//    256-byte L2 fetches, zeros past the edges) completing on the stage's
//    mbarrier; consumers read weights and x from shared memory only, so the
//    bytes in flight are set by the ring, not by registers;
//  * each weight word feeds all of the row tile's rows (up to 16) from shared
//    memory, so weights are read once for C <= the row tile;
//  * units are drawn in order, so blocks that run at once read neighbouring
//    runs of the same weight rows (every column tile of a row band side by
//    side at decode; the row tiles of a column group share its runs in L2),
//    and a block that finishes early draws more: every SM streams to the end;
//  * at C <= 16 a tile's contraction is cut across units: each writes its
//    segments' sums as partials, and the unit that completes the tile's
//    segments (a ticket from a per-tile counter, released and acquired at
//    device scope, reset by that unit) adds them in segment order and writes
//    hu or y; at larger C a unit folds its segments in registers;
//  * dequantization runs on the word just read from shared memory: int8 by
//    the exact byte-to-float trick (__byte_perm of the biased code into the
//    mantissa of 2^23, minus 2^23 + 128), nf4 through the 16 levels in
//    shared memory, then __fmul_rn by the scale;
//  * operands a tensor map cannot describe (rows that are not whole 16-byte
//    runs, bases off a 16-byte boundary, nf4 absmax rows that are not whole
//    runs, x rows with K % 4 != 0) are staged by the producer element by
//    element (byte by byte for codes) into the same stage layout, so they
//    feed the same sums.
//
// Summation order (load-bearing): for each (expert, row, column, 256-row
// segment) an fmaf chain from 0 in contraction-row order; the segments then
// added in segment order starting from 0.f; hu = g / (1.f + expf(-g)) * u.
// Segment boundaries are fixed multiples of kSeg, so an output's summation
// order is a function of (D, F) alone: not of E, C, the row tile, how the
// segments were cut across units, the staging path or the weight format.  A
// format only turns a stored word of a weight row into fp32 values, exactly
// as dequantize_tiles does; two formats that produce the same values give
// the same bits.  That is what makes the packed kernel equal, bit for bit,
// the full-width kernel on the dequantized weights, and the engine's one- or
// two-expert waves equal the reference's all-expert call.
//
// A format Fmt provides:
//   Fmt::kV     columns of one 32-bit word of codes;
//   Fmt::kColsPerAmax  columns that share one per-row scale staged beside the
//               codes (nf4's absmax: 64), 0 for none;
//   Fmt::kLut   whether it reads the 16 levels (Operand::lv);
//   Fmt::kRowsGateUp, kRowsDown  the largest row tile (accumulator budget);
//   Fmt::kUnroll  4-row groups of a stage unrolled at small row tiles;
//   Fmt::kConsumers, kStagesGateUp, kStagesDown  consumer warps of a block
//               and the ring's depth (tuning: wide words stream best from one
//               block of eight consumer warps an SM, codes that cost more
//               instructions from more blocks of four);
//   Fmt::Cols   what a thread keeps per unit (int8: its columns' scales);
//   static Cols cols(const Operand&, e, n, N)
//   static void deq(const Cols&, word, amax, lut, float (&out)[kV])
//               the kV values of columns [n, n + kV) of one row.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

namespace fpass {

// Tuning values are per format (Fmt::kConsumers, kStagesGateUp,
// kStagesDown) and below; none of them changes a sum.

constexpr int kSeg = 256;          // contraction rows per segment
constexpr int kBK = 32;            // contraction rows per stage, one a producer lane
constexpr int kMaxStages = 8;      // ring depth at most
constexpr int kSplitMaxRows = 16;  // cut a pass's contraction across units only for C <= this
constexpr int kSplitUnits = 16;   // work units per resident block to aim for
constexpr int kFoldLoads = 64;     // partials a thread's fold has in flight
constexpr int kGroup = 8;          // column tiles side by side when there are row tiles
constexpr int kAcc = 32;           // accumulators a consumer thread holds
static_assert(kSeg % kBK == 0 && kBK == 32, "a segment is whole stages; a stage one row a lane");

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// One weight matrix of every expert, as stored: codes (E, K, N * bits / 8)
// bytes; for nf4 its absmax (E, K, N / 64); for int8 its column scales
// (E, 1, N); for nf4 the 16 levels.  Unused pointers are null.
struct Operand {
  const unsigned char* q;
  const float* a;
  const float* s;
  const float* lv;
};

struct Pass {
  int E, C, K, N;        // experts, rows, contraction, output columns
  int rt;                // rows a tile covers (the kernel's R)
  int mt, ct;            // column tiles, row tiles
  int group, mtg;        // column tiles that run side by side; mt rounded up to groups
  int nseg, split;       // segments; 1 = segments cut across work units
  int spu, nsu;          // segments a split unit takes; split units per tile
  int units, stages;
  int bulk_w, bulk_a, bulk_x;   // staged as tensor boxes (else element by element)
  int ntx;                      // bytes a stage's tensor boxes bring
  long long part_floats;        // split partials
};

// Tensor maps of a pass's operands: the weight matrices as
// (row words, K, E) uint32, their nf4 absmax as (N / 64, K, E) floats, x as
// (K, C, E) floats.  Boxes are a tile's stage; what falls outside is zero.
struct Maps {
  CUtensorMap w[2], a[2], x;
};

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

// Programmatic dependent launch: let the dependent grid launch; wait until
// the grid this one depends on has finished and its writes are visible.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

template <int kCount> __device__ __forceinline__ void bar_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kCount) : "memory");
}

template <bool B> struct Whole { static constexpr bool value = B; };

// Consumer warps a block of the format has (warp consumers() produces), the
// bytes of a weight row a tile covers (a 32-bit word each consumer thread),
// its columns, the absmax floats of a tile row, the ring's depth.
template <class Fmt> __host__ __device__ constexpr int consumers() {
  return Fmt::kConsumers;
}
template <class Fmt> __host__ __device__ constexpr int threads() {
  return 32 * (consumers<Fmt>() + 1);
}
template <class Fmt> __host__ __device__ constexpr int run_bytes() {
  return 4 * 32 * consumers<Fmt>();
}
template <class Fmt> __host__ __device__ constexpr int tile_cols() {
  return 32 * consumers<Fmt>() * Fmt::kV;
}
template <class Fmt> __host__ __device__ constexpr int amax_floats() {
  return Fmt::kColsPerAmax ? tile_cols<Fmt>() / Fmt::kColsPerAmax : 0;
}
template <class Fmt, int NMAT> __host__ __device__ constexpr int ring_stages() {
  return NMAT == 2 ? Fmt::kStagesGateUp : Fmt::kStagesDown;
}

// Bytes of one stage: NMAT x kBK weight runs, their absmax runs, R x rows.
template <class Fmt, int NMAT, int R> __host__ __device__ constexpr int stage_bytes() {
  return NMAT * kBK * run_bytes<Fmt>() + NMAT * kBK * amax_floats<Fmt>() * 4 + R * kBK * 4;
}

// ------------------------------------------------------------------- the pass
// NMAT = 2: gate and up (K = D, N = F), hu = silu(g) * u to `out` (E, C, F);
// NMAT = 1: down (K = F, N = D), y to `out` (E, C, D).  x: (E, C, K) fp32.
// Work units (expert, column group, row tile[, run of segments], column tile
// in the group), the last fastest, are handed out in that order by a
// counter, so blocks that run at once take neighbouring units and every
// block stays busy to the end; units past the last column tile (a ragged
// group) are skipped.  counters: one ticket per tile, then the unit counter
// and a count of blocks done with it, all zero between launches.
// Blocks an SM should hold (the register cap): two gate/up or wide-row-tile
// blocks, three down blocks, of four consumer warps; fewer of more warps.
template <class Fmt> __host__ __device__ constexpr int min_blocks(int nmat, int rows) {
  return ((nmat == 2 || rows >= 16) ? 2 : 3) * 4 / consumers<Fmt>() > 0
             ? ((nmat == 2 || rows >= 16) ? 2 : 3) * 4 / consumers<Fmt>()
             : 1;
}

template <class Fmt, int NMAT, int R>
__global__ void __launch_bounds__(threads<Fmt>(), min_blocks<Fmt>(NMAT, R))
ffn_pass(const __grid_constant__ Maps M, const Operand w0, const Operand w1,
         const float* __restrict__ x, const Pass P, float* __restrict__ part,
         int* __restrict__ counters, float* __restrict__ out) {
  constexpr int V = Fmt::kV;
  constexpr int kConsumers = consumers<Fmt>();
  constexpr int kRunBytes = run_bytes<Fmt>();
  constexpr int kAmax = amax_floats<Fmt>();
  constexpr int kTile = tile_cols<Fmt>();
  static_assert(ring_stages<Fmt, NMAT>() <= kMaxStages, "ring depth");
  constexpr int kW = NMAT * kBK * kRunBytes;
  constexpr int kA = NMAT * kBK * kAmax * 4;
  constexpr int kStage = stage_bytes<Fmt, NMAT, R>();
  constexpr int kBits = 32 / V;
  constexpr int kUnroll = R >= 8 ? 1 : Fmt::kUnroll;   // wide row tiles: registers
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)P.stages * kStage);
  uint64_t* empty = full + P.stages;
  __shared__ float lut[16];
  __shared__ int s_unit[kMaxStages];     // the unit a stage holds; -1: no more units
  __shared__ int s_last;
  int* sched = counters + (size_t)P.E * P.mt * P.ct;   // [0] next unit, [1] blocks done

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P.stages; ++s) {
      mbar_init(&full[s], 32);              // the producer's lanes
      mbar_init(&empty[s], kConsumers);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (Fmt::kLut) {
    if (threadIdx.x < 16) lut[threadIdx.x] = __ldg(w0.lv + threadIdx.x);
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
  // segments [s0, s1) and contraction rows [ka, kb) of split run r
  auto segs = [&](int r, int& s0, int& s1, int& ka, int& kb) {
    s0 = P.split ? r * P.spu : 0;
    s1 = P.split ? min(P.nseg, s0 + P.spu) : P.nseg;
    ka = s0 * kSeg;
    kb = min(P.K, s1 * kSeg);
  };
  const long long row_bytes = (long long)P.N * kBits / 8;
  const int amax_row = kAmax ? P.N / 64 : 0;

  if (warp == kConsumers) {
    // ------------------------------------------------------------ producer
    // The down pass is launched while gate/up drains (programmatic dependent
    // launch): it stages the weight rows of its first ring of stages, then
    // waits for gate/up's hu before staging x.  `ready`: x may be staged.
    bool ready = NMAT == 2 || !P.bulk_x;
    if (NMAT == 1 && !P.bulk_x) wait_for_prerequisite();   // x read element by element
    int held = 0;                        // stages whose x box waits (while !ready)
    int held_k[kMaxStages], held_c[kMaxStages], held_e[kMaxStages];
    auto release = [&]() {
      wait_for_prerequisite();
      if (lane == 0)
        for (int i = 0; i < held; ++i)
          tma_load(smem + (size_t)i * kStage + kW + kA, &M.x, held_k[i], held_c[i], held_e[i],
                   &full[i]);
      ready = true;
    };
    int stage = 0;
    uint32_t phase = 0;
    int u = lane == 0 ? atomicAdd(sched, 1) : 0;
    u = __shfl_sync(0xffffffffu, u, 0);
    for (;;) {
      int e, mt, ct, r, s0, s1, ka, kb;
      const bool more = u < P.units;
      if (more) decode(u, e, mt, ct, r);
      // the next unit is drawn while this one's rows are staged
      int next = more && lane == 0 ? atomicAdd(sched, 1) : 0;
      if (!more) {                         // tell the consumers, and leave
        if (NMAT == 2) launch_dependents();
        if (!ready) release();
        mbar_wait(&empty[stage], phase ^ 1);
        if (lane == 0) s_unit[stage] = -1;
        __syncwarp();
        if (lane == 0) mbar_arrive_expect_tx(&full[stage], 0);
        else mbar_arrive(&full[stage]);
        break;
      }
      if (mt < P.mt) {
        segs(r, s0, s1, ka, kb);
        const int n0 = mt * kTile, c0 = ct * R;
        const int rows = min(R, P.C - c0);
        const long long b0 = (long long)n0 * kBits / 8;
        const int wbytes = (int)min((long long)kRunBytes, row_bytes - b0);
        const int afloats = kAmax ? min(kAmax, (P.N - n0) / 64) : 0;
        for (int k0 = ka; k0 < kb; k0 += kBK) {
          const int nk = min(kBK, kb - k0);
          if (!ready && held == P.stages) release();   // the ring is full of held stages
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + (size_t)stage * kStage;
          float* as = reinterpret_cast<float*>(st + kW);
          float* xs = reinterpret_cast<float*>(st + kW + kA);
          const float* xsrc = x + ((size_t)e * P.C + c0) * P.K + k0;
#pragma unroll
          for (int m = 0; m < NMAT; ++m) {
            const Operand& w = m ? w1 : w0;
            const unsigned char* src = w.q + ((size_t)e * P.K + k0) * row_bytes + b0;
            if (!P.bulk_w) {
              unsigned char* dst = st + m * kBK * kRunBytes;
              for (int i = lane; i < nk * kRunBytes; i += 32) {
                const int k = i / kRunBytes, b = i % kRunBytes;
                dst[i] = b < wbytes ? src[(size_t)k * row_bytes + b] : 0;
              }
            }
            if constexpr (kAmax > 0) {
              const float* asrc = w.a + ((size_t)e * P.K + k0) * amax_row + n0 / 64;
              if (!P.bulk_a) {
                float* dst = as + m * kBK * kAmax;
                for (int i = lane; i < nk * kAmax; i += 32) {
                  const int k = i / kAmax, j = i % kAmax;
                  dst[i] = j < afloats ? asrc[(size_t)k * amax_row + j] : 0.f;
                }
              }
            }
          }
          if (!P.bulk_x) {
            for (int i = lane; i < R * kBK; i += 32) {
              const int c = i / kBK, k = i % kBK;
              xs[i] = c < rows && k < nk ? xsrc[(size_t)c * P.K + k] : 0.f;
            }
          }
          if (lane == 0) s_unit[stage] = u;
          __syncwarp();
          if (lane == 0) mbar_arrive_expect_tx(&full[stage], (uint32_t)P.ntx);
          else mbar_arrive(&full[stage]);
          if (lane == 0) {
#pragma unroll
            for (int m = 0; m < NMAT; ++m) {
              if (P.bulk_w)
                tma_load(st + m * kBK * kRunBytes, &M.w[m], n0 * kBits / 32, k0, e, &full[stage]);
              if constexpr (kAmax > 0) {
                if (P.bulk_a)
                  tma_load(as + m * kBK * kAmax, &M.a[m], n0 / 64, k0, e, &full[stage]);
              }
            }
            if (P.bulk_x && ready) tma_load(xs, &M.x, k0, c0, e, &full[stage]);
          }
          if (!ready) {
            held_k[held] = k0;
            held_c[held] = c0;
            held_e[held] = e;
            ++held;
          }
          if (++stage == P.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      u = __shfl_sync(0xffffffffu, next, 0);
    }
    // the last block done drawing units resets the unit counter
    if (lane == 0 && atomicAdd(sched + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(sched, 0);
      atomicExch(sched + 1, 0);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int t = threadIdx.x;          // 0 .. 32 * kConsumers - 1: word t of each run
  int stage = 0;
  uint32_t phase = 0;
  int cur = -1, e = 0, mt = 0, ct = 0, s0 = 0, s1 = 0, kb = 0, k0 = 0, c0 = 0, rows = 0, n = 0;
  typename Fmt::Cols cw[NMAT];
  float acc[NMAT][R][V], tot[NMAT][R][V];
  for (;;) {
    mbar_wait(&full[stage], phase);
    const int u = s_unit[stage];
    if (u < 0) break;
    if (u != cur) {                              // a unit starts
      int r, ka;
      cur = u;
      decode(u, e, mt, ct, r);
      segs(r, s0, s1, ka, kb);
      k0 = ka;
      c0 = ct * R;
      rows = min(R, P.C - c0);
      n = mt * kTile + t * V;                    // this thread's first column
      cw[0] = Fmt::cols(w0, e, n, P.N);
      if (NMAT > 1) cw[NMAT - 1] = Fmt::cols(w1, e, n, P.N);
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int c = 0; c < R; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[m][c][i] = tot[m][c][i] = 0.f;
    }
    const int nk = min(kBK, kb - k0);
    const unsigned char* st = smem + (size_t)stage * kStage;
    const uint32_t* wq = reinterpret_cast<const uint32_t*>(st);
    const float* as = reinterpret_cast<const float*>(st + kW);
    const float* xs = reinterpret_cast<const float*>(st + kW + kA);
    // rows [0, lim) of the stage into acc, in row order; whole stages
    // (lim == kBK) take the loop without bounds
    auto run_stage = [&](auto whole_tag, const int lim) {
      constexpr bool whole = decltype(whole_tag)::value;
#pragma unroll (kUnroll)
      for (int k4 = 0; k4 < (whole ? kBK : lim); k4 += 4) {
        float xq[R][4];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const float4 v4 = *reinterpret_cast<const float4*>(xs + c * kBK + k4);
          xq[c][0] = v4.x;
          xq[c][1] = v4.y;
          xq[c][2] = v4.z;
          xq[c][3] = v4.w;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k4 + j;
          if (whole || k < lim) {
            float wv[NMAT][V];
#pragma unroll
            for (int m = 0; m < NMAT; ++m)
              Fmt::deq(cw[m], wq[(m * kBK + k) * (kRunBytes / 4) + t],
                       kAmax ? as[(m * kBK + k) * kAmax + t * V / 64] : 0.f, lut,
                       wv[m]);
#pragma unroll
            for (int c = 0; c < R; ++c)
#pragma unroll
              for (int m = 0; m < NMAT; ++m)
#pragma unroll
                for (int i = 0; i < V; ++i)
                  acc[m][c][i] = fmaf(xq[c][j], wv[m][i], acc[m][c][i]);
          }
        }
      }
    };
    if (nk == kBK) run_stage(Whole<true>{}, kBK);
    else run_stage(Whole<false>{}, nk);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == P.stages) {
      stage = 0;
      phase ^= 1;
    }
    const int kend = k0 + nk;
    if (kend % kSeg == 0 || kend == kb) {        // a segment ends
      const int seg = k0 / kSeg;
#pragma unroll
      for (int m = 0; m < NMAT; ++m)
#pragma unroll
        for (int c = 0; c < R; ++c)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            if (P.split) {                       // its partial sums
              if (c < rows && n + i < P.N)
                part[((((size_t)e * P.nseg + seg) * NMAT + m) * P.C + c0 + c) * P.N + n + i] =
                    acc[m][c][i];
            } else {                             // folded in, in segment order
              tot[m][c][i] += acc[m][c][i];
            }
            acc[m][c][i] = 0.f;
          }
    }
    k0 = kend;
    if (k0 < kb) continue;

    // The unit's epilogue.
    if (P.split) {
      // the tile's ticket: the unit that completes its segments adds them
      bar_consumers<32 * kConsumers>();
      if (t == 0) {
        int* cnt = counters + ((size_t)e * P.mt + mt) * P.ct + ct;
        const int mine = s1 - s0;
        const bool last = atomic_add_acq_rel(cnt, mine) + mine == P.nseg;
        if (last) *cnt = 0;                      // every other ticket is drawn
        s_last = last;
      }
      bar_consumers<32 * kConsumers>();
      if (!s_last) continue;
      // tot = 0 + p0 + p1 + ... in segment order, kQ segments' loads at a time
      constexpr int kOut = NMAT * R * V;
      constexpr int kQ = kFoldLoads / kOut > 0 ? kFoldLoads / kOut : 1;
      const size_t stride = (size_t)NMAT * P.C * P.N;
      for (int q0 = 0; q0 < P.nseg; q0 += kQ) {
        float buf[NMAT][R][V][kQ];
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int c = 0; c < R; ++c)
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float* src =
                  part + (((size_t)e * P.nseg * NMAT + m) * P.C + c0 + c) * P.N + n + i;
              const bool ok = c < rows && n + i < P.N;
#pragma unroll
              for (int q = 0; q < kQ; ++q)
                buf[m][c][i][q] = ok && q0 + q < P.nseg ? __ldcg(src + (q0 + q) * stride) : 0.f;
            }
#pragma unroll
        for (int m = 0; m < NMAT; ++m)
#pragma unroll
          for (int c = 0; c < R; ++c)
#pragma unroll
            for (int i = 0; i < V; ++i)
#pragma unroll
              for (int q = 0; q < kQ; ++q)
                if (q0 + q < P.nseg) tot[m][c][i] += buf[m][c][i][q];
      }
    }
#pragma unroll
    for (int c = 0; c < R; ++c)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (c >= rows || n + i >= P.N) continue;
        float* o = out + ((size_t)e * P.C + c0 + c) * P.N + n + i;
        if (NMAT == 2) {
          const float g = tot[0][c][i], uv = tot[NMAT - 1][c][i];
          *o = g / (1.f + expf(-g)) * uv;
        } else {
          *o = tot[0][c][i];
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

// A 3-d tensor of 4-byte elements (d0 innermost, d1, d2), rows of `row`
// bytes, planes of `plane` bytes; boxes of (b0, b1, 1), no swizzle, zero
// fill outside, L2 fetches of 256 bytes.
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint64_t row, uint64_t plane, uint32_t b0,
                     uint32_t b1) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row, plane};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

inline int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (count[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

template <class Fmt, int NMAT> constexpr int max_rows() {
  return NMAT == 2 ? Fmt::kRowsGateUp : Fmt::kRowsDown;
}

// Row tiles a pass instantiates: 1 (decode), up to 4, the format's largest.
template <class Fmt, int NMAT> constexpr int rows_mid() {
  return std::min(4, max_rows<Fmt, NMAT>());
}

template <class Fmt, int NMAT> inline int rows_for(int C) {
  return C == 1 ? 1 : C <= rows_mid<Fmt, NMAT>() ? rows_mid<Fmt, NMAT>() : max_rows<Fmt, NMAT>();
}

template <class Fmt, int NMAT, int R> inline size_t smem_bytes() {
  const int stages = ring_stages<Fmt, NMAT>();
  return 128 + (size_t)stages * stage_bytes<Fmt, NMAT, R>() + 2 * stages * sizeof(uint64_t);
}

// Blocks of this pass that one SM of the current device holds (0 if the
// attribute is refused).  The shared-memory attribute is set per device, so
// the answer is cached per device, as sm_count() is.
template <class Fmt, int NMAT, int R> inline int blocks_per_sm() {
  static int per_sm[64] = {0};                   // blocks + 1; 0 = not asked yet
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (per_sm[dev] == 0) {
    auto kern = ffn_pass<Fmt, NMAT, R>;
    const size_t smem = smem_bytes<Fmt, NMAT, R>();
    int n = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, threads<Fmt>(), smem) !=
            cudaSuccess)
      return 0;
    per_sm[dev] = n + 1;
  }
  return per_sm[dev] - 1;
}

template <class Fmt, int NMAT, int R>
inline Pass plan_rows(int E, int C, int K, int N) {
  Pass P{};
  P.E = E;
  P.C = C;
  P.K = K;
  P.N = N;
  P.rt = R;
  P.stages = ring_stages<Fmt, NMAT>();
  P.mt = cdiv(N, tile_cols<Fmt>());
  P.ct = cdiv(C, R);
  P.group = P.ct == 1 ? P.mt : std::min(kGroup, P.mt);
  P.mtg = cdiv(P.mt, P.group) * P.group;
  P.nseg = cdiv(K, kSeg);
  const long long slots = (long long)std::max(1, blocks_per_sm<Fmt, NMAT, R>()) * sm_count();
  const long long tiles = (long long)E * P.mt * P.ct;
  P.split = P.nseg > 1 && C <= kSplitMaxRows;
  P.nsu = P.split ? (int)std::min<long long>(P.nseg, (kSplitUnits * slots + tiles - 1) / tiles)
                  : 1;
  P.spu = cdiv(P.nseg, P.nsu);
  P.nsu = cdiv(P.nseg, P.spu);
  P.units = E * P.mtg * P.ct * P.nsu;
  P.part_floats = P.split ? (long long)E * P.nseg * NMAT * C * N : 0;
  return P;
}

template <class Fmt, int NMAT>
inline Pass plan_pass(int E, int C, int K, int N) {
  constexpr int R1 = rows_mid<Fmt, NMAT>(), R2 = max_rows<Fmt, NMAT>();
  const int r = rows_for<Fmt, NMAT>(C);
  if (r == 1) return plan_rows<Fmt, NMAT, 1>(E, C, K, N);
  if (r == R1) return plan_rows<Fmt, NMAT, R1>(E, C, K, N);
  return plan_rows<Fmt, NMAT, R2>(E, C, K, N);
}

template <class Fmt, int NMAT, int R>
inline int launch_rows(const Pass& P, const Maps& M, const Operand& w0, const Operand& w1,
                       const float* x, float* part, int* counters, float* out,
                       cudaStream_t stream) {
  const int per_sm = blocks_per_sm<Fmt, NMAT, R>();
  if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
  const int grid = std::min(P.units, per_sm * sm_count());   // every block draws units
  if (NMAT == 2) {
    ffn_pass<Fmt, NMAT, R><<<grid, threads<Fmt>(), smem_bytes<Fmt, NMAT, R>(), stream>>>(
        M, w0, w1, x, P, part, counters, out);
    return (int)cudaGetLastError();
  }
  // down: a programmatic dependent launch on gate/up (see the producer)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads<Fmt>());
  cfg.dynamicSmemBytes = smem_bytes<Fmt, NMAT, R>();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, ffn_pass<Fmt, NMAT, R>, M, w0, w1, x, P, part,
                                       counters, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Fmt, int NMAT>
inline int launch_pass(Pass P, const Operand& w0, const Operand& w1, const float* x,
                       float* part, int* counters, float* out, cudaStream_t stream) {
  constexpr int R1 = rows_mid<Fmt, NMAT>(), R2 = max_rows<Fmt, NMAT>();
  Maps M;
  memset(&M, 0, sizeof(M));
  {
    // the boxes of a stage: kBK rows of each matrix's run, its absmax run, R rows of x
    const uint64_t rb = (uint64_t)P.N * (32 / Fmt::kV) / 8, ab = (uint64_t)(P.N / 64) * 4;
    const uint64_t xb = (uint64_t)P.K * 4;
    P.ntx = 0;
    for (int m = 0; m < NMAT; ++m) {
      const Operand& w = m ? w1 : w0;
      if (P.bulk_w) {
        if (!make_map(&M.w[m], w.q, CU_TENSOR_MAP_DATA_TYPE_UINT32, rb / 4, P.K, P.E, rb,
                      rb * P.K, run_bytes<Fmt>() / 4, kBK))
          return (int)cudaErrorInvalidValue;
        P.ntx += kBK * run_bytes<Fmt>();
      }
      if (amax_floats<Fmt>() > 0 && P.bulk_a) {
        if (!make_map(&M.a[m], w.a, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, P.N / 64, P.K, P.E, ab,
                      ab * P.K, amax_floats<Fmt>(), kBK))
          return (int)cudaErrorInvalidValue;
        P.ntx += kBK * amax_floats<Fmt>() * 4;
      }
    }
    if (P.bulk_x) {
      if (!make_map(&M.x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, P.K, P.C, P.E, xb, xb * P.C, kBK,
                    P.rt))
        return (int)cudaErrorInvalidValue;
      P.ntx += P.rt * kBK * 4;
    }
  }
  if (P.rt == 1) return launch_rows<Fmt, NMAT, 1>(P, M, w0, w1, x, part, counters, out, stream);
  if (P.rt == R1) return launch_rows<Fmt, NMAT, R1>(P, M, w0, w1, x, part, counters, out, stream);
  return launch_rows<Fmt, NMAT, R2>(P, M, w0, w1, x, part, counters, out, stream);
}

// Everything a call needs beyond its inputs and output: hu, then the two
// passes' split partials (fp32); per pass, its tile tickets and its unit
// counter and done count (int32).
struct Plan {
  Pass gu, dn;
  long long floats, counters;
};

template <class Fmt>
inline Plan make_plan(int E, int C, int D, int F) {
  Plan pl;
  pl.gu = plan_pass<Fmt, 2>(E, C, D, F);
  pl.dn = plan_pass<Fmt, 1>(E, C, F, D);
  pl.floats = (long long)E * C * F + pl.gu.part_floats + pl.dn.part_floats;
  pl.counters = (long long)E * pl.gu.mt * pl.gu.ct + 2 + (long long)E * pl.dn.mt * pl.dn.ct + 2;
  return pl;
}

// Whether a matrix's rows of n columns can be staged by bulk copies.
template <class Fmt> inline bool bulk_rows(int n, const Operand& w) {
  return ((long long)n * (32 / Fmt::kV) / 8) % 16 == 0 && aligned16(w.q);
}

template <class Fmt> inline bool bulk_amax(int n, const Operand& w) {
  return amax_floats<Fmt>() == 0 || ((n / 64) % 4 == 0 && aligned16(w.a));
}

// The two launches on `stream`: gate/up with SwiGLU, then down.  ws holds
// make_plan(...).floats fp32, counters make_plan(...).counters int32 that
// are zero before the call and zero after it.  Returns the first
// cudaError_t of the launches.
template <class Fmt>
inline int run_ffn(const float* x, const Operand& wg, const Operand& wu, const Operand& wd,
                   float* ws, int* counters, float* y, int E, int C, int D, int F,
                   cudaStream_t stream) {
  Plan pl = make_plan<Fmt>(E, C, D, F);
  float* hu = ws;
  float* part_gu = hu + (size_t)E * C * F;
  float* part_dn = part_gu + pl.gu.part_floats;
  int* cnt_gu = counters;
  int* cnt_dn = counters + (size_t)E * pl.gu.mt * pl.gu.ct + 2;
  pl.gu.bulk_w = bulk_rows<Fmt>(F, wg) && bulk_rows<Fmt>(F, wu);
  pl.gu.bulk_a = bulk_amax<Fmt>(F, wg) && bulk_amax<Fmt>(F, wu);
  pl.gu.bulk_x = D % 4 == 0 && aligned16(x);
  pl.dn.bulk_w = bulk_rows<Fmt>(D, wd);
  pl.dn.bulk_a = bulk_amax<Fmt>(D, wd);
  pl.dn.bulk_x = F % 4 == 0 && aligned16(hu);
  int err = launch_pass<Fmt, 2>(pl.gu, wg, wu, x, part_gu, cnt_gu, hu, stream);
  if (err != 0) return err;
  return launch_pass<Fmt, 1>(pl.dn, wd, wd, hu, part_dn, cnt_dn, y, stream);
}

}  // namespace fpass
