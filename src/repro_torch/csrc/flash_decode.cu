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
// (3.35 TB/s).  At a serve step (W of a few hundred slots) those bytes take
// under a microsecond, and what is left is latency: launches, DRAM round
// trips and chains of dependent steps.
//
// Design: one launch, one DRAM round trip per chunk.  W is cut into fixed
// chunks of kChunk slots, numbered from slot 0.  A block takes a run of
// consecutive chunks of one (row, kv head): one at a serve step, so that B=4
// W=144 still puts 96 blocks on the card, up to kSuper at long windows.  It
// issues all of a chunk's K and V rows at once as bulk asynchronous copies
// (cp.async.bulk, completing on an mbarrier) into a two-stage ring in
// shared memory, so the next chunk's rows are in flight while this one is
// computed; q and the slots' kpos are loaded meanwhile.  Each chunk's
// scores, softmax and P.V run from shared memory and write the chunk's max
// m_c, exp-sum l_c and unnormalised P.V sums acc_c to a workspace.  For
// bf16 with Hd % 16 == 0 both products run on tensor cores (mma.sync
// m16n8k16, fp32 sums): q.K^T on bf16 q and K, exact products; P.V with p
// split into two bf16 terms (hi, lo), at most 2^-18 relative; other inputs
// take a CUDA-core step.  Tickets from counters then chain the combine into
// the same launch: the block that completes a super-chunk (kSuper chunks)
// combines that super-chunk's chunks in index order, and the block that
// completes the (row, kv head) combines the super-chunks in index order
// and writes the output; each resets the counter it completed, so no
// second launch and no memset are needed.  (One level over all of a
// 32768-slot window's 512 chunks would leave one block reading 1 MB of
// partials at the end of the launch; two levels read 32 KB and 64 KB.)
// Rows whose K/V rows are not whole 16-byte runs (Hd*sizeof(T) % 16 != 0)
// or whose base pointers are not 16-byte aligned are copied element by
// element into the same tiles, zero padded to whole runs, and go through
// the same arithmetic.  Three blocks are resident on each SM at Hd=128
// bf16 (about 74 KB of shared memory each).
//
// Invariance.  The order of every sum depends only on the slot index, G,
// Hd and kChunk: a score adds its head-dim columns in k16 steps in order
// (tensor cores) or in four fixed quarters of 16-byte runs, then the
// quarters in a fixed tree (CUDA cores); l_c adds a lane's two slots, then
// the lanes in a fixed shuffle tree; acc_c adds the chunk's slots in k16
// steps in order, each p term in turn (tensor cores), or the valid slots
// of each fixed slot split in index order, then the splits in order (CUDA
// cores); the combines add chunks, then super-chunks, in index order.  A
// masked slot contributes p = 0: on tensor cores a zero product (rows past
// W are zeroed first), on CUDA cores no product at all; a chunk or
// super-chunk with no valid slot adds nothing in a combine, and a combine in
// which one partial alone is valid returns it bit for bit (its scale is
// exactly 1).  So a row's output does not depend on B (each row has its own
// blocks and its own combine), on W, on how many chunks a block takes, or
// on masked tail slots, and a row whose window fits one chunk goes through
// the same combine on one partial (a window that fits one super-chunk
// skips the second level, which would return its one partial).  That is
// what lets a request decoded in a composed batch equal its solo decode bit
// for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kChunk = 64;                // slots per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;                 // query heads per kv head
constexpr int kMaxHd = 256;
constexpr int kHeadTile = 2;              // heads a P.V thread accumulates
constexpr int kQuarters = 4;              // column quarters a score is cut into
constexpr int kSuper = 16;                // chunks a first-level combine takes
constexpr int kCombineCols = 2;          // output columns a combining thread holds
constexpr int kBlocksWanted = 2048;      // blocks a launch keeps when it takes more chunks a block
constexpr float kNegInf = -1e30f;
static_assert(kChunk == 2 * 32, "the softmax step gives a lane two slots");
static_assert(kThreads == kQuarters * kChunk, "a score thread takes one slot and quarter");

template <typename T> struct Run { static constexpr int cols = 16 / sizeof(T); };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// The columns of one 16-byte run in shared memory, as floats.
__device__ __forceinline__ void unpack(const unsigned char* p, float (&out)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
  out[3] = r.w;
}
__device__ __forceinline__ void unpack(const unsigned char* p, float (&out)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // bf16 -> fp32 is exact: the top 16 bits
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Expect `bytes` more on bar and arrive (its one arrival per phase).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
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
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (4ll << 30)) __trap();
  }
}

// One contiguous run of bytes from global to shared memory, completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major); bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory layout of a block, in bytes from the (16-byte aligned) base:
// two stages of K and V tiles (a chunk's rows), then q, the scores' partial
// dots (then the probabilities, then the combine's scratch), the P.V
// splits' sums (unless they fit the stage's K tile, read by then) and the
// slots' validity.  Three blocks fit an SM at Hd=128 bf16.
// The bf16 terms of the probabilities (hi, lo) for the MMA step: two planes
// of 16 rows (heads, zero past G) of kChunk slots, in the stage's K tile
// when they fit.
constexpr int kPRowBytes = kChunk * 2 + 16;

struct Layout {
  int hdp;          // Hd rounded up to a whole 16-byte run
  int rowb;         // bytes of a K or V row in shared memory (a run of padding:
                    // neighbouring rows start in other banks)
  int splits;       // slot splits of the P.V step (CUDA-core step)
  size_t tile;      // bytes of one K (or V) tile
  bool red_in_k;    // the P.V splits' sums fit the stage's K tile (free by then)
  bool ph_in_k;     // (MMA) the probabilities' bf16 terms fit the stage's K tile
  size_t kv, q, p, dot, red, ph, valid, comb, total;
};

// MMA: the tensor-core step (bf16, Hd % 16 == 0), whose q is bf16 rows
// (kQRows of them, zero past G), whose probabilities' bf16 terms live in
// the stage's K tile, and which needs no partial dots and no split sums.
template <typename T, bool MMA>
__host__ __device__ inline Layout layout(int G, int Hd) {
  constexpr int V = Run<T>::cols;
  Layout L;
  L.hdp = (Hd + V - 1) / V * V;
  L.rowb = L.hdp * (int)sizeof(T) + 16;
  const int units = (L.hdp / V) * ((G + kHeadTile - 1) / kHeadTile);
  L.splits = 1;
  while (L.splits * 2 * units <= kThreads && L.splits * 2 <= kChunk) L.splits *= 2;
  L.tile = (size_t)kChunk * L.rowb;
  L.kv = 32;                                    // [0, 16): the two stages' mbarriers
  L.q = L.kv + 4 * L.tile;                      // stage s: K at kv + 2s tile, V after it
  L.ph_in_k = false;
  if (MMA) {
    L.p = L.q + (size_t)(G <= 8 ? 8 : 16) * L.rowb;
    L.dot = L.red = L.p;                        // unused
    L.red_in_k = true;
    L.ph = L.p + (size_t)G * kChunk * 4;
    L.ph_in_k = 2 * 16 * kPRowBytes <= L.tile;
    L.valid = L.ph + (L.ph_in_k ? 0 : 2 * 16 * kPRowBytes);
    L.comb = (L.valid + kChunk + 15) / 16 * 16;
    L.total = L.comb + (size_t)(2 * kMaxG + 3 * kSuper * G) * 4;
    return L;
  }
  L.dot = L.q + (size_t)G * L.hdp * 4;          // the score quarters' partial dots; the
  L.p = L.dot;                                  // probabilities overwrite the first
  L.comb = L.dot;                               // quarter, the combine all of it
  L.red = L.dot + (size_t)kQuarters * G * kChunk * 4;
  const size_t red = (size_t)L.splits * G * L.hdp * 4;
  L.red_in_k = red <= L.tile;
  L.valid = L.red + (L.red_in_k ? 0 : red);
  L.total = (L.valid + kChunk + 15) / 16 * 16;
  return L;
}

// Combine n partials (m, l, acc) of one (row, kv head), in index order, with
// the whole block: m = the max of the partials' m with l > 0 (exact in any
// order), then l = sum l_i e^(m_i - m) and acc = sum acc_i e^(m_i - m), a
// partial with l_i = 0 adding nothing (a select).  With `out` the result is
// acc / max(l, 1e-30); otherwise (m, l, acc) go to (om, ol, oacc).  When one
// partial alone has l > 0 its scale is exactly 1, so the result equals that
// partial bit for bit.  A tile of kSuper partials is read at once: its acc
// loads are issued before its scales are known, and a combine of at most
// kSuper partials (every first-level one) reads global memory once.
__device__ void combine(const float* pacc, const float* pm, const float* pl, int n, int G, int Hd,
                        float* scratch, float* out, float* oacc, float* om, float* ol) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* smax = scratch;
  float* sfin = smax + kMaxG;                     // max(l, 1e-30) per head
  float* sm = sfin + kMaxG;                       // a tile's m, l and scales
  float* sl = sm + kSuper * G;
  float* sscale = sl + kSuper * G;
  const bool one_tile = n <= kSuper;
  if (!one_tile) {
    for (int g = warp; g < G; g += kWarps) {
      float m = kNegInf;
      for (int i = lane; i < n; i += 32)
        if (__ldcg(pl + (size_t)i * G + g) > 0.f) m = fmaxf(m, __ldcg(pm + (size_t)i * G + g));
      m = warp_max(m);
      if (lane == 0) smax[g] = m;
    }
  }
  const int ncol = G * Hd;
  float l = 0.f;                                  // threads < G: that head's exp-sum
  for (int col0 = 0; col0 < ncol; col0 += kCombineCols * kThreads) {
    float acc[kCombineCols];
#pragma unroll
    for (int r = 0; r < kCombineCols; ++r) acc[r] = 0.f;
    for (int i0 = 0; i0 < n; i0 += kSuper) {
      const int nt = min(kSuper, n - i0);
      float x[kCombineCols][kSuper];
#pragma unroll
      for (int r = 0; r < kCombineCols; ++r) {
        const int col = col0 + r * kThreads + tid;
#pragma unroll
        for (int i = 0; i < kSuper; ++i)
          x[r][i] = (col < ncol && i < nt) ? __ldcg(pacc + (size_t)(i0 + i) * ncol + col) : 0.f;
      }
      if (tid < nt * G) {
        sm[tid] = __ldcg(pm + (size_t)i0 * G + tid);
        sl[tid] = __ldcg(pl + (size_t)i0 * G + tid);
      }
      __syncthreads();
      if (one_tile) {
        if (tid < G) {
          float m = kNegInf;
          for (int i = 0; i < nt; ++i)
            if (sl[i * G + tid] > 0.f) m = fmaxf(m, sm[i * G + tid]);
          smax[tid] = m;
        }
        __syncthreads();
      }
      if (tid < nt * G) sscale[tid] = sl[tid] > 0.f ? expf(sm[tid] - smax[tid % G]) : 0.f;
      __syncthreads();
      if (col0 == 0 && tid < G) {
        for (int i = 0; i < nt; ++i) {
          const float sc = sscale[i * G + tid];
          if (sc != 0.f) l = fmaf(sl[i * G + tid], sc, l);
        }
      }
#pragma unroll
      for (int r = 0; r < kCombineCols; ++r) {
        const int col = col0 + r * kThreads + tid;
        const int g = min(col / Hd, G - 1);
#pragma unroll
        for (int i = 0; i < kSuper; ++i) {
          const float sc = i < nt ? sscale[i * G + g] : 0.f;
          acc[r] = sc != 0.f ? fmaf(x[r][i], sc, acc[r]) : acc[r];
        }
      }
      __syncthreads();
    }
    if (col0 == 0 && tid < G) {
      if (out != nullptr) sfin[tid] = fmaxf(l, 1e-30f);
      else {
        om[tid] = smax[tid];
        ol[tid] = l;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kCombineCols; ++r) {
      const int col = col0 + r * kThreads + tid;
      if (col < ncol) {
        if (out != nullptr) out[col] = acc[r] / sfin[col / Hd];
        else oacc[col] = acc[r];
      }
    }
  }
}

// Add `v` to *p with release and acquire semantics at device scope: the
// writes the block made before a barrier are visible to whoever reads the
// sum after it, and what was released before the sum is visible here.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// True in every thread of the block whose `add` tickets completed the `n`
// of *counter (which it then resets); that block sees every write the
// others made before drawing theirs.
__device__ __forceinline__ bool last_ticket(int* counter, int add, int n, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomic_add_acq_rel(counter, add) + add == n;
    if (last) *counter = 0;                      // every other ticket is drawn
    *s_flag = last;
  }
  __syncthreads();
  return *s_flag != 0;
}

// Grid (ceil(n_chunks / per_block), K, B): a block takes `per_block`
// consecutive chunks (a power of two dividing kSuper, so they lie in one
// super-chunk) through a two-stage ring: the next chunk's rows are in flight
// while this one is computed.  Workspace: per (row, kv head) the chunk
// partials acc (n_chunks, G, Hd), m and l (n_chunks, G), then the
// super-chunk partials acc (n_super, G, Hd), m and l (n_super, G).
// Counters: one per (row, kv head, super-chunk), then one per (row, kv
// head); zero between launches.
template <typename T, bool MMA>
__global__ void __launch_bounds__(kThreads, 3)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kpos, const int* __restrict__ pos, int W, int K, int G,
             int Hd, int window, int bulk, int per_block, float* __restrict__ ws,
             int* __restrict__ counters, float* __restrict__ out) {
  constexpr int V = Run<T>::cols;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T, MMA>(G, Hd);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sq = reinterpret_cast<float*>(smem + L.q);
  float* sp = reinterpret_cast<float*>(smem + L.p);
  float* sdot = reinterpret_cast<float*>(smem + L.dot);
  unsigned char* svalid = smem + L.valid;
  float* scratch = reinterpret_cast<float*>(smem + L.comb);
  __shared__ int s_flag;

  const int n_chunks = (W + kChunk - 1) / kChunk, n_super = (n_chunks + kSuper - 1) / kSuper;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int c_first = blockIdx.x * per_block;
  const int c_end = min(n_chunks, c_first + per_block);
  const int rows = gridDim.y * gridDim.z, row = b * K + kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hdp = L.hdp, rowb = L.rowb, GH = G * Hd;
  const size_t slot_stride = (size_t)K * Hd;
  const uint32_t row_bytes = (uint32_t)(Hd * sizeof(T));
  const int p_b = pos[b];

  // Every K and V row of chunk c in flight at once, into stage st.
  auto issue = [&](int c, int st) {
    const int hi = min(kChunk, W - c * kChunk);
    const size_t first = ((size_t)b * W + (size_t)c * kChunk) * slot_stride + (size_t)kh * Hd;
    unsigned char* sk = smem + L.kv + 2 * st * L.tile;
    if (tid == 0) mbar_expect_tx(&bars[st], 2u * hi * row_bytes);
    __syncthreads();          // the expectation precedes every completion
    if (tid < 2 * hi) {
      const int j = tid < hi ? tid : tid - hi;
      const T* src = (tid < hi ? k : v) + first + (size_t)j * slot_stride;
      bulk_copy(sk + (tid < hi ? 0 : L.tile) + (size_t)j * rowb, src, row_bytes, &bars[st]);
    }
  };
  auto valid_of = [&](int c) {
    bool ok = false;
    if (tid < kChunk && c * kChunk + tid < W) {
      const int kp = kpos[(size_t)b * W + (size_t)c * kChunk + tid];
      ok = kp >= 0 && kp <= p_b && (window == 0 || p_b - kp < window);
    }
    return ok;
  };

  if (bulk) {
    if (tid == 0) {
      mbar_init(&bars[0], 1);
      mbar_init(&bars[1], 1);
    }
    __syncthreads();
    issue(c_first, 0);
    if (c_first + 1 < c_end) issue(c_first + 1, 1);
  }
  // q, while the rows fly: fp32 rows zero padded to hdp, or (MMA) bf16 rows
  // of K's row layout, zero past G.
  const T* qb = q + (size_t)row * GH;
  if constexpr (MMA) {
    const int qrows = G <= 8 ? 8 : 16;
    for (int i = tid; i < qrows * Hd; i += kThreads) {
      const int g = i / Hd, h = i % Hd;
      reinterpret_cast<T*>(smem + L.q + (size_t)g * rowb)[h] =
          g < G ? qb[(size_t)g * Hd + h] : zero<T>();
    }
  } else {
    for (int i = tid; i < G * hdp; i += kThreads) {
      const int g = i / hdp, h = i % hdp;
      sq[i] = h < Hd ? to_float(qb[(size_t)g * Hd + h]) : 0.f;
    }
  }
  bool ok_next = valid_of(c_first);

  for (int c = c_first; c < c_end; ++c) {
    const int it = c - c_first, st = it & 1;
    const int hi = min(kChunk, W - c * kChunk);       // in-bounds slots of this chunk
    unsigned char* sk = smem + L.kv + 2 * st * L.tile;
    unsigned char* sv = sk + L.tile;
    if (!bulk) {
      const size_t first = ((size_t)b * W + (size_t)c * kChunk) * slot_stride + (size_t)kh * Hd;
      for (int i = tid; i < hi * hdp; i += kThreads) {
        const int j = i / hdp, h = i % hdp;
        reinterpret_cast<T*>(sk + (size_t)j * rowb)[h] =
            h < Hd ? k[first + (size_t)j * slot_stride + h] : zero<T>();
        reinterpret_cast<T*>(sv + (size_t)j * rowb)[h] =
            h < Hd ? v[first + (size_t)j * slot_stride + h] : zero<T>();
      }
    }
    if (MMA && hi < kChunk) {                 // rows past W: zeros, not stale bytes
      for (int i = tid; i < (kChunk - hi) * (rowb / 16); i += kThreads)
        reinterpret_cast<uint4*>(sv + (size_t)hi * rowb)[i] = make_uint4(0, 0, 0, 0);
    }
    if (tid < kChunk) svalid[tid] = ok_next;
    if (c + 1 < c_end) ok_next = valid_of(c + 1);     // in flight during this chunk
    __syncthreads();
    if (bulk) mbar_wait(&bars[st], (it >> 1) & 1);

    // Scores.  MMA: warp (slot tile mt, head tile nt) runs the k16 steps of
    // Hd in order on its 16 slots x 8 heads.  Otherwise thread (slot j,
    // column quarter qt) takes every head over the column runs qt, qt + 4,
    // ... in order, and the quarters' partial dots are added as (0 + 1) +
    // (2 + 3).  Masked and out-of-bounds slots get the sentinel (a select:
    // their rows may hold anything).
    if constexpr (MMA) {
      const int ntg = (G + 7) / 8;
      if (warp < 4 * ntg) {
        const int mt = warp & 3, nt = warp >> 2;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* arow =
            sk + (size_t)(mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rowb + (lane >> 4) * 16;
        const unsigned char* brow =
            smem + L.q + (size_t)(nt * 8 + (lane & 7)) * rowb + ((lane >> 3) & 1) * 16;
        for (int h0 = 0; h0 < Hd; h0 += 16) {
          uint32_t a[4], bq[2];
          ldmatrix_x4(a, arow + h0 * 2);
          ldmatrix_x2(bq, brow + h0 * 2);
          mma_bf16(d, a, bq);
        }
        const float scale_div = sqrtf((float)Hd);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = mt * 16 + (lane >> 2) + (i >> 1) * 8, g = nt * 8 + 2 * (lane & 3) + (i & 1);
          if (g < G) sp[g * kChunk + j] = svalid[j] ? d[i] / scale_div : kNegInf;
        }
      }
    } else {
      const int j = tid % kChunk, qt = tid / kChunk;
      const unsigned char* krow = sk + (size_t)j * rowb;
      float acc[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
      for (int h = qt * V; h < hdp; h += kQuarters * V) {
        float kv[V];
        unpack(krow + h * sizeof(T), kv);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* qg = sq + g * hdp + h;
#pragma unroll
            for (int u = 0; u < V; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + u);
              acc[g] = fmaf(qv.x, kv[u], acc[g]);
              acc[g] = fmaf(qv.y, kv[u + 1], acc[g]);
              acc[g] = fmaf(qv.z, kv[u + 2], acc[g]);
              acc[g] = fmaf(qv.w, kv[u + 3], acc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) sdot[(qt * G + g) * kChunk + j] = acc[g];
      __syncthreads();
      const float scale_div = sqrtf((float)Hd);
      for (int i = tid; i < G * kChunk; i += kThreads) {
        const float* dd = sdot + i;
        const float dot = (dd[0] + dd[G * kChunk]) + (dd[2 * G * kChunk] + dd[3 * G * kChunk]);
        sp[i] = svalid[i % kChunk] ? dot / scale_div : kNegInf;   // in place of dd[0]
      }
    }
    __syncthreads();

    // Per head: the chunk max (exact in any order), probabilities (exactly
    // 0 for masked and out-of-bounds slots) and l_c (a lane's two slots in
    // order, then a fixed shuffle tree).  Warp w takes heads w, w + 8.
    float* part_acc = ws + ((size_t)row * n_chunks + c) * GH;
    float* part_m = ws + (size_t)rows * n_chunks * GH + ((size_t)row * n_chunks + c) * G;
    float* part_l = part_m + (size_t)rows * n_chunks * G;
    for (int g = warp; g < (MMA ? 16 : G); g += kWarps) {
      float p0 = 0.f, p1 = 0.f;
      if (g < G) {
        const float s0 = sp[g * kChunk + lane], s1 = sp[g * kChunk + lane + 32];
        const float m = warp_max(fmaxf(s0, s1));
        p0 = s0 == kNegInf ? 0.f : expf(s0 - m);
        p1 = s1 == kNegInf ? 0.f : expf(s1 - m);
        const float l = warp_sum(p0 + p1);
        if (lane == 0) {
          part_m[g] = m;
          part_l[g] = l;
        }
      }
      if constexpr (MMA) {                    // p = hi + lo, each bf16 (to about 2^-18)
        unsigned char* ph = (L.ph_in_k ? sk : smem + L.ph) + (size_t)g * kPRowBytes;
        const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
        reinterpret_cast<__nv_bfloat16*>(ph)[lane] = h0;
        reinterpret_cast<__nv_bfloat16*>(ph)[lane + 32] = h1;
        reinterpret_cast<__nv_bfloat16*>(ph + 16 * kPRowBytes)[lane] =
            __float2bfloat16_rn(p0 - __bfloat162float(h0));
        reinterpret_cast<__nv_bfloat16*>(ph + 16 * kPRowBytes)[lane + 32] =
            __float2bfloat16_rn(p1 - __bfloat162float(h1));
      } else {
        sp[g * kChunk + lane] = p0;
        sp[g * kChunk + lane + 32] = p1;
      }
    }
    __syncthreads();

    // P.V.  MMA: warp w takes the head-dim tiles nt = w, w + 8, ... of 8
    // columns; for each, the k16 steps of the chunk's slots in order, each as
    // two MMAs (p's hi, then lo, terms) into one fp32 accumulator; masked
    // slots have p = 0 and rows past W are zeros.  Otherwise unit (column run
    // cg, head pair ht, slot split s) adds the split's valid slots in index
    // order (a masked or out-of-bounds slot is skipped by every thread
    // alike), then the splits' sums are added in split order.
    if constexpr (MMA) {
      const unsigned char* ph = L.ph_in_k ? sk : smem + L.ph;
      uint32_t a[2][kChunk / 16][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
          ldmatrix_x4(a[t][ks], ph + t * 16 * kPRowBytes +
                                    (size_t)((lane & 7) + ((lane >> 3) & 1) * 8) * kPRowBytes +
                                    (ks * 16 + (lane >> 4) * 8) * 2);
      for (int nt = warp; nt < Hd / 8; nt += kWarps) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks) {
          uint32_t bv[2];
          ldmatrix_x2_trans(bv, sv + (size_t)(ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * rowb +
                                    nt * 16);
          mma_bf16(d, a[0][ks], bv);
          mma_bf16(d, a[1][ks], bv);
        }
        const int g = lane >> 2, h = nt * 8 + 2 * (lane & 3);
        if (g < G) *reinterpret_cast<float2*>(part_acc + (size_t)g * Hd + h) = make_float2(d[0], d[1]);
        if (g + 8 < G)
          *reinterpret_cast<float2*>(part_acc + (size_t)(g + 8) * Hd + h) = make_float2(d[2], d[3]);
      }
      __syncthreads();        // this stage is read: the chunk after next may refill it
    } else {
      float* red = reinterpret_cast<float*>(L.red_in_k ? sk : smem + L.red);
      const int ncg = hdp / V, nht = (G + kHeadTile - 1) / kHeadTile;
      const int units = ncg * nht, per_split = kChunk / L.splits;
      for (int u = tid; u < units * L.splits; u += kThreads) {
        const int cg = u % ncg, ht = (u / ncg) % nht, s = u / units;
        float acc[kHeadTile][V];
#pragma unroll
        for (int a = 0; a < kHeadTile; ++a)
#pragma unroll
          for (int i = 0; i < V; ++i) acc[a][i] = 0.f;
        for (int j = s * per_split; j < (s + 1) * per_split; ++j) {
          if (!svalid[j]) continue;             // the same slot in every thread
          float vv[V];
          unpack(sv + (size_t)j * rowb + cg * 16, vv);
#pragma unroll
          for (int a = 0; a < kHeadTile; ++a) {
            const int g = ht * kHeadTile + a;
            const float p = g < G ? sp[g * kChunk + j] : 0.f;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[a][i] = fmaf(p, vv[i], acc[a][i]);
          }
        }
#pragma unroll
        for (int a = 0; a < kHeadTile; ++a) {
          const int g = ht * kHeadTile + a;
          if (g < G) {
            float4* dst = reinterpret_cast<float4*>(red + ((size_t)s * G + g) * hdp + cg * V);
#pragma unroll
            for (int i = 0; i < V; i += 4)
              dst[i / 4] = make_float4(acc[a][i], acc[a][i + 1], acc[a][i + 2], acc[a][i + 3]);
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < GH; idx += kThreads) {
        const int g = idx / Hd, h = idx % Hd;
        float a = red[(size_t)g * hdp + h];
        for (int s = 1; s < L.splits; ++s) a += red[((size_t)s * G + g) * hdp + h];
        part_acc[idx] = a;
      }
      __syncthreads();        // sp and this stage are read: the next chunk rewrites sp,
    }                         // and the chunk after next this stage
    if (bulk && c + 2 < c_end) issue(c + 2, st);
  }

  // The block that completes a super-chunk combines its chunks; the block
  // that completes the (row, kv head) combines the super-chunks and writes
  // the output (directly, when there is one super-chunk).
  const int S = c_first / kSuper, n_in = min(kSuper, n_chunks - S * kSuper);
  if (!last_ticket(counters + (size_t)row * n_super + S, c_end - c_first, n_in, &s_flag)) return;
  const size_t c0 = (size_t)row * n_chunks + (size_t)S * kSuper;
  const float* pacc = ws + c0 * GH;
  const float* pm = ws + (size_t)rows * n_chunks * GH + c0 * G;
  const float* pl = pm + (size_t)rows * n_chunks * G;
  float* o = out + (size_t)row * GH;
  if (n_super == 1) {
    combine(pacc, pm, pl, n_in, G, Hd, scratch, o, nullptr, nullptr, nullptr);
    return;
  }
  float* sacc = ws + (size_t)rows * n_chunks * (GH + 2 * G);
  float* smx = sacc + (size_t)rows * n_super * GH;
  float* slx = smx + (size_t)rows * n_super * G;
  const size_t s0 = (size_t)row * n_super;
  combine(pacc, pm, pl, n_in, G, Hd, scratch, nullptr, sacc + (s0 + S) * GH, smx + (s0 + S) * G,
          slx + (s0 + S) * G);
  if (!last_ticket(counters + (size_t)rows * n_super + row, 1, n_super, &s_flag)) return;
  combine(sacc + s0 * GH, smx + s0 * G, slx + s0 * G, n_super, G, Hd, scratch, o, nullptr,
          nullptr, nullptr);
}

template <typename T, bool MMA>
int launch_step(const void* q, const void* k, const void* v, const int* kpos, const int* pos,
           float* ws, int* counters, float* out, int B, int W, int K, int G, int Hd, int window,
           cudaStream_t stream) {
  if (G > kMaxG || Hd > kMaxHd) return (int)cudaErrorInvalidValue;
  const int n_chunks = (W + kChunk - 1) / kChunk;
  const bool bulk = (Hd * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const Layout L = layout<T, MMA>(G, Hd);
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, MMA>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  // Chunks per block: one while that leaves blocks to spare on the card
  // (a serve step), more at long windows, up to kSuper.
  int per_block = 1;
  while (per_block < kSuper &&
         (long long)B * K * ((n_chunks + 2 * per_block - 1) / (2 * per_block)) >= kBlocksWanted)
    per_block *= 2;
  const int grid_x = (n_chunks + per_block - 1) / per_block;
  flash_kernel<T, MMA><<<dim3(grid_x, K, B), kThreads, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kpos, pos, W,
      K, G, Hd, window, bulk ? 1 : 0, per_block, ws, counters, out);
  return (int)cudaGetLastError();
}

// bf16 with Hd a multiple of 16 takes the tensor-core step, the rest the
// CUDA-core step.
template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kpos, const int* pos,
           float* ws, int* counters, float* out, int B, int W, int K, int G, int Hd, int window,
           cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (Hd % 16 == 0)
      return launch_step<T, true>(q, k, v, kpos, pos, ws, counters, out, B, W, K, G, Hd, window,
                                  stream);
  }
  return launch_step<T, false>(q, k, v, kpos, pos, ws, counters, out, B, W, K, G, Hd, window,
                               stream);
}

}  // namespace

extern "C" int flash_decode_chunk() { return kChunk; }

extern "C" int flash_decode_max_group() { return kMaxG; }

extern "C" int flash_decode_max_head_dim() { return kMaxHd; }

// Floats of the workspace: per (row, kv head) the chunk partials (acc, then
// m and l, per chunk and head), then the super-chunk partials likewise.
extern "C" long long flash_decode_workspace_floats(int B, int W, int K, int G, int Hd) {
  const long long n_chunks = (W + kChunk - 1) / kChunk;
  const long long n_super = (n_chunks + kSuper - 1) / kSuper;
  return (long long)B * K * (n_chunks + n_super) * G * (2 + (long long)Hd);
}

// int32 counters a launch needs: one per (row, kv head, super-chunk) and one
// per (row, kv head), all zero before the first launch; every launch leaves
// them zero.
extern "C" long long flash_decode_counters(int B, int W, int K) {
  const long long n_chunks = (W + kChunk - 1) / kChunk;
  return (long long)B * K * ((n_chunks + kSuper - 1) / kSuper + 1);
}

// dtype: 0 = fp32, 1 = bf16 (q, k and v share it).  One launch on `stream`;
// returns its cudaError_t (0 = success).  ws and counters belong to this
// launch until it ends: two launches in flight at once need two of each.
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v,
                                   const void* kpos, const void* pos, void* ws, void* counters,
                                   void* out, int B, int W, int K, int G, int Hd, int window,
                                   int dtype, void* stream) {
  const int* kp = static_cast<const int*>(kpos);
  const int* ps = static_cast<const int*>(pos);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, kp, ps, w, cnt, o, B, W, K, G, Hd, window, s);
  return launch<float>(q, k, v, kp, ps, w, cnt, o, B, W, K, G, Hd, window, s);
}
