// Mamba2 (SSD) inter-chunk state recurrence, for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan/kernel.py:44
// `ssd_scan_kernel` (its pallas_call is at :53).  For every batch row b and
// SSM head h, over the chunk index c in order,
//
//     h_in[b,c,h] = state                                (state entering chunk c)
//     state       = decay[b,c,h] * state + s[b,c,h]      (a scalar decay per head)
//
// with s, h_in: (B,NC,H,P,N) fp32, decay: (B,NC,H) fp32, the state and
// h_last: (B,H,P,N) fp32.  The state starts at h0 (B,H,P,N) when one is
// given and at zero otherwise; zero is the TPU kernel's function, h0 is the
// `initial_state` that `models/mamba.py` accepts.
//
// Bound: every element of s is read once and every element of h_in and
// h_last written once, with one multiply and one add per element of s, so
// the time is set by bytes, (2*NC + 1)*B*H*P*N*4 over device memory
// bandwidth (3.35 TB/s).  Design for that: many independent threads, 16-byte
// accesses, and the loads of s issued ahead of the dependent chain.
//
// Structure.  The TPU kernel ran the chunk axis as the last, sequential grid
// axis on one core and kept the state in a revisited output tile.  Blocks
// here run in parallel and in no order, so the chunk axis becomes a loop
// inside each thread: a thread owns one float4 of one (b, h) state and
// walks the chunks (the caller refuses P*N not a multiple of 4 and pointers
// that are not 16-byte aligned).  A block of 256 threads covers a run of
// one head, so all its threads read the same decay[b, c, h].  The loop takes
// the chunks kAhead at a time: it issues the kAhead loads of s (and of
// decay) first, none of which depends on the state, then runs the kAhead
// dependent steps.  At Jamba's shape (H=128, P=64, N=128) a batch row is
// 1024 blocks.
//
// Rounding.  A step is __fadd_rn(__fmul_rn(decay, state), s): two roundings,
// never contracted into an FMA, which is what the plain PyTorch version
// (`decay * h + s`, two eager operations) computes, so the two agree bit for
// bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 4;                 // chunks whose loads are in flight at once

__device__ __forceinline__ float step(float d, float h, float s) {
  return __fadd_rn(__fmul_rn(d, h), s);
}

__device__ __forceinline__ float4 step(float d, float4 h, float4 s) {
  return make_float4(step(d, h.x, s.x), step(d, h.y, s.y), step(d, h.z, s.z),
                     step(d, h.w, s.w));
}

// M is the number of float4 per (b, h) state.
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float4* __restrict__ s, const float* __restrict__ decay,
                const float4* __restrict__ h0, float4* __restrict__ h_in,
                float4* __restrict__ h_last, int NC, int H, int M) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= M) return;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long state = (b * H + h) * M + j;                 // (b, h, j) of (B,H,M)
  const long long first = (b * NC * H + h) * M + j;            // (b, 0, h, j) of (B,NC,H,M)
  const long long cstride = (long long)H * M;                  // one chunk
  const float* dec = decay + b * NC * H + h;                   // decay[b, c, h] = dec[c * H]
  float4 hv = h0 != nullptr ? h0[state] : make_float4(0.f, 0.f, 0.f, 0.f);
  int c = 0;
  for (; c + kAhead <= NC; c += kAhead) {
    float4 sv[kAhead];
    float dv[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      sv[u] = __ldg(s + first + (c + u) * cstride);
      dv[u] = __ldg(dec + (long long)(c + u) * H);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      h_in[first + (c + u) * cstride] = hv;
      hv = step(dv[u], hv, sv[u]);
    }
  }
  for (; c < NC; ++c) {
    const float4 sv = __ldg(s + first + c * cstride);
    const float dv = __ldg(dec + (long long)c * H);
    h_in[first + c * cstride] = hv;
    hv = step(dv, hv, sv);
  }
  h_last[state] = hv;
}

}  // namespace

// PN = P*N floats per (b, h) state; the caller checks PN % 4 == 0 and the
// 16-byte alignment of every pointer.  h0 may be null (zero start).
// Launches on `stream` and returns the cudaError_t of the launch
// (0 = success).
extern "C" int ssd_scan_launch(const void* s, const void* decay, const void* h0, void* h_in,
                               void* h_last, int B, int NC, int H, int PN, void* stream) {
  const int M = PN / 4;
  const dim3 grid((M + kThreads - 1) / kThreads, H, B);
  ssd_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(s), static_cast<const float*>(decay),
      static_cast<const float4*>(h0), static_cast<float4*>(h_in), static_cast<float4*>(h_last),
      NC, H, M);
  return static_cast<int>(cudaGetLastError());
}
