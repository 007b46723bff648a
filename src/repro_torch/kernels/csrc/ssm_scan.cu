// Mamba-1 selective-scan forward for Hopper (sm_90a): one thread per lane.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// src/repro/kernels/ssm_scan.py (launched by `_grid_call` from `_ssm_fwd`,
// behind `ssm_scan` and `ssm_scan_bt_ds`): the recurrence
//
//     h_t = dA_t * h_{t-1} + dBx_t,   t = 0 .. T-1,   h_{-1} = h0,
//
// emitting every h_t (hs) and the last one (hT).  It is elementwise over
// the last two axes of (B, T, S, D) or (B, T, d, s), so the kernel treats
// their product as L independent lanes: element (b, t, lane) lies at
// (b * T + t) * L + lane, h0 and hT at b * L + lane.  One kernel serves both
// layouts; the TPU kernel's transpose and 128-lane padding are not needed.
//
// Each step is one correctly rounded fused multiply-add (__fmaf_rn, built
// with -fmad=false), as the reference's CPU build contracts `dA * h + dBx`
// and as the plain version (`ssm_scan_plain`, core/fp.py `fma`) rounds, so
// the three agree bit for bit.
//
// What bounds it: bytes.  It reads dA, dBx and h0 once and writes hs and hT
// once, 4 * (3 * B * T * L + 2 * B * L) bytes, and does one multiply-add per
// element read.  The design follows from that:
//   - one thread per (b, lane) keeps h in a register and loops over t;
//   - at each step a warp reads 32 neighbouring floats of dA and of dBx and
//     writes 32 of hs, so every access is coalesced;
//   - the t loop is unrolled by UNROLL: the loads of the next UNROLL steps
//     do not depend on h, so they are in flight while the chain of
//     multiply-adds runs;
//   - the grid is ceil(L / threads) x B blocks (2,048 at the serving shape
//     B = 4, L = 131,072), enough to fill the 132 SMs.
// Wider loads and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 8;

__global__ void ssm_scan_fwd_kernel(const float* __restrict__ dA,
                                    const float* __restrict__ dBx,
                                    const float* __restrict__ h0,
                                    float* __restrict__ hs,
                                    float* __restrict__ hT, int T,
                                    long long L) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const long long b = blockIdx.y;
  const long long base = b * T * L + lane;
  float h = h0[b * L + lane];
  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float a[UNROLL], x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(t + u) * L;
      a[u] = __ldg(dA + i);
      x[u] = __ldg(dBx + i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fmaf_rn(a[u], h, x[u]);
      hs[base + (long long)(t + u) * L] = h;
    }
  }
  for (; t < T; ++t) {
    const long long i = base + (long long)t * L;
    h = __fmaf_rn(__ldg(dA + i), h, __ldg(dBx + i));
    hs[i] = h;
  }
  hT[b * L + lane] = h;
}

}  // namespace

// Launches one thread per (b, lane) on `stream`; allocates nothing and does
// not synchronise.  dA, dBx, hs: (B, T, L) float32; h0, hT: (B, L) float32;
// all contiguous.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ssm_scan_fwd_launch(const void* dA, const void* dBx,
                                   const void* h0, void* hs, void* hT,
                                   long long B, int T, long long L,
                                   int threads, void* stream) {
  if (B < 0 || T < 0 || L < 0 || threads < 32 || threads > 1024 ||
      threads % 32)
    return cudaErrorInvalidValue;
  if (B == 0 || L == 0) return cudaSuccess;
  const long long blocks = (L + threads - 1) / threads;
  if (blocks > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  ssm_scan_fwd_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hT), T, L);
  return cudaGetLastError();
}
