// Mamba-1 selective scan for Hopper (sm_90a), forward and backward: one
// thread per lane.
//
// The forward replaces the Pallas TPU kernel `_fwd_kernel` of
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
// Each forward step is one correctly rounded fused multiply-add
// (__fmaf_rn, built with -fmad=false), as the reference's CPU build
// contracts `dA * h + dBx` and as the plain version (`ssm_scan_plain`,
// core/fp.py `fma`) rounds, so the three agree bit for bit.
//
// The backward replaces `_bwd_kernel` (launched by `_grid_call` from
// `_bwd_rule`, the reference's custom_vjp): from the residuals (dA, hs, h0)
// and the cotangents (g of hs, g_hT of hT) it runs the reverse recurrence
//
//     gh = g_hT;  for t = T-1 .. 0:
//         gh = gh + g_t;  ddA_t = gh * h_{t-1};  ddBx_t = gh;  gh = dA_t * gh
//     dh0 = gh
//
// over the same lanes.  The reference's loop carries gh across the
// fori_loop boundary, so its CPU build rounds the add and both products
// separately; so do this kernel (__fadd_rn, __fmul_rn) and the plain
// version (`ssm_scan_bwd_plain`): the carry is not fused.
//
// What bounds both: bytes.  The forward reads dA, dBx and h0 once and
// writes hs and hT once, 4 * (3 * B * T * L + 2 * B * L) bytes; the backward
// reads dA, hs, g, h0 and g_hT once and writes ddA, ddBx and dh0 once,
// 4 * (5 * B * T * L + 3 * B * L) bytes.  Each does one or three float
// operations per element read.  The design follows from that:
//   - one thread per (b, lane) keeps h (gh) in a register and loops over t;
//   - at each step a warp reads 32 neighbouring floats of each input and
//     writes 32 of each output, so every access is coalesced;
//   - the t loop is unrolled by UNROLL: the loads of the next UNROLL steps
//     do not depend on the carry, so they are in flight while the chain of
//     arithmetic runs;
//   - the grid is ceil(L / threads) x B blocks (2,048 at the serving shape
//     B = 4, L = 131,072; 1,024 at the training microbatch B = 2), enough
//     to fill the 132 SMs.
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

__global__ void ssm_scan_bwd_kernel(const float* __restrict__ dA,
                                    const float* __restrict__ hs,
                                    const float* __restrict__ h0,
                                    const float* __restrict__ g,
                                    const float* __restrict__ ghT,
                                    float* __restrict__ ddA,
                                    float* __restrict__ ddBx,
                                    float* __restrict__ dh0, int T,
                                    long long L) {
  const long long lane = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (lane >= L) return;
  const long long b = blockIdx.y;
  const long long base = b * T * L + lane;
  float gh = ghT[b * L + lane];
  int t = T - 1;
  // steps t .. t - UNROLL + 1, all with h_{t-1} in hs (t - UNROLL + 1 >= 1)
  for (; t >= UNROLL; t -= UNROLL) {
    float a[UNROLL], hp[UNROLL], x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(t - u) * L;
      a[u] = __ldg(dA + i);
      x[u] = __ldg(g + i);
      hp[u] = __ldg(hs + i - L);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)(t - u) * L;
      gh = __fadd_rn(gh, x[u]);
      ddA[i] = __fmul_rn(gh, hp[u]);
      ddBx[i] = gh;
      gh = __fmul_rn(a[u], gh);
    }
  }
  for (; t >= 0; --t) {
    const long long i = base + (long long)t * L;
    gh = __fadd_rn(gh, __ldg(g + i));
    const float h_prev = t > 0 ? __ldg(hs + i - L) : __ldg(h0 + b * L + lane);
    ddA[i] = __fmul_rn(gh, h_prev);
    ddBx[i] = gh;
    gh = __fmul_rn(__ldg(dA + i), gh);
  }
  dh0[b * L + lane] = gh;
}

}  // namespace

static int grid_for(long long B, long long L, int threads, dim3* grid) {
  if (B < 0 || L < 0 || threads < 32 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const long long blocks = (L + threads - 1) / threads;
  if (blocks > 0x7fffffffLL || B > 65535) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)blocks, (unsigned)B);
  return cudaSuccess;
}

// Launches one thread per (b, lane) on `stream`; allocates nothing and does
// not synchronise.  dA, dBx, hs: (B, T, L) float32; h0, hT: (B, L) float32;
// all contiguous.  Returns the CUDA error code of the launch (0 on
// success).
extern "C" int ssm_scan_fwd_launch(const void* dA, const void* dBx,
                                   const void* h0, void* hs, void* hT,
                                   long long B, int T, long long L,
                                   int threads, void* stream) {
  dim3 grid;
  if (T < 0) return cudaErrorInvalidValue;
  if (const int rc = grid_for(B, L, threads, &grid)) return rc;
  if (B == 0 || L == 0) return cudaSuccess;
  ssm_scan_fwd_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(dBx),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hT), T, L);
  return cudaGetLastError();
}

// The backward, launched like the forward.  dA, hs, g, ddA, ddBx:
// (B, T, L) float32; h0, ghT, dh0: (B, L) float32; all contiguous.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int ssm_scan_bwd_launch(const void* dA, const void* hs,
                                   const void* h0, const void* g,
                                   const void* ghT, void* ddA, void* ddBx,
                                   void* dh0, long long B, int T,
                                   long long L, int threads, void* stream) {
  dim3 grid;
  if (T < 0) return cudaErrorInvalidValue;
  if (const int rc = grid_for(B, L, threads, &grid)) return rc;
  if (B == 0 || L == 0) return cudaSuccess;
  ssm_scan_bwd_kernel<<<grid, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dA), static_cast<const float*>(hs),
      static_cast<const float*>(h0), static_cast<const float*>(g),
      static_cast<const float*>(ghT), static_cast<float*>(ddA),
      static_cast<float*>(ddBx), static_cast<float*>(dh0), T, L);
  return cudaGetLastError();
}
