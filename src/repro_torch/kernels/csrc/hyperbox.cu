// Box-LP support values for Hopper (sm_90a): one thread per output.
//
// Replaces the Pallas TPU kernel `_hyperbox_kernel` of
// src/repro/kernels/hyperbox_kernel.py (launched by `hyperbox_pallas`): the
// paper's Sec. 5.6 special case, max d.x over the box [lo, hi], in closed
// form
//
//     out = sum_i d_i * (d_i < 0 ? lo_i : hi_i).
//
// Two forms, as src/repro_torch/core/hyperbox.py `solve_hyperbox` takes
// them: one direction per box (lo, hi, d all (B, n) -> (B,)), or K
// directions shared by every box (d (K, n) -> (B, K)), where the output
// index selects the box and the direction row and no (B*K, n) copy is made.
//
// The sum runs in index order with one rounding per term (__fmaf_rn,
// -fmad=false), the order of the plain version (`hyperbox_tile_plain`), so
// the two agree bit for bit.
//
// What bounds it: bytes.  Each output reads its box's 2n bounds and its
// direction's n entries once and does n selects and n fused multiply-adds,
// far below the card's rate.  Consecutive threads take consecutive outputs,
// so in the per-box form a warp reads whole contiguous runs of rows, and in
// the shared form the threads of a warp share one box and the K direction
// rows stay in cache.

#include <cuda_runtime.h>

namespace {

__global__ void hyperbox_kernel(const float* __restrict__ lo,
                                const float* __restrict__ hi,
                                const float* __restrict__ d,
                                float* __restrict__ out, long long total,
                                int K, int n, int shared) {
  const long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (o >= total) return;
  const long long box = o / K;  // K = 1 in the per-box form
  const long long dir = shared ? o % K : box;
  const float* l = lo + box * n;
  const float* h = hi + box * n;
  const float* dd = d + dir * n;
  float acc = 0.f;
  for (int i = 0; i < n; ++i) {
    const float di = dd[i];
    acc = __fmaf_rn(di, di < 0.f ? l[i] : h[i], acc);
  }
  out[o] = acc;
}

}  // namespace

// Launches one thread per output on `stream`; allocates nothing and does
// not synchronise.  lo, hi: (B, n); d: (B, n) when shared == 0 (out (B,)),
// (K, n) when shared != 0 (out (B, K)).  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int hyperbox_launch(const void* lo, const void* hi, const void* d,
                               void* out, long long B, int K, int n,
                               int shared, int threads, void* stream) {
  if (n < 1 || K < 1 || (!shared && K != 1) || threads < 32 ||
      threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  const long long total = B * K;
  if (total <= 0) return cudaSuccess;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hyperbox_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const float*>(d), static_cast<float*>(out), total, K, n,
      shared);
  return cudaGetLastError();
}
