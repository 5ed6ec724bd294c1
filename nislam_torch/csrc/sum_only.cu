// Sum over the last two axes of float32 (..., H, W) arrays, for Hopper (sm_90a).
//
// For each of B arrays g[b] of shape (H, W), row-major and contiguous:
//   sum[b] = sum g
//
// Replaces the Pallas TPU kernel sum_only_pallas of scripts/pkbench.py (the
// "streaming only" control of that script's peak_stats A/B: the same row
// blocks read as the blocked peak_stats kernel, with none of its max/argmax
// work).  On the TPU it walked row blocks of 320 in a sequential grid and
// carried the running sum in SMEM scratch.  Blocks on Hopper run in parallel
// and in no order, so the carry becomes two passes:
//   pass 1, grid (S, B): each block sums a band of `rows` rows of one array
//     with 16-byte loads (when W % 4 == 0 and the base is 16-byte aligned)
//     and writes one partial;
//   pass 2, grid B, one warp each: adds the S partials in a fixed order.
// Bound: device-memory reads of 4*H*W bytes per array (7.68 MB at
// 1200x1600, 2.29 us at 3.35 TB/s); one add per element is far below the
// card's float32 rate.  No float atomics: every sum is taken in an order
// fixed by the launch shape, so the result is the same on every run.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

// Result valid in thread 0 only.
__device__ __forceinline__ float block_sum(float a) {
  __shared__ float sh[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_sum(a);
  if (lane == 0) sh[wid] = a;
  __syncthreads();
  if (wid == 0) a = warp_sum(lane < kThreads / 32 ? sh[lane] : 0.f);
  return a;
}

__global__ void __launch_bounds__(kThreads)
    sum_only_pass1(const float* __restrict__ g, int H, int W, int S, int rows, int vec,
                   float* __restrict__ part) {
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = band * rows;
  const int r1 = min(H, r0 + rows);
  const float* base = g + (static_cast<size_t>(b) * H + r0) * W;
  const int n = (r1 - r0) * W;
  float a = 0.f;
  if (vec) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
      const float4 v = __ldg(b4 + q);
      a += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) a += __ldg(base + e);
  }
  a = block_sum(a);
  if (threadIdx.x == 0) part[static_cast<size_t>(b) * S + band] = a;
}

__global__ void __launch_bounds__(32)
    sum_only_pass2(int S, const float* __restrict__ part, float* __restrict__ sum) {
  const int b = blockIdx.x;
  float a = 0.f;
  for (int k = threadIdx.x; k < S; k += 32) a += part[static_cast<size_t>(b) * S + k];
  a = warp_sum(a);
  if (threadIdx.x == 0) sum[b] = a;
}

}  // namespace

// B arrays of (H, W) at g; S bands of `rows` rows each (S * rows >= H,
// (S - 1) * rows < H).  part holds B * S floats.  Launches on `stream` and
// returns the cudaError_t of the launches (0 on success).
extern "C" int nislam_sum_only_f32(const void* g, int B, int H, int W, int S, int rows,
                                   void* part, void* sum, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || S <= 0 || rows <= 0 ||
      static_cast<long long>(S) * rows < H || static_cast<long long>(S - 1) * rows >= H ||
      static_cast<long long>(rows) * W > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(gp) % 16 == 0);
  sum_only_pass1<<<dim3(S, B), kThreads, 0, st>>>(gp, H, W, S, rows, vec,
                                                  static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_only_pass2<<<B, 32, 0, st>>>(S, static_cast<const float*>(part), static_cast<float*>(sum));
  return static_cast<int>(cudaGetLastError());
}
