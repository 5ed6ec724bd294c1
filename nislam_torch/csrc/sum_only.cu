// Sum over the last two axes of float32 (..., H, W) arrays, for Hopper (sm_90a).
//
// For each of B arrays g[b] of shape (H, W), row-major and contiguous:
//   sum[b] = sum g
//
// Replaces the Pallas TPU kernel sum_only_pallas of scripts/pkbench.py (the
// "streaming only" control of that script's peak_stats A/B: the same bytes
// read as the blocked peak_stats kernel, with none of its max/argmax
// work).  On the TPU it walked row blocks of 320 in a sequential grid and
// carried the running sum in SMEM scratch.  Blocks on Hopper run in parallel
// and in no order, so nothing carries from block to block.
//
// Bound: device-memory reads of 4*H*W bytes per array (7.68 MB at
// 1200x1600, 2.29 us at 3.35 TB/s); one add per element is far below the
// card's float32 rate.  At that size a launch costs as much as the
// streaming, so the design is peak_stats.cu's, with the max taken out:
//  - one launch: each block sums a contiguous range of the flat array and
//    writes one partial, then takes a ticket, an INTEGER atomic add on the
//    array's counter with release/acquire semantics at device scope; the
//    block that draws the last ticket adds all partials of its array in a
//    fixed order (lane k takes partials k, k+32, ..., eight loads in flight
//    at a time; then the warp shuffle), writes the sum and sets the counter
//    back to 0.  No float atomics: which block merges varies, what it
//    computes does not, so the result is the same on every run;
//  - the wrapper's persistent workspace (counters, then partials), zeroed
//    once when allocated; every kernel leaves its counters at 0 and
//    kernels on one stream run in order, so no launch needs a memset;
//  - ranges of whole tiles of 4 x 256 float4s: each thread starts four
//    independent 16-byte loads before it uses the first (when H*W % 4 == 0
//    and the base is 16-byte aligned; else the scalar path over the same
//    ranges).
//
// Also holds the empty kernel whose launches measure the card's launch
// floor (nislam_torch/utils/profiling.py): a bound of 0.2 us says little
// where no launch, however empty, takes less than a few microseconds.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 65536;  // ticket counters at the front of the workspace
constexpr int kMergeLoads = 8;    // partials a merging lane loads before it adds the first

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_down_sync(0xffffffffu, a, off);
  return a;
}

// One ticket of the counter at `counter`: an integer atomic add of 1 with
// release and acquire semantics at device scope (see peak_stats.cu).
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(1)
               : "memory");
  return old;
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

__device__ __forceinline__ float sum4(const float4 v) { return (v.x + v.y) + (v.z + v.w); }

// Grid (S, B).  Block (k, b) reads units [k*chunk, min(U, (k+1)*chunk)) of
// array b: float4s when vec (U = H*W/4), else floats (U = H*W).
// ws: kCounters ticket counters, then B*S partials.
__global__ void __launch_bounds__(kThreads)
    sum_only_kernel(const float* __restrict__ g, int n, int S, int chunk, int vec, int* ws,
                    float* __restrict__ sum) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const float* base = g + static_cast<size_t>(b) * n;
  const int U = vec ? n >> 2 : n;
  const int u0 = k * chunk;
  const int u1 = (U - u0 > chunk) ? u0 + chunk : U;
  float a = 0.f;
  int q = u0 + threadIdx.x;
  if (vec) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (; q < u1 - 3 * kThreads; q += 4 * kThreads) {
      const float4 v0 = __ldg(b4 + q);
      const float4 v1 = __ldg(b4 + q + kThreads);
      const float4 v2 = __ldg(b4 + q + 2 * kThreads);
      const float4 v3 = __ldg(b4 + q + 3 * kThreads);
      a += (sum4(v0) + sum4(v1)) + (sum4(v2) + sum4(v3));
    }
    for (; q < u1; q += kThreads) a += sum4(__ldg(b4 + q));
  } else {
    for (; q < u1 - 3 * kThreads; q += 4 * kThreads) {
      const float v0 = __ldg(base + q);
      const float v1 = __ldg(base + q + kThreads);
      const float v2 = __ldg(base + q + 2 * kThreads);
      const float v3 = __ldg(base + q + 3 * kThreads);
      a += (v0 + v1) + (v2 + v3);
    }
    for (; q < u1; q += kThreads) a += __ldg(base + q);
  }
  a = block_sum(a);

  // Publish the partial, then draw a ticket.
  float* part = reinterpret_cast<float*>(ws + kCounters) + static_cast<size_t>(b) * S;
  __shared__ int is_last;
  if (threadIdx.x == 0) {
    part[k] = a;
    is_last = take_ticket(ws + b) == S - 1;
  }
  __syncthreads();
  if (!is_last || threadIdx.x >= 32) return;

  // The last block of this array: every partial is visible.  A lane has
  // its loads of a round of kMergeLoads partials in flight together, then
  // adds them in the order j = lane, lane + 32, ...
  a = 0.f;
  for (int j0 = threadIdx.x; j0 < S; j0 += 32 * kMergeLoads) {
    float p[kMergeLoads];
#pragma unroll
    for (int t = 0; t < kMergeLoads; ++t) {
      const int j = j0 + 32 * t;
      p[t] = j < S ? __ldcg(part + j) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kMergeLoads; ++t) a += p[t];
  }
  a = warp_sum(a);
  if (threadIdx.x == 0) {
    ws[b] = 0;
    sum[b] = a;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// B arrays of (H, W) at g, S blocks per array of `chunk` units each
// (float4s if vec, else floats; S * chunk covers the array and
// (S - 1) * chunk does not).  ws: the zeroed workspace of ws_words 32-bit
// words, at least kCounters + B * S.  Launches on `stream` and returns the
// cudaError_t of the launch (0 on success).
extern "C" int nislam_sum_only_f32(const void* g, int B, int H, int W, int S, int chunk,
                                   int vec, void* ws, long long ws_words, void* sum,
                                   void* stream) {
  if (B <= 0 || B >= kCounters || H <= 0 || W <= 0 || S <= 0 || chunk <= 0 ||
      static_cast<long long>(H) * W > INT_MAX - 4 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(H) * W;
  const float* gp = static_cast<const float*>(g);
  if (vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(gp) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long U = vec ? n / 4 : n;
  if (static_cast<long long>(S) * chunk < U || static_cast<long long>(S - 1) * chunk >= U ||
      ws_words < kCounters + static_cast<long long>(B) * S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  sum_only_kernel<<<dim3(S, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, static_cast<int>(n), S, chunk, vec, static_cast<int*>(ws), static_cast<float*>(sum));
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing, on `stream`: the launch floor.
extern "C" int nislam_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
