// Fused correlation-response reduction for Hopper (sm_90a).
//
// For each of B float32 responses g[b] of shape (H, W), row-major and
// contiguous, computes in one read of the data:
//   peak[b]  = max g
//   idx[b]   = row-major flat index of the FIRST maximum in COLUMN-MAJOR
//              order (Eigen maxCoeff parity: ties go to the smaller
//              col*H + row)
//   sum[b]   = sum g,  sumsq[b] = sum g*g
//
// Replaces both Pallas TPU kernels of nislam_tpu/ops/pallas_kernels.py:
// _pallas_peak_stats_2d (one response held whole in VMEM, vmapped over the
// batch) and _pallas_peak_stats_blocked (a sequential (batch, row-block)
// grid for responses over 4 MB).  The 4 MB split was a VMEM limit; here one
// kernel serves every size.
//
// Bound: device-memory reads of 4*H*W bytes per response (1.2 MB for a
// 480x640 tracking response, 7.7 MB at 1200x1600).  At the tracking sizes
// launch latency, not bandwidth, rules, so the design spreads one response
// over many SMs instead of streaming it through one:
//   pass 1, grid (S, B): each block reduces a band of `rows` rows of one
//     response with 16-byte loads (when W % 4 == 0 and the base is aligned)
//     and writes one partial (max, col-major index, sum, sumsq);
//   pass 2, grid B, one warp each: merges the S partials in a fixed order.
// Blocks on Hopper run in parallel and in no order, so nothing carries from
// block to block as it did across the TPU's sequential grid.  No float
// atomics are used: the lexicographic (value, index) combine is exact in any
// order, and every sum is taken in an order fixed by the launch shape, so
// results are identical from run to run.  NaN inputs are not supported.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Acc {
  float m;
  int icm;
  float s;
  float ss;
};

__device__ __forceinline__ Acc acc_init() { return Acc{-INFINITY, INT_MAX, 0.f, 0.f}; }

__device__ __forceinline__ void take(Acc& a, float v, int icm) {
  if (v > a.m || (v == a.m && icm < a.icm)) {
    a.m = v;
    a.icm = icm;
  }
  a.s += v;
  a.ss += v * v;
}

__device__ __forceinline__ void merge(Acc& a, const Acc& o) {
  if (o.m > a.m || (o.m == a.m && o.icm < a.icm)) {
    a.m = o.m;
    a.icm = o.icm;
  }
  a.s += o.s;
  a.ss += o.ss;
}

__device__ __forceinline__ Acc warp_reduce(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
    o.m = __shfl_down_sync(0xffffffffu, a.m, off);
    o.icm = __shfl_down_sync(0xffffffffu, a.icm, off);
    o.s = __shfl_down_sync(0xffffffffu, a.s, off);
    o.ss = __shfl_down_sync(0xffffffffu, a.ss, off);
    merge(a, o);
  }
  return a;
}

// Result valid in thread 0 only.
__device__ __forceinline__ Acc block_reduce(Acc a) {
  __shared__ float sh_m[kThreads / 32];
  __shared__ int sh_i[kThreads / 32];
  __shared__ float sh_s[kThreads / 32];
  __shared__ float sh_ss[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  a = warp_reduce(a);
  if (lane == 0) {
    sh_m[wid] = a.m;
    sh_i[wid] = a.icm;
    sh_s[wid] = a.s;
    sh_ss[wid] = a.ss;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < kThreads / 32 ? Acc{sh_m[lane], sh_i[lane], sh_s[lane], sh_ss[lane]} : acc_init();
    a = warp_reduce(a);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads)
    peak_stats_pass1(const float* __restrict__ g, int H, int W, int S, int rows, int vec,
                     float* __restrict__ part_m, int* __restrict__ part_i,
                     float* __restrict__ part_s, float* __restrict__ part_ss) {
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = band * rows;
  const int r1 = min(H, r0 + rows);
  const float* base = g + (static_cast<size_t>(b) * H + r0) * W;
  const int n = (r1 - r0) * W;
  Acc a = acc_init();
  if (vec) {
    // W % 4 == 0: the four values of a float4 share one row, in columns
    // c .. c+3, whose column-major indices step by H.
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int q = threadIdx.x; q < (n >> 2); q += kThreads) {
      const float4 v = __ldg(b4 + q);
      const int e = q << 2;
      const int icm = (e % W) * H + r0 + e / W;
      take(a, v.x, icm);
      take(a, v.y, icm + H);
      take(a, v.z, icm + 2 * H);
      take(a, v.w, icm + 3 * H);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) {
      take(a, __ldg(base + e), (e % W) * H + r0 + e / W);
    }
  }
  a = block_reduce(a);
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(b) * S + band;
    part_m[o] = a.m;
    part_i[o] = a.icm;
    part_s[o] = a.s;
    part_ss[o] = a.ss;
  }
}

__global__ void __launch_bounds__(32)
    peak_stats_pass2(int H, int W, int S, const float* __restrict__ part_m,
                     const int* __restrict__ part_i, const float* __restrict__ part_s,
                     const float* __restrict__ part_ss, float* __restrict__ peak,
                     int* __restrict__ idx, float* __restrict__ sum,
                     float* __restrict__ sumsq) {
  const int b = blockIdx.x;
  Acc a = acc_init();
  for (int k = threadIdx.x; k < S; k += 32) {
    const size_t o = static_cast<size_t>(b) * S + k;
    merge(a, Acc{part_m[o], part_i[o], part_s[o], part_ss[o]});
  }
  a = warp_reduce(a);
  if (threadIdx.x == 0) {
    peak[b] = a.m;
    idx[b] = (a.icm % H) * W + a.icm / H;
    sum[b] = a.s;
    sumsq[b] = a.ss;
  }
}

}  // namespace

// B responses of (H, W) at g; S bands of `rows` rows each (S * rows >= H,
// (S - 1) * rows < H).  part_f holds 3 * B * S floats (max, sum, sumsq
// partials) and part_i B * S ints.  Launches on `stream` and returns the
// cudaError_t of the launches (0 on success).
extern "C" int nislam_peak_stats_f32(const void* g, int B, int H, int W, int S, int rows,
                                     void* part_f, void* part_i, void* peak, void* idx,
                                     void* sum, void* sumsq, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || S <= 0 || rows <= 0 ||
      static_cast<long long>(S) * rows < H || static_cast<long long>(S - 1) * rows >= H ||
      static_cast<long long>(rows) * W > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  float* pf = static_cast<float*>(part_f);
  const size_t bs = static_cast<size_t>(B) * S;
  const int vec = (W % 4 == 0) && (reinterpret_cast<uintptr_t>(gp) % 16 == 0);
  peak_stats_pass1<<<dim3(S, B), kThreads, 0, st>>>(gp, H, W, S, rows, vec, pf,
                                                    static_cast<int*>(part_i), pf + bs,
                                                    pf + 2 * bs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  peak_stats_pass2<<<B, 32, 0, st>>>(H, W, S, pf, static_cast<const int*>(part_i), pf + bs,
                                     pf + 2 * bs, static_cast<float*>(peak),
                                     static_cast<int*>(idx), static_cast<float*>(sum),
                                     static_cast<float*>(sumsq));
  return static_cast<int>(cudaGetLastError());
}
