// Fused correlation-response reduction with the registration epilogue, for
// Hopper (sm_90a).
//
// For each of B float32 responses g[b] of shape (H, W), row-major and
// contiguous, computes in one launch and one read of the data:
//   peak[b]  = max g
//   idx[b]   = row-major flat index of the FIRST maximum in COLUMN-MAJOR
//              order (Eigen maxCoeff parity: ties go to the smaller
//              col*H + row)
//   sum[b]   = sum g,  sumsq[b] = sum g*g
// and from them what a KCC registration wants of its response:
//   trans[b] = (-(row - H/2), -(col - W/2)) at idx (integer halves), as f32
//   psr[b]   = (peak - side) / (sqrt(max(var, 0)) + 1e-7) with
//              side = (sum - peak)/(n - 1),
//              var  = sumsq/n - 2*side*sum/n + side*side,  n = H*W.
//
// Replaces both Pallas TPU kernels of nislam_tpu/ops/pallas_kernels.py:
// _pallas_peak_stats_2d (one response held whole in VMEM, vmapped over the
// batch) and _pallas_peak_stats_blocked (a sequential (batch, row-block)
// grid for responses over 4 MB), and the scalar tail of estimate_trans
// (nislam_tpu/ops/registration.py) that XLA fused behind them.  The 4 MB
// split was a VMEM limit; here one kernel serves every size.
//
// Bound: device-memory reads of 4*H*W bytes per response (1.2 MB for a
// 480x640 tracking response, 7.7 MB at 1200x1600): 0.2 to 2.3 us at the
// card's 3.35 TB/s, which is below what any launch costs.  So the cost is
// launches and latency, and the design is about those:
//  - One SM's share of the memory rate is 3.35 TB/s / 132 = 25 KB/us, so a
//    tracking response needs ~100 SMs to stream in about a microsecond.
//    One response is therefore spread over the card, not kept inside one
//    thread-block cluster (at most 16 SMs), and the merge across blocks
//    goes through device memory.  Clusters and TMA would buy nothing for a
//    single pass with no reuse and are not used.
//  - One launch.  Each block reduces a contiguous range of the flat
//    response and writes one partial (max, col-major index, sum, sumsq),
//    then takes a ticket: an INTEGER atomic add on the response's counter
//    with release/acquire semantics at device scope.  The block that draws
//    the last ticket merges all partials of its response in a fixed order
//    (lane k takes partials k, k+32, ..., eight loads in flight at a time;
//    then the warp shuffle), writes the results and sets the counter back
//    to 0.  No float atomics: which block merges varies from run to run,
//    what it computes does not.  The merge is a chain of device-memory
//    round trips (store, ticket, loads), each about half a microsecond,
//    and it, not the streaming, is most of the kernel's time at the
//    tracking sizes: hence one 16-byte partial, one atomic that is its own
//    fence, and merge loads that do not wait for one another.
//  - A persistent workspace.  Counters and partials live in a buffer that
//    the wrapper keeps per (device, stream), zeroed once when allocated.
//    Every kernel leaves its counters at 0 and kernels on one stream run
//    in order, so no launch needs a memset or an allocation before it.
//    If a launch fails the wrapper drops the buffer.
//  - Loads that fill the threads.  A block's range is a whole number of
//    tiles of 4 x 256 float4s; each thread starts four independent 16-byte
//    loads before it uses the first.  Ranges ignore row boundaries: the
//    vector path needs only H*W % 4 == 0 and a 16-byte-aligned base, all
//    else takes the scalar path over the same ranges.
//  - A lazy tie-break.  A thread tracks the maximum and its ROW-major flat
//    index; the hot comparison is v > m.  Only on v == m does it derive the
//    two column-major indices and keep the smaller.  Each thread divides
//    by W once, at the end, to hand the block reduction a column-major
//    index; partials and the merge keep the lexicographic
//    (value, column-major index) rule, which is exact in any order.
//  - The epilogue in the merging warp's lane 0, in psr_from_stats's order
//    of operations (nislam_torch/ops/peak_stats.py) with round-to-nearest
//    intrinsics, which the compiler does not contract into FMAs: bit for
//    bit what IEEE f32 arithmetic gives on the same four statistics.
//  - A launch counter on the device.  Response 0's merging thread adds 1
//    to a 64-bit word per launch (one atomic per launch, off the merge's
//    path), which nislam_peak_stats_device_launches reads: the launches
//    that ran, inside CUDA graphs and their conditional bodies too, held
//    against those the wrapper counted.
// NaN inputs are not supported.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCounters = 65536;  // ticket counters at the front of the workspace
constexpr int kMergeLoads = 8;    // partials a merging lane loads before it merges the first

__device__ unsigned long long launch_count;  // launches run on this device

// In a thread's loop `i` is the row-major flat index of the maximum (-1:
// none yet); from the block reduction on it is the column-major index
// (INT_MAX: none).
struct Acc {
  float m;
  int i;
  float s;
  float ss;
};

__device__ __forceinline__ int col_major(int e, int H, int W) {
  const int r = e / W;
  return (e - r * W) * H + r;
}

__device__ __forceinline__ void take(Acc& a, float v, int e, int H, int W) {
  if (v > a.m) {
    a.m = v;
    a.i = e;
  } else if (v == a.m && (a.i < 0 || col_major(e, H, W) < col_major(a.i, H, W))) {
    a.i = e;
  }
  a.s += v;
  a.ss += v * v;
}

__device__ __forceinline__ void take4(Acc& a, const float4 v, int e, int H, int W) {
  take(a, v.x, e, H, W);
  take(a, v.y, e + 1, H, W);
  take(a, v.z, e + 2, H, W);
  take(a, v.w, e + 3, H, W);
}

__device__ __forceinline__ void merge(Acc& a, const Acc& o) {
  if (o.m > a.m || (o.m == a.m && o.i < a.i)) {
    a.m = o.m;
    a.i = o.i;
  }
  a.s += o.s;
  a.ss += o.ss;
}

__device__ __forceinline__ Acc warp_reduce(Acc a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o;
    o.m = __shfl_down_sync(0xffffffffu, a.m, off);
    o.i = __shfl_down_sync(0xffffffffu, a.i, off);
    o.s = __shfl_down_sync(0xffffffffu, a.s, off);
    o.ss = __shfl_down_sync(0xffffffffu, a.ss, off);
    merge(a, o);
  }
  return a;
}

// One ticket of the counter at `counter`: an integer atomic add of 1 with
// release and acquire semantics at device scope (what __threadfence()
// before and after an atomicAdd gives, in one instruction and without
// the fences' sequential consistency).  The release orders this thread's
// partial before the ticket; the acquire orders the last block's reads of
// all partials after it, for the whole block once it has passed
// __syncthreads().
__device__ __forceinline__ int take_ticket(int* counter) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(1)
               : "memory");
  return old;
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
    sh_i[wid] = a.i;
    sh_s[wid] = a.s;
    sh_ss[wid] = a.ss;
  }
  __syncthreads();
  if (wid == 0) {
    a = lane < kThreads / 32 ? Acc{sh_m[lane], sh_i[lane], sh_s[lane], sh_ss[lane]}
                             : Acc{-INFINITY, INT_MAX, 0.f, 0.f};
    a = warp_reduce(a);
  }
  return a;
}

// Grid (S, B).  Block (k, b) reads units [k*chunk, min(U, (k+1)*chunk)) of
// response b: float4s when vec (U = H*W/4), else floats (U = H*W).
// ws: kCounters ticket counters, then B*S partials of 16 bytes
// (max, column-major index, sum, sumsq).
// out: one record of 8 words per response: trans (2), psr, peak, idx,
// sum, sumsq, one unused.
__global__ void __launch_bounds__(kThreads)
    peak_stats_kernel(const float* __restrict__ g, int B, int H, int W, int S, int chunk,
                      int vec, int* ws, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int n = H * W;
  const float* base = g + static_cast<size_t>(b) * n;
  const int U = vec ? n >> 2 : n;
  const int u0 = k * chunk;
  const int u1 = (U - u0 > chunk) ? u0 + chunk : U;
  Acc a{-INFINITY, -1, 0.f, 0.f};
  int q = u0 + threadIdx.x;
  if (vec) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (; q < u1 - 3 * kThreads; q += 4 * kThreads) {
      const float4 v0 = __ldg(b4 + q);
      const float4 v1 = __ldg(b4 + q + kThreads);
      const float4 v2 = __ldg(b4 + q + 2 * kThreads);
      const float4 v3 = __ldg(b4 + q + 3 * kThreads);
      take4(a, v0, q << 2, H, W);
      take4(a, v1, (q + kThreads) << 2, H, W);
      take4(a, v2, (q + 2 * kThreads) << 2, H, W);
      take4(a, v3, (q + 3 * kThreads) << 2, H, W);
    }
    for (; q < u1; q += kThreads) take4(a, __ldg(b4 + q), q << 2, H, W);
  } else {
    for (; q < u1 - 3 * kThreads; q += 4 * kThreads) {
      const float v0 = __ldg(base + q);
      const float v1 = __ldg(base + q + kThreads);
      const float v2 = __ldg(base + q + 2 * kThreads);
      const float v3 = __ldg(base + q + 3 * kThreads);
      take(a, v0, q, H, W);
      take(a, v1, q + kThreads, H, W);
      take(a, v2, q + 2 * kThreads, H, W);
      take(a, v3, q + 3 * kThreads, H, W);
    }
    for (; q < u1; q += kThreads) take(a, __ldg(base + q), q, H, W);
  }
  a.i = a.i < 0 ? INT_MAX : col_major(a.i, H, W);
  a = block_reduce(a);

  // Publish the partial (one 16-byte store), then draw a ticket.
  float4* part = reinterpret_cast<float4*>(ws + kCounters) + static_cast<size_t>(b) * S;
  __shared__ int is_last;
  if (threadIdx.x == 0) {
    part[k] = make_float4(a.m, __int_as_float(a.i), a.s, a.ss);
    is_last = take_ticket(ws + b) == S - 1;
  }
  __syncthreads();
  if (!is_last || threadIdx.x >= 32) return;

  // The last block of this response: every partial is visible.  A lane
  // has its loads of a round of kMergeLoads partials in flight together,
  // then merges them in the order j = lane, lane + 32, ...
  a = Acc{-INFINITY, INT_MAX, 0.f, 0.f};
  for (int j0 = threadIdx.x; j0 < S; j0 += 32 * kMergeLoads) {
    float4 p[kMergeLoads];
#pragma unroll
    for (int t = 0; t < kMergeLoads; ++t) {
      const int j = j0 + 32 * t;
      p[t] = j < S ? __ldcg(part + j) : make_float4(-INFINITY, __int_as_float(INT_MAX), 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < kMergeLoads; ++t) merge(a, Acc{p[t].x, __float_as_int(p[t].y), p[t].z, p[t].w});
  }
  a = warp_reduce(a);
  if (threadIdx.x != 0) return;
  ws[b] = 0;
  if (b == 0) atomicAdd(&launch_count, 1ull);
  const int row = a.i % H;
  const int col = a.i / H;
  const float nf = __int2float_rn(n);
  const float side = __fdiv_rn(__fsub_rn(a.s, a.m), __int2float_rn(n - 1));
  const float cross = __fdiv_rn(__fmul_rn(__fmul_rn(2.f, side), a.s), nf);
  const float var = __fadd_rn(__fsub_rn(__fdiv_rn(a.ss, nf), cross), __fmul_rn(side, side));
  const float sd = __fsqrt_rn(fmaxf(var, 0.f));
  const float psr = __fdiv_rn(__fsub_rn(a.m, side), __fadd_rn(sd, 1e-7f));
  const float trans_row = -__fsub_rn(__int2float_rn(row), __int2float_rn(H / 2));
  const float trans_col = -__fsub_rn(__int2float_rn(col), __int2float_rn(W / 2));
  float4* rec = reinterpret_cast<float4*>(out) + 2 * b;
  rec[0] = make_float4(trans_row, trans_col, psr, a.m);
  rec[1] = make_float4(__int_as_float(row * W + col), a.s, a.ss, 0.f);
}

}  // namespace

// B responses of (H, W) at g, S blocks per response of `chunk` units each
// (float4s if vec, else floats; S * chunk covers the response and
// (S - 1) * chunk does not).  ws: the zeroed workspace of ws_words 32-bit
// words, at least kCounters + 4 * B * S.  out: 8 * B words, 16-byte aligned.
// Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
extern "C" int nislam_peak_stats_f32(const void* g, int B, int H, int W, int S, int chunk,
                                     int vec, void* ws, long long ws_words, void* out,
                                     void* stream) {
  if (B <= 0 || B >= kCounters || H <= 0 || W <= 0 || S <= 0 || chunk <= 0 ||
      static_cast<long long>(H) * W > INT_MAX - 4 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(H) * W;
  const float* gp = static_cast<const float*>(g);
  if ((vec && (n % 4 != 0 || reinterpret_cast<uintptr_t>(gp) % 16 != 0)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long U = vec ? n / 4 : n;
  if (static_cast<long long>(S) * chunk < U || static_cast<long long>(S - 1) * chunk >= U ||
      ws_words < kCounters + 4LL * B * S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  peak_stats_kernel<<<dim3(S, B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gp, B, H, W, S, chunk, vec, static_cast<int*>(ws), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The launches of the kernel that have run on the current device since
// the library was loaded -> *out.  Synchronous; returns a cudaError_t.
extern "C" int nislam_peak_stats_device_launches(unsigned long long* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(out, launch_count, sizeof(*out)));
}
