// Fixed-order scatter-add (index_add along rows), for Hopper (sm_90a).
//
// For out of shape (S, C) float32 and src of shape (N, C) float32, with
// keys (N,) int64, computes
//   out[keys[i], c] += src[i, c]    for i = 0 .. N-1, in order of i,
// each row starting from its existing value: the arithmetic of the CPU's
// index_add_ and index_put_(accumulate=True), which add one source row
// after another in index order.  The kernel takes a stable sort of the
// keys (sorted_keys, and order: sorted_keys = keys[order]) and its run
// table, run_end: at the first sorted position of each run of equal keys
// (its head) the end of the run, 0 at every other position.  A run's row
// is its head's key, its start the head's position, its length run_end
// minus the start.  The wrapper makes all three once per plan
// (nislam_torch/ops/scatter_add.py, ScatterPlan).
//
// No Pallas kernel is replaced: this is the counterpart of the scatter-adds
// that XLA lowers deterministically in the JAX package, the dense normal
// equations (nislam_tpu/core/pose_graph.py:157-170) and the GN-CG
// gradient, diagonal and Hessian-vector products
// (nislam_tpu/parallel/solver.py:52-68).  On the card, index_add_ sums
// repeated rows with float atomics in no fixed order, so a solve would
// change in its last bits from run to run.
//
// Design: a block takes 256 consecutive sorted positions, one thread
// each.  Every thread loads its position's place in the source, key and
// run end together, then its source row (every channel at once where the
// channel count is a template argument) into shared memory: two
// dependent loads, the least a gather through a permutation takes, and no
// thread reads a neighbour's key.  A head loads its output row beside its
// source row, adds the staged rows of its run in sorted order with
// __fadd_rn (no contraction into an FMA) and stores the row once.  Only
// the last run of a block can reach past its 256 positions: the block's
// first warp stages the next 32 positions with its own, as far as the
// next head (a ballot of their run ends), so a run that reaches less far
// costs nothing more.  A longer one's block stages the rest of it, 1024
// positions at a time, all their loads in flight, and the head goes on
// adding.  So only a run's adds form a chain: a run of L keys costs L
// dependent adds and about L/1024 rounds of two loads, not L/4 rounds of
// three as when one thread walked its run.  Every output row is written by one thread, with no
// atomics and no host synchronisation.  A row outside [0, S) is never
// written: its head stores 1 into the error word, a word of mapped pinned
// host memory that the wrapper reads without synchronising.
//
// Bound: the device-memory bytes that the function itself needs, whatever
// the design: the source (4*N*C) and the keys (8*N) read once, and every
// touched output row read and written (8*C per distinct key); one add per
// source value is far below the card's float32 rate.  (This kernel reads
// its plan instead of the keys, 24*N: order, sorted keys and run table.)
// At the pose-graph shapes that is well under a microsecond, below the
// launch floor: those launches are launch-bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTail = 32;                     // positions past the block staged with its own
constexpr int kPer = 4;                       // positions per thread in a later chunk
constexpr int kChunk = kPer * kThreads;

// C > 0: C channels, held in registers; C == 0: c channels, one at a time.
template <int C>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const long long* __restrict__ sorted_keys, const long long* __restrict__ run_end,
                       const long long* __restrict__ order, const float* __restrict__ src,
                       float* __restrict__ out, long long n, int c, long long s, volatile int* err) {
  constexpr int kRegs = C > 0 ? C : 1;
  __shared__ float stage[kChunk * kRegs];
  __shared__ long long reach;  // the end of the block's last run
  const int width = C > 0 ? C : c;
  const long long b0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long b1 = b0 + kThreads < n ? b0 + kThreads : n;
  const long long p = b0 + threadIdx.x;
  long long o = 0, end = 0, row = 0;
  if (p < n) {
    o = order[p];
    end = run_end[p];
    row = sorted_keys[p];
  }
  // Warp 0 also takes the first kTail positions past the block: those of
  // a last run that reaches past it, up to the next head.
  const long long q = b1 + threadIdx.x;
  long long oq = 0;
  bool tail = false;
  if (threadIdx.x < kTail) {
    long long e = 0;
    if (q < n) {
      oq = order[q];
      e = run_end[q];
    }
    const unsigned heads = __ballot_sync(0xffffffffu, q < n && e != 0);
    tail = q < n && (heads & ((1u << threadIdx.x) - 1u)) == 0 && e == 0;
  }
  if (threadIdx.x == 0) reach = b1 + kTail;
  __syncthreads();
  bool head = end != 0;
  if (head && end > b1 + kTail) reach = end;  // one head at most: the block's last
  if (head && (row < 0 || row >= s)) {
    *err = 1;
    head = false;
  }
  for (int c0 = 0; c0 < width; c0 += kRegs) {  // one pass when C > 0
    float acc[kRegs];
    if (head) {
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) acc[ch] = out[row * width + c0 + ch];
    }
    if (p < n) {
      float v[kRegs];
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) v[ch] = src[o * width + c0 + ch];
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) stage[threadIdx.x * kRegs + ch] = v[ch];
    }
    if (tail) {
      float v[kRegs];
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) v[ch] = src[oq * width + c0 + ch];
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) stage[(kThreads + threadIdx.x) * kRegs + ch] = v[ch];
    }
    __syncthreads();
    const long long hi = reach;
    if (head) {
      const long long b = (end < b1 + kTail ? end : b1 + kTail) - b0;
#pragma unroll 16
      for (long long k = p - b0; k < b; ++k) {
#pragma unroll
        for (int ch = 0; ch < kRegs; ++ch) acc[ch] = __fadd_rn(acc[ch], stage[k * kRegs + ch]);
      }
    }
    // The rest of the last run, when it reaches further.
    for (long long q0 = b1 + kTail; q0 < hi; q0 += kChunk) {
      const long long m = hi - q0 < kChunk ? hi - q0 : kChunk;
      long long oq[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int k = threadIdx.x + u * kThreads;
        oq[u] = k < m ? order[q0 + k] : 0;
      }
      float v[kPer][kRegs];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int k = threadIdx.x + u * kThreads;
#pragma unroll
        for (int ch = 0; ch < kRegs; ++ch) v[u][ch] = k < m ? src[oq[u] * width + c0 + ch] : 0.0f;
      }
      __syncthreads();  // the head has added what the stage held
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int k = threadIdx.x + u * kThreads;
        if (k < m) {
#pragma unroll
          for (int ch = 0; ch < kRegs; ++ch) stage[k * kRegs + ch] = v[u][ch];
        }
      }
      __syncthreads();
      if (head && end > q0) {
#pragma unroll 16
        for (long long k = 0; k < m; ++k) {
#pragma unroll
          for (int ch = 0; ch < kRegs; ++ch) acc[ch] = __fadd_rn(acc[ch], stage[k * kRegs + ch]);
        }
      }
    }
    if (head) {
#pragma unroll
      for (int ch = 0; ch < kRegs; ++ch) out[row * width + c0 + ch] = acc[ch];
    }
    __syncthreads();  // the stage is free for the next channel
  }
}

int* g_error_word = nullptr;    // host address
int* g_error_device = nullptr;  // its device address (the same under unified addressing)

}  // namespace

// The error word: one int of mapped, portable pinned host memory, zeroed,
// allocated at the first call.  Writes *word to its host address (with
// unified addressing, the same address on every device).  Returns the
// cudaError_t of the allocation (0 on success).
extern "C" int nislam_scatter_add_error_word(void** word) {
  if (g_error_word == nullptr) {
    void* p = nullptr;
    const cudaError_t e = cudaHostAlloc(&p, sizeof(int), cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return static_cast<int>(e);
    void* d = nullptr;
    const cudaError_t f = cudaHostGetDevicePointer(&d, p, 0);
    if (f != cudaSuccess) {
      cudaFreeHost(p);
      return static_cast<int>(f);
    }
    g_error_word = static_cast<int*>(p);
    g_error_device = static_cast<int*>(d);
    *g_error_word = 0;
  }
  *word = g_error_word;
  return 0;
}

// out (S, C) f32 += src (N, C) f32 at the rows sorted_keys (N,) i64, whose
// source rows are order (N,) i64, with the run table run_end (N,) i64, on
// `stream`.  Returns the cudaError_t of the launch (0 on success); N = 0
// launches nothing.
extern "C" int nislam_scatter_add_f32(const void* sorted_keys, const void* run_end, const void* order,
                                      const void* src, void* out, long long n, int c, long long s,
                                      void* stream) {
  if (n < 0 || c <= 0 || s <= 0 || g_error_device == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* rs = static_cast<const long long*>(sorted_keys);
  const auto* rr = static_cast<const long long*>(run_end);
  const auto* o = static_cast<const long long*>(order);
  const auto* x = static_cast<const float*>(src);
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (c) {  // the channel counts of the port's call sites, in registers
    case 1: scatter_add_kernel<1><<<grid, kThreads, 0, st>>>(rs, rr, o, x, y, n, c, s, g_error_device); break;
    case 3: scatter_add_kernel<3><<<grid, kThreads, 0, st>>>(rs, rr, o, x, y, n, c, s, g_error_device); break;
    case 9: scatter_add_kernel<9><<<grid, kThreads, 0, st>>>(rs, rr, o, x, y, n, c, s, g_error_device); break;
    default: scatter_add_kernel<0><<<grid, kThreads, 0, st>>>(rs, rr, o, x, y, n, c, s, g_error_device); break;
  }
  return static_cast<int>(cudaGetLastError());
}
