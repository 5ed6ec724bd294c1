// Fixed-order scatter-add (index_add along rows), for Hopper (sm_90a).
//
// For out of shape (S, C) float32 and src of shape (N, C) float32, with
// keys (N,) int64, computes
//   out[keys[i], c] += src[i, c]    for i = 0 .. N-1, in order of i,
// each row starting from its existing value: the arithmetic of the CPU's
// index_add_ and index_put_(accumulate=True), which add one source row
// after another in index order.  The kernel takes the keys stable-sorted
// (sorted_keys) together with the positions they came from (order), which
// the wrapper gets from torch.sort(keys, stable=True).
//
// No Pallas kernel is replaced: this is the counterpart of the scatter-adds
// that XLA lowers deterministically in the JAX package, the dense normal
// equations (nislam_tpu/core/pose_graph.py:157-170), the GN-CG gradient,
// diagonal and Hessian-vector products (nislam_tpu/parallel/solver.py:52-68)
// and the stitcher's canvas (nislam_tpu/core/stitcher.py:123-124).  On the
// card, index_add_ sums repeated rows with float atomics in no fixed
// order, so a solve or a canvas would change in its last bits from run to
// run.
//
// Design: one thread per sorted position.  The thread at the head of a run
// of equal keys (its left neighbour holds another key) owns that output
// row: it loads the row, adds the run's source rows in sorted order with
// __fadd_rn (no contraction into an FMA), and stores the row once.  Every
// output element is written by exactly one thread, with no atomics and no
// host synchronisation.  The head walks its run kBatch positions at a
// time: their keys load together, then their places in the source, then
// their source rows (every channel at once where the channel count is a
// template argument), so a run costs three memory latencies per kBatch
// positions, and only the adds form a chain.  A key outside [0, S) is
// never written: the head of its run stores 1 into the error word, a word
// of mapped pinned host memory that the wrapper reads without
// synchronising (nislam_torch/ops/scatter_add.py).
//
// Bound: device-memory bytes, each read once: the source (4*N*C), the
// sorted keys and the order (8*N each), and every touched output row read
// and written (8*C per distinct key); one add per source value is far
// below the card's float32 rate.  At the pose-graph shapes that is well
// under a microsecond, below the launch floor: those launches are
// launch-bound.  A long run is still summed by one thread, so callers
// spread entries that add exact zeros (masked edges and pixels) over
// distinct keys; a segmented reduction per warp is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;  // run positions whose loads are in flight together

// The run of `key` that starts at sorted position j, summed into its row.
// C > 0: C channels, held in registers; C == 0: c channels, one at a time.
template <int C>
__device__ void sum_run(const long long* __restrict__ keys, const long long* __restrict__ order,
                        const float* __restrict__ src, float* __restrict__ row, long long j, long long n,
                        int c, long long key) {
  constexpr int kRegs = C > 0 ? C : 1;
  const int width = C > 0 ? C : c;
  for (int c0 = 0; c0 < width; c0 += kRegs) {  // one pass when C > 0
    float acc[kRegs];
#pragma unroll
    for (int ch = 0; ch < kRegs; ++ch) acc[ch] = row[c0 + ch];
    for (long long i = j;; i += kBatch) {
      bool in[kBatch];
      long long o[kBatch];
      float v[kBatch][kRegs];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) in[u] = i + u < n && keys[i + u] == key;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) o[u] = in[u] ? order[i + u] : 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
#pragma unroll
        for (int ch = 0; ch < kRegs; ++ch) v[u][ch] = in[u] ? src[o[u] * width + c0 + ch] : 0.0f;
      }
      // The keys are sorted, so the run's positions are a prefix of the batch.
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (in[u]) {
#pragma unroll
          for (int ch = 0; ch < kRegs; ++ch) acc[ch] = __fadd_rn(acc[ch], v[u][ch]);
        }
      }
      if (!in[kBatch - 1]) break;
    }
#pragma unroll
    for (int ch = 0; ch < kRegs; ++ch) row[c0 + ch] = acc[ch];
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    scatter_add_kernel(const long long* __restrict__ keys, const long long* __restrict__ order,
                       const float* __restrict__ src, float* __restrict__ out, long long n, int c,
                       long long s, volatile int* err) {
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const long long key = keys[j];
  if (j > 0 && keys[j - 1] == key) return;  // not the head of its run
  if (key < 0 || key >= s) {
    *err = 1;
    return;
  }
  sum_run<C>(keys, order, src, out + key * c, j, n, c, key);
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
// source rows are order (N,) i64, on `stream`.  Returns the cudaError_t of
// the launch (0 on success); N = 0 launches nothing.
extern "C" int nislam_scatter_add_f32(const void* sorted_keys, const void* order, const void* src,
                                      void* out, long long n, int c, long long s, void* stream) {
  if (n < 0 || c <= 0 || s <= 0 || g_error_device == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto* k = static_cast<const long long*>(sorted_keys);
  const auto* o = static_cast<const long long*>(order);
  const auto* x = static_cast<const float*>(src);
  auto* y = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (c) {  // the channel counts of the port's call sites, in registers
    case 1: scatter_add_kernel<1><<<grid, kThreads, 0, st>>>(k, o, x, y, n, c, s, g_error_device); break;
    case 3: scatter_add_kernel<3><<<grid, kThreads, 0, st>>>(k, o, x, y, n, c, s, g_error_device); break;
    case 9: scatter_add_kernel<9><<<grid, kThreads, 0, st>>>(k, o, x, y, n, c, s, g_error_device); break;
    default: scatter_add_kernel<0><<<grid, kThreads, 0, st>>>(k, o, x, y, n, c, s, g_error_device); break;
  }
  return static_cast<int>(cudaGetLastError());
}
