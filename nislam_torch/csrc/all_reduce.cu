// A sum over the ranks of a group, in rank order, through peer memory, for Hopper (sm_90a).
//
// For n ranks, each holding x_r of `count` elements:
//   out[i] = ((x_0[i] + x_1[i]) + x_2[i]) + ... + x_{n-1}[i]
// on every rank, with the same bits everywhere: float32 summed in float32
// with adds only (__fadd_rn, no reassociation), int32 summed exactly
// (two's complement wrap).
//
// Replaces no Pallas kernel: it is the counterpart of XLA's all-reduce
// behind JAX's psum and the gathered reductions of the shard_maps
// (nislam_tpu/parallel/solver.py:106-154, nislam_tpu/parallel/loop_search.py:130),
// which run inside JAX's one compiled program at any device count.  A
// captured NCCL all-reduce holds event nodes at more than one rank, which
// a conditional graph body refuses, and its replay's bits may differ from
// the eager call's; this kernel is one plain kernel node, which a body
// holds, and gives the same bits eager and captured, on every rank.  It
// also runs for ranks that share one card (two processes, CUDA IPC on one
// device).
//
// Each rank owns a region (cudaMalloc, never PyTorch's caching allocator:
// only a whole allocation can be shared over IPC), mapped by every peer
// through its cudaIpcMemHandle:
//   [0, 8)        the epoch: the calls' rounds so far (this rank's own)
//   [8, 12)       a ticket counter: the last block of a launch advances the epoch
//   [16, 20)      the broken word: set once a wait of any rank ran out, never cleared
//   [64, ...)     one arrival word per block (kMaxBlocks), read by the peers
//   [kHeader, +2 slots)  two payload slots of slot_bytes each
//
// One call moves its payload in rounds of at most one slot.  Round e (the
// epoch, counted over every call of the group) in block b:
//   1. copy block b's elements of the round into this rank's slot e % 2;
//   2. release-store arrival[b] = e at system scope;
//   3. acquire-wait until every peer's arrival[b] >= e;
//   4. sum the peers' slots e % 2, in rank order, into out.
// Block b always takes the same elements of a round (a grid-stride loop
// over a grid that depends on the payload only, and every rank makes the
// same calls), so it reads, in every peer's slot, only what that peer's
// block b wrote.
//
// Why two slots and one barrier per round are enough: a rank writes slot
// e % 2 again at round e + 2 only.  Within one launch, its block b gets
// there after waiting at round e + 1 for every peer's block b to arrive
// at e + 1, which each did after it had finished round e, reading slot
// e % 2 included (the release orders its earlier loads too).  Across
// launches: a launch ends after every block waited at its last round E
// for every peer's same block, so every peer has finished round E - 1 in
// every block; the next launch's first round E + 1 writes slot (E + 1) % 2
// = (E - 1) % 2, which nobody reads any more, and its round E + 2 comes
// only after its wait at E + 1, which a peer passes only once its own
// previous launch (kernels on one stream run in order) has ended.
//
// The epoch lives on the device and the kernel advances it itself, so a
// node captured in a graph keeps its frozen arguments right across
// replays.  A wait has a clock bound (%globaltimer, `timeout_ns`, the
// group's timeout): when it runs out the block stops, sets the broken word
// in every rank's region and this rank's error word (mapped host memory,
// read by the host with no sync at the reads it makes anyway), and the
// launch ends.  The broken word is sticky: every later launch on every
// rank reads it at entry and returns at once (its payload left as it
// was), and a wait that sees it set stops.  So once a peer has stopped or
// diverged, a graph of many calls (the GN-CG trigger's WHILE loops, the
// chunk graph's branches) ends after one timeout, not one per call, and
// every rank's host raises at its next read.
//
// Bound: each rank reads its payload once and writes the result once, and
// the n - 1 peer slots cross the link: payload bytes x (n - 1) over NVLink
// (450 GB/s each way) across cards, or over HBM (3.35 TB/s) on one card;
// the payloads on the main path are a few KB (the CG vectors, the search
// record) to 32 MB (the canvas delta), so most calls are launch-bound.
// This first design is plain: scalar loads, the peer slots read with
// ld.global.cv (no stale L1 line across rounds).  At one rank the sum is
// the payload itself: the launch copies `in` to `out` where they differ
// and counts itself, with no slot, fence or epoch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 264;  // two per SM of the H100's 132
constexpr int kMaxRanks = 8;
constexpr long long kBroken = 16;
constexpr long long kArrival = 64;
constexpr long long kHeader = 4096;
// One rank's row of the handle exchange: the IPC handle, then its card's
// PCI bus id (a NUL-terminated string).
constexpr int kHandleBytes = 64;
constexpr int kBusIdBytes = 64;
constexpr int kRowBytes = kHandleBytes + kBusIdBytes;
enum DType { kFloat32 = 0, kInt32 = 1 };

static_assert(kBroken + 4 <= kArrival && kArrival + 8LL * kMaxBlocks <= kHeader, "the header's words overlap");

__device__ unsigned long long all_reduce_launches;

struct Args {
  const void* in;
  void* out;
  long long count;      // elements
  long long per_round;  // elements per round: a slot's
  int rounds;
  int rank;
  int size;
  unsigned long long timeout_ns;
  int* error;  // mapped host word
  char* base[kMaxRanks];  // every rank's region, as this process maps it
};

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long* arrival(char* base, int block) {
  return reinterpret_cast<unsigned long long*>(base + kArrival) + block;
}

__device__ __forceinline__ volatile unsigned* broken(char* base) {
  return reinterpret_cast<volatile unsigned*>(base + kBroken);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) all_reduce_kernel(Args a) {
  __shared__ int failed;
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (a.size == 1) {
    if (in != out) {
      for (long long i = first; i < a.count; i += stride) out[i] = in[i];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&all_reduce_launches, 1ull);
    return;
  }
  char* own = a.base[a.rank];
  auto* epoch = reinterpret_cast<volatile unsigned long long*>(own);
  auto* ticket = reinterpret_cast<unsigned*>(own + 8);
  // Read before this block takes its ticket; the last ticket writes it.
  const unsigned long long e0 = *epoch;
  // A broken group (a wait of this rank or of a peer ran out before): no round.
  if (threadIdx.x == 0) failed = *broken(own) != 0;
  const long long slot_bytes = a.per_round * static_cast<long long>(sizeof(T));
  __syncthreads();
  for (int r = 0; r < a.rounds && !failed; ++r) {
    const unsigned long long e = e0 + r + 1;
    const long long lo = r * a.per_round;
    const long long n = min(a.count - lo, a.per_round);
    const long long slot = kHeader + static_cast<long long>(e & 1ull) * slot_bytes;
    T* mine = reinterpret_cast<T*>(own + slot);
    for (long long i = first; i < n; i += stride) mine[i] = in[lo + i];
    // The block's copies, then one system-scope fence and release by one
    // thread (the barrier orders the others' stores before it).
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      store_release(arrival(own, blockIdx.x), e);
    }
    if (threadIdx.x < a.size && static_cast<int>(threadIdx.x) != a.rank) {
      const unsigned long long* word = arrival(a.base[threadIdx.x], blockIdx.x);
      const unsigned long long t0 = now_ns();
      while (load_acquire(word) < e) {
        if (*broken(own) != 0 || now_ns() - t0 > a.timeout_ns) {
          failed = 1;
          break;
        }
        __nanosleep(64);
      }
    }
    __syncthreads();
    if (failed) break;
    for (long long i = first; i < n; i += stride) {
      T acc = a.rank == 0 ? in[lo + i] : __ldcv(reinterpret_cast<const T*>(a.base[0] + slot) + i);
      for (int q = 1; q < a.size; ++q) {
        const T v = q == a.rank ? in[lo + i] : __ldcv(reinterpret_cast<const T*>(a.base[q] + slot) + i);
        acc = add(acc, v);
      }
      out[lo + i] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (failed) {
      // Every rank's later launches return at once; this rank's host raises.
      for (int q = 0; q < a.size; ++q) *broken(a.base[q]) = 1u;
      *reinterpret_cast<volatile int*>(a.error) = 1;
      __threadfence_system();
    }
    __threadfence();
    if (atomicAdd(ticket, 1u) == gridDim.x - 1) {
      *ticket = 0;
      *epoch = e0 + a.rounds;
      __threadfence();
      atomicAdd(&all_reduce_launches, 1ull);
    }
  }
}

struct Region {
  int device;
  int rank;
  int size;
  long long slot_bytes;
  char* base[kMaxRanks];
  bool opened[kMaxRanks];  // a peer's handle opened here (closed at destroy)
  int* error_host;
  int* error_dev;
};

}  // namespace

// This rank's region on the current device: the header zeroed, two slots
// of `slot_bytes`, and the mapped error word → *ctx; its exchange row
// (kRowBytes: the IPC handle, then the card's PCI bus id) into `row`.
extern "C" int nislam_ar_create(int rank, int size, long long slot_bytes, void** ctx, void* row) {
  if (ctx == nullptr || row == nullptr || size < 1 || size > kMaxRanks || rank < 0 || rank >= size ||
      slot_bytes < 16 || slot_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* g = new Region();
  g->rank = rank;
  g->size = size;
  g->slot_bytes = slot_bytes;
  cudaError_t err = cudaGetDevice(&g->device);
  char* own = nullptr;
  if (err == cudaSuccess) err = cudaMalloc(&own, kHeader + 2 * slot_bytes);
  if (err == cudaSuccess) g->base[rank] = own;
  if (err == cudaSuccess) err = cudaMemset(own, 0, kHeader + 2 * slot_bytes);
  if (err == cudaSuccess) err = cudaHostAlloc(&g->error_host, sizeof(int), cudaHostAllocMapped);
  if (err == cudaSuccess) {
    *g->error_host = 0;
    err = cudaHostGetDevicePointer(reinterpret_cast<void**>(&g->error_dev), g->error_host, 0);
  }
  std::memset(row, 0, kRowBytes);
  cudaIpcMemHandle_t h;
  if (err == cudaSuccess && size > 1) err = cudaIpcGetMemHandle(&h, own);
  if (err == cudaSuccess && size > 1) std::memcpy(row, &h, sizeof(h));
  if (err == cudaSuccess) err = cudaDeviceGetPCIBusId(static_cast<char*>(row) + kHandleBytes, kBusIdBytes - 1,
                                                      g->device);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    if (own != nullptr) cudaFree(own);
    if (g->error_host != nullptr) cudaFreeHost(g->error_host);
    delete g;
    return static_cast<int>(err);
  }
  *ctx = g;
  return 0;
}

// Open every peer's region from the group's exchange rows (`rows`: size x
// kRowBytes, in rank order).  A peer on another card needs peer access,
// which is enabled here; a peer on this card (another process) needs none.
// Any refusal is returned: the caller raises.
extern "C" int nislam_ar_open(void* ctx, const void* rows) {
  auto* g = static_cast<Region*>(ctx);
  if (g == nullptr || rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const char* r = static_cast<const char*>(rows);
  for (int q = 0; q < g->size; ++q) {
    if (q == g->rank) continue;
    const char* bus = r + q * kRowBytes + kHandleBytes;
    int peer_device = -1;
    if (cudaDeviceGetByPCIBusId(&peer_device, bus) != cudaSuccess) {
      cudaGetLastError();  // a card this process cannot see: the open decides
      peer_device = -1;
    }
    if (peer_device >= 0 && peer_device != g->device) {
      int can = 0;
      cudaError_t err = cudaDeviceCanAccessPeer(&can, g->device, peer_device);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
      err = cudaDeviceEnablePeerAccess(peer_device, 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
      } else if (err != cudaSuccess) {
        return static_cast<int>(err);
      }
    }
    cudaIpcMemHandle_t h;
    std::memcpy(&h, r + q * kRowBytes, sizeof(h));
    void* p = nullptr;
    const cudaError_t err = cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
    if (err != cudaSuccess) return static_cast<int>(err);
    g->base[q] = static_cast<char*>(p);
    g->opened[q] = true;
  }
  return 0;
}

// One all-reduce of `count` elements of `dtype` (DType) from `in` into
// `out` (the same pointer for in place) on `stream`; returns the launch's
// error.  Every rank of the group must make the same calls in the same
// order.
extern "C" int nislam_ar_launch(void* ctx, const void* in, void* out, long long count, int dtype,
                                unsigned long long timeout_ns, void* stream) {
  auto* g = static_cast<Region*>(ctx);
  if (g == nullptr || in == nullptr || out == nullptr || count < 1 || (dtype != kFloat32 && dtype != kInt32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < g->size; ++q) {
    if (g->base[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);  // not opened
  }
  Args a = {};
  a.in = in;
  a.out = out;
  a.count = count;
  a.per_round = g->slot_bytes / 4;  // both types are 4 bytes
  a.rounds = static_cast<int>((count + a.per_round - 1) / a.per_round);
  a.rank = g->rank;
  a.size = g->size;
  a.timeout_ns = timeout_ns;
  a.error = g->error_dev;
  for (int q = 0; q < g->size; ++q) a.base[q] = g->base[q];
  const long long per_block = std::min(count, a.per_round);
  // One rank in place: a launch that only counts itself.
  const int blocks = g->size == 1 && in == out
                         ? 1
                         : static_cast<int>(std::min<long long>(kMaxBlocks, (per_block + kThreads - 1) / kThreads));
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    all_reduce_kernel<float><<<blocks, kThreads, 0, s>>>(a);
  } else {
    all_reduce_kernel<int><<<blocks, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The error word: 0, or 1 once a wait ran past its bound or a launch
// found the group broken.  A host read of mapped memory, no sync: it
// shows what launches that have ended set.
extern "C" int nislam_ar_error(void* ctx) {
  auto* g = static_cast<Region*>(ctx);
  return g == nullptr ? -1 : *static_cast<volatile int*>(g->error_host);
}

// The kernel's launches that have run on this device (those inside graphs
// included).
extern "C" int nislam_ar_device_launches(unsigned long long* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(out, all_reduce_launches, sizeof(*out)));
}

// The exchange row's size and the most ranks a group holds.
extern "C" int nislam_ar_row_bytes() { return kRowBytes; }
extern "C" int nislam_ar_max_ranks() { return kMaxRanks; }

// Close the peers' regions and free this rank's.
extern "C" int nislam_ar_destroy(void* ctx) {
  auto* g = static_cast<Region*>(ctx);
  if (g == nullptr) return 0;
  cudaError_t first = cudaSuccess;
  for (int q = 0; q < g->size; ++q) {
    if (g->opened[q]) {
      const cudaError_t err = cudaIpcCloseMemHandle(g->base[q]);
      if (first == cudaSuccess) first = err;
    }
  }
  if (g->base[g->rank] != nullptr) {
    const cudaError_t err = cudaFree(g->base[g->rank]);
    if (first == cudaSuccess) first = err;
  }
  if (g->error_host != nullptr) cudaFreeHost(g->error_host);
  delete g;
  return static_cast<int>(first);
}
