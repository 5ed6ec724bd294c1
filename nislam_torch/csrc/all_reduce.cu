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
// device).  At one rank the sum is the payload: the host launches nothing,
// as XLA launches nothing for a psum over one device.
//
// Each rank owns a region (cudaMalloc, never PyTorch's caching allocator:
// only a whole allocation can be shared over IPC), mapped by every peer
// through its cudaIpcMemHandle.  Peers write into it; its owner reads it
// from its own memory:
//   [0, 4)             the broken word: set once a wait of any rank ran out, never cleared
//   [kEpochs, ...)     one epoch per protocol and block: that block's rounds so far (this rank's own)
//   [kRsFlags, ...)    flags[sender][block]: the reduce-scatter's arrivals, written by the senders
//   [kAgFlags, ...)    flags[owner][block]: the all-gather's arrivals, written by the owners
//   [kHeader, ...)     the one-shot inbox: [parity][sender][ll_row] 8-byte words
//   then               the two-shot inbox: [parity][sender][rs_row] elements
//   then               the two-shot gather slots: [parity][slot] elements
//
// The host's plan (ops/all_reduce.py::launch_plan, checked here) picks the
// protocol by payload size, the grid and each owner's range: the one shot
// up to 256 KB across cards (on four H100s it is ahead of the two shot up
// to there and behind from 512 KB, scripts/captureprobe.py --crossover),
// up to the inbox's 2 MB for ranks that share one card, where every wait
// is a time slice of the other process's and the one shot waits once
// where the two shot waits twice.  Round e of a block is its epoch plus
// one; parity p = e % 2.
//
// One shot (small payloads: the CG vectors, gradient blocks, costs, search
// records).  Block b takes elements [b*E, (b+1)*E) and owns the fixed
// window [b*W, b*W + E) of every inbox row (E <= W).  Each thread stores
// its pairs of elements into every peer's inbox row `rank` (parity p) as
// two 8-byte words, each word 4 bytes of data and 4 bytes of the round's
// flag (1 + e mod (2^32 - 1), never 0 and never the flag of round e - 2),
// the pair in one 16-byte store (st.volatile.v2.u64): each 8-byte word is
// one scalar access of the memory model and arrives whole, and both words'
// flags are checked, so nothing relies on the 16 bytes arriving together
// (NCCL's LL protocol).  It then polls its own inbox's words, in its own
// memory, until every peer's word carries the flag, and sums in rank
// order.  No fence, no separate arrival word, no barrier: a word's flag is
// its data's arrival.  A launch is one round of each block.
//
// Two shot (large payloads: the image bits, the canvas delta), in rounds of
// one slot.  The round's elements are cut into n owner ranges (aligned to
// 4 elements, but for the tail); block b takes the piece [b*E, (b+1)*E) of
// each range.
//   1. reduce-scatter: for each owner j != rank, from the next rank's on
//      (so that no owner takes every sender's stores at once), block b
//      stores its piece of range j (16-byte stores, several loads in
//      flight) into owner j's inbox row `rank`; then one thread makes one
//      system fence and sets flags[rank][b] = e in each owner's region
//      (one release per block);
//   2. block b of owner j waits for its own flags[q][b] >= e (a poll of its
//      own memory), sums its piece of range j in rank order (its own input
//      for q = rank, its inbox rows for the others), writes it to out and
//      stores it into every peer's gather slot p; one fence, then
//      flags[j][b] = e in every peer's region;
//   3. block b waits for its own all-gather flags from every owner and
//      copies the other owners' pieces from its gather slot into out.
// Every element is summed once, by its owner, in rank order, so every rank
// holds the same bits.  Flags are written at every round of a block, its
// pieces empty or not.
//
// Why two parities suffice.  Every wait is block b's and every location of
// an inbox or slot is written and read by block b only (block b owns its
// window, its pieces are fixed by the plan, which every rank computes
// alike, and every rank makes the same calls in the same order), so the
// argument is per block.  A rank writes a location of parity p into a
// peer's memory at round e, and again at round e + 2 only.
//   One shot: a sender's thread reaches round e + 2 only after its round
//   e + 1 wait, which received a word of round e + 1 from every peer's
//   same block.  A peer's block stores round e + 1 only after it ended
//   round e: in an earlier launch (kernels on one stream end in order; the
//   loads of round e returned before the launch ended) or after the
//   barrier that ends round e in a launch.  So every peer has read, at
//   round e, what the sender now overwrites, and a word of round e - 2 left
//   in place never carries round e's flag.
//   Two shot: a sender writes owner j's inbox (parity p) again at round
//   e + 2 only after its round e + 1 all-gather wait saw flags[j][b] >= e + 1,
//   which owner j set after it had summed round e + 1, so after its round e
//   sum had read that inbox (a barrier between).  An owner writes a peer's
//   gather slot p again at round e + 2 only after its round e + 2
//   reduce-scatter wait saw that peer's flag, set after the peer copied its
//   round e slot out (a barrier between).  Flags only grow, so a wait for
//   >= e never passes on an older round.
//   Across launches the same holds: a block's epoch lives on the device,
//   advanced by the block itself at its end (no ticket, no grid-wide
//   atomic), and the next launch of that block continues from it.  A node
//   captured in a graph keeps its frozen arguments right across replays.
//
// A wait has a clock bound (%globaltimer, `timeout_ns`, the group's
// timeout): when it runs out the block stops, sets the broken word in every
// rank's region and this rank's error word (mapped host memory, read by
// the host with no sync at the reads it makes anyway), and the launch
// ends.  The broken word is sticky: every later launch on every rank reads
// it at entry and returns at once (its payload left as it was), and a wait
// that sees it set stops.  So once a peer has stopped or diverged, a graph
// of many calls (the GN-CG trigger's WHILE loops, the chunk graph's
// branches) ends after one timeout, not one per call, and every rank's host
// raises at its next read.
//
// Bound.  Across cards the least any all-reduce moves is 2 (n - 1) / n
// payload bytes per rank each way over NVLink (450 GB/s each way): the two
// shot's traffic.  The one shot sends (n - 1) x 2 x payload bytes (a flag
// beside every element), more bytes for one step and no second latency,
// which wins below a crossover the host's plan sets.  Ranks that share one
// card move their traffic over HBM (3.35 TB/s): (n + 1) x payload bytes,
// each payload read once and each sum written once.  Small calls are
// bound by latency: a launch, one flag's trip over NVLink (one shot) or
// two (two shot).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocks = 132;     // two shot: one per SM of the H100, all resident at once
constexpr int kOneShotBlocks = 64;  // one shot: each owns a fixed window of every inbox row
constexpr int kMaxRanks = 8;
constexpr int kUnroll = 4;  // two shot: 16-byte loads in flight per thread in a copy
constexpr long long kBroken = 0;
constexpr long long kEpochs = 128;
constexpr long long kRsFlags = kEpochs + 2LL * 8 * kMaxBlocks;
constexpr long long kAgFlags = kRsFlags + 8LL * kMaxRanks * kMaxBlocks;
constexpr long long kHeader = 65536;
// The plan: protocol, blocks, elements per block piece, elements per round,
// rounds, count; then the owners' bounds of a full round and of the last
// (kMaxRanks + 1 each, zero past size + 1).
constexpr int kPlanHead = 6;
constexpr int kPlanWords = kPlanHead + 2 * (kMaxRanks + 1);
// One rank's row of the handle exchange: the IPC handle, then its card's
// PCI bus id (a NUL-terminated string).
constexpr int kHandleBytes = 64;
constexpr int kBusIdBytes = 64;
constexpr int kRowBytes = kHandleBytes + kBusIdBytes;
enum DType { kFloat32 = 0, kInt32 = 1 };
enum Protocol { kNone = 0, kOneShot = 1, kTwoShot = 2 };

static_assert(kAgFlags + 8LL * kMaxRanks * kMaxBlocks <= kHeader, "the header's words overlap");

__device__ unsigned long long all_reduce_launches;

struct Args {
  const void* in;
  void* out;
  long long count;  // elements
  int protocol;
  int rounds;
  long long block_elems;  // E: one shot, a block's elements; two shot, a block's piece of each range
  long long per_round;    // two shot: elements of a full round
  long long full[kMaxRanks + 1];  // owners' bounds in a full round
  long long last[kMaxRanks + 1];  // and in the last
  int rank;
  int size;
  int vec;  // in and out are 16-byte aligned
  unsigned long long timeout_ns;
  int* error;  // mapped host word
  long long ll_window;  // one shot: a block's window in a row (elements)
  long long ll_row;     // one shot: a row's 8-byte words
  long long ll_off;     // byte offsets of the areas in a region
  long long rs_row;     // two shot: an inbox row's elements
  long long rs_off;
  long long slot;  // two shot: a gather slot's elements
  long long ag_off;
  char* base[kMaxRanks];  // every rank's region, as this process maps it
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Two 8-byte {data, flag} words in one store, and in one load.
__device__ __forceinline__ void store_pair(unsigned long long* p, unsigned long long w0, unsigned long long w1) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(w0), "l"(w1) : "memory");
}

__device__ __forceinline__ void load_pair(const unsigned long long* p, unsigned long long& w0,
                                          unsigned long long& w1) {
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(w0), "=l"(w1) : "l"(p) : "memory");
}

__device__ __forceinline__ volatile unsigned* broken(char* base) {
  return reinterpret_cast<volatile unsigned*>(base + kBroken);
}

__device__ __forceinline__ unsigned long long* flag_word(char* base, long long area, int rank, int block) {
  return reinterpret_cast<unsigned long long*>(base + area) + rank * kMaxBlocks + block;
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ unsigned to_bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ unsigned to_bits(int v) { return static_cast<unsigned>(v); }
template <typename T>
__device__ __forceinline__ T from_bits(unsigned b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}
template <>
__device__ __forceinline__ int from_bits<int>(unsigned b) {
  return static_cast<int>(b);
}

template <typename T>
__device__ __forceinline__ unsigned add_bits(unsigned a, unsigned b) {
  return to_bits(add(from_bits<T>(a), from_bits<T>(b)));
}

template <typename T>
__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(add_bits<T>(a.x, b.x), add_bits<T>(a.y, b.y), add_bits<T>(a.z, b.z), add_bits<T>(a.w, b.w));
}

// Whether this block may go on: false once a wait of this block ran out
// (`failed`) or the group is broken.  Checked between spins.
__device__ __forceinline__ bool give_up(const Args& a, volatile int* failed, unsigned long long& t0) {
  if (*failed || *broken(a.base[a.rank]) != 0) return true;
  const unsigned long long t = now_ns();
  if (t0 == 0) {
    t0 = t;
  } else if (t - t0 > a.timeout_ns) {
    return true;
  }
  return false;
}

// ---------------------------------------------------------------------------
// One shot
// ---------------------------------------------------------------------------

// Inbox row `sender` of parity p in `base`, at this block's window.
__device__ __forceinline__ unsigned long long* ll_row(const Args& a, char* base, int p, int sender) {
  return reinterpret_cast<unsigned long long*>(base + a.ll_off) + (static_cast<long long>(p) * a.size + sender) * a.ll_row +
         static_cast<long long>(blockIdx.x) * a.ll_window;
}

template <typename T>
__device__ void one_shot(const Args& a, volatile int* failed, unsigned long long e) {
  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  const long long lo = static_cast<long long>(blockIdx.x) * a.block_elems;
  const long long n = min(a.count - lo, a.block_elems);
  const int p = static_cast<int>(e & 1ull);
  const unsigned long long flag = (1ull + e % 0xffffffffull) << 32;
  const unsigned long long high = 0xffffffff00000000ull;
  for (long long k = 2LL * threadIdx.x; k < n; k += 2LL * blockDim.x) {
    const unsigned long long w0 = flag | to_bits(in[lo + k]);
    const unsigned long long w1 = flag | (k + 1 < n ? to_bits(in[lo + k + 1]) : 0u);
    for (int q = 0; q < a.size; ++q) {
      if (q != a.rank) store_pair(ll_row(a, a.base[q], p, a.rank) + k, w0, w1);
    }
  }
  for (long long k = 2LL * threadIdx.x; k < n; k += 2LL * blockDim.x) {
    T acc0 = T(0), acc1 = T(0);
    for (int q = 0; q < a.size; ++q) {
      T v0, v1;
      if (q == a.rank) {
        v0 = in[lo + k];
        v1 = k + 1 < n ? in[lo + k + 1] : T(0);
      } else {
        const unsigned long long* w = ll_row(a, a.base[a.rank], p, q) + k;
        unsigned long long w0, w1, t0 = 0;
        for (unsigned spins = 1;; ++spins) {
          load_pair(w, w0, w1);
          if ((w0 & high) == flag && (w1 & high) == flag) break;
          if ((spins & 255u) == 0 && give_up(a, failed, t0)) {
            *failed = 1;
            return;
          }
        }
        v0 = from_bits<T>(static_cast<unsigned>(w0));
        v1 = from_bits<T>(static_cast<unsigned>(w1));
      }
      acc0 = q == 0 ? v0 : add(acc0, v0);
      acc1 = q == 0 ? v1 : add(acc1, v1);
    }
    out[lo + k] = acc0;
    if (k + 1 < n) out[lo + k + 1] = acc1;
  }
}

// ---------------------------------------------------------------------------
// Two shot
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned* rs_row(const Args& a, char* base, int p, int sender) {
  return reinterpret_cast<unsigned*>(base + a.rs_off) + (static_cast<long long>(p) * a.size + sender) * a.rs_row;
}

__device__ __forceinline__ unsigned* ag_slot(const Args& a, char* base, int p) {
  return reinterpret_cast<unsigned*>(base + a.ag_off) + static_cast<long long>(p) * a.slot;
}

// Block b's piece [s0, s1) of owner j's range (round positions).
__device__ __forceinline__ void piece(const Args& a, const long long* bounds, int j, long long& s0, long long& s1) {
  s0 = min(bounds[j] + static_cast<long long>(blockIdx.x) * a.block_elems, bounds[j + 1]);
  s1 = min(s0 + a.block_elems, bounds[j + 1]);
}

// n 4-byte words from src to dst by the block: 16 bytes a thread where
// both are aligned (`vec`), kUnroll loads in flight before their stores
// (a copy's rate is its loads in flight), then the tail one by one.
// `cached`: src is this process's input; else it is peer-written memory,
// read past L1.
__device__ __forceinline__ void copy_words(unsigned* dst, const unsigned* src, long long n, bool vec, bool cached) {
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    const long long step = blockDim.x;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long v = threadIdx.x; v < n4; v += kUnroll * step) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v + u * step < n4) r[u] = cached ? s[v + u * step] : __ldcg(s + v + u * step);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (v + u * step < n4) d[v + u * step] = r[u];
      }
    }
    done = 4 * n4;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = cached ? src[i] : __ldcg(src + i);
}

// Raise flags[rank][b] = e in every peer's `area`, after the block's
// stores: one barrier, one system fence, one store per peer.
__device__ __forceinline__ void signal(const Args& a, long long area, unsigned long long e) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    for (int q = 0; q < a.size; ++q) {
      if (q != a.rank) store_relaxed(flag_word(a.base[q], area, a.rank, blockIdx.x), e);
    }
  }
}

// Wait until every peer's flags[q][b] >= e in this rank's own `area`
// (thread q polls peer q's word) → whether the block may go on.
__device__ __forceinline__ bool wait_flags(const Args& a, long long area, unsigned long long e, volatile int* failed) {
  const int q = threadIdx.x;
  if (q < a.size && q != a.rank) {
    const unsigned long long* w = flag_word(a.base[a.rank], area, q, blockIdx.x);
    unsigned long long t0 = 0;
    for (unsigned spins = 1; load_acquire(w) < e; ++spins) {
      if ((spins & 63u) == 0 && give_up(a, failed, t0)) {
        *failed = 1;
        break;
      }
    }
  }
  __syncthreads();
  return *failed == 0;
}

// Owner `rank`'s piece [s0, s1) of the round at `lo`, summed in rank order
// (its own input for q = rank, inbox row q for the others) → out and every
// peer's gather slot p.
template <typename T>
__device__ void sum_piece(const Args& a, int p, long long lo, long long s0, long long s1, long long first) {
  const unsigned* in = static_cast<const unsigned*>(a.in) + lo;
  unsigned* out = static_cast<unsigned*>(a.out) + lo;
  char* own = a.base[a.rank];
  long long s = s0;
  if (a.vec) {
    for (long long v = s0 + 4LL * threadIdx.x; v + 4 <= s1; v += 4LL * blockDim.x) {
      uint4 acc = make_uint4(0, 0, 0, 0);
      for (int q = 0; q < a.size; ++q) {
        const uint4 x = q == a.rank ? *reinterpret_cast<const uint4*>(in + v)
                                    : __ldcg(reinterpret_cast<const uint4*>(rs_row(a, own, p, q) + (v - first)));
        acc = q == 0 ? x : add4<T>(acc, x);
      }
      *reinterpret_cast<uint4*>(out + v) = acc;
      for (int k = 1; k < a.size; ++k) {
        *reinterpret_cast<uint4*>(ag_slot(a, a.base[(a.rank + k) % a.size], p) + v) = acc;
      }
    }
    s = s0 + (s1 - s0) / 4 * 4;
  }
  for (long long i = s + threadIdx.x; i < s1; i += blockDim.x) {
    unsigned acc = 0;
    for (int q = 0; q < a.size; ++q) {
      const unsigned x = q == a.rank ? in[i] : __ldcg(rs_row(a, own, p, q) + (i - first));
      acc = q == 0 ? x : add_bits<T>(acc, x);
    }
    out[i] = acc;
    for (int q = 0; q < a.size; ++q) {
      if (q != a.rank) ag_slot(a, a.base[q], p)[i] = acc;
    }
  }
}

template <typename T>
__device__ void two_shot(const Args& a, volatile int* failed, unsigned long long e0) {
  const unsigned* in = static_cast<const unsigned*>(a.in);
  unsigned* out = static_cast<unsigned*>(a.out);
  char* own = a.base[a.rank];
  const bool vec = a.vec != 0;
  for (int r = 0; r < a.rounds; ++r) {
    const unsigned long long e = e0 + r + 1;
    const int p = static_cast<int>(e & 1ull);
    const long long lo = static_cast<long long>(r) * a.per_round;
    const long long* bounds = r == a.rounds - 1 ? a.last : a.full;
    long long s0, s1;
    // 1. My pieces of the other owners' ranges → their inboxes, starting
    // at the next rank's, so that no owner takes every sender's stores at once.
    for (int k = 1; k < a.size; ++k) {
      const int j = (a.rank + k) % a.size;
      piece(a, bounds, j, s0, s1);
      copy_words(rs_row(a, a.base[j], p, a.rank) + (s0 - bounds[j]), in + lo + s0, s1 - s0, vec, true);
    }
    signal(a, kRsFlags, e);
    if (!wait_flags(a, kRsFlags, e, failed)) return;
    // 2. My range's piece, summed in rank order → out and every peer.
    piece(a, bounds, a.rank, s0, s1);
    sum_piece<T>(a, p, lo, s0, s1, bounds[a.rank]);
    signal(a, kAgFlags, e);
    if (!wait_flags(a, kAgFlags, e, failed)) return;
    // 3. The other owners' sums → out.
    for (int j = 0; j < a.size; ++j) {
      if (j == a.rank) continue;
      piece(a, bounds, j, s0, s1);
      copy_words(out + lo + s0, ag_slot(a, own, p) + s0, s1 - s0, vec, false);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) all_reduce_kernel(Args a) {
  __shared__ int failed;
  __shared__ unsigned long long e0;
  char* own = a.base[a.rank];
  auto* epoch = reinterpret_cast<volatile unsigned long long*>(own + kEpochs) +
                (a.protocol == kOneShot ? 0 : kMaxBlocks) + blockIdx.x;
  if (threadIdx.x == 0) {
    // A broken group (a wait of this rank or of a peer ran out before): no round.
    failed = *broken(own) != 0;
    e0 = *epoch;
  }
  __syncthreads();
  if (!failed) {
    if (a.protocol == kOneShot) {
      one_shot<T>(a, &failed, e0 + 1);
    } else {
      two_shot<T>(a, &failed, e0);
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
    *epoch = e0 + (a.protocol == kOneShot ? 1 : a.rounds);
    if (blockIdx.x == 0) atomicAdd(&all_reduce_launches, 1ull);
  }
}

struct Region {
  int device;
  int rank;
  int size;
  long long ll_window;
  long long ll_row;
  long long ll_off;
  long long rs_row;
  long long rs_off;
  long long slot;
  long long ag_off;
  long long bytes;
  char* base[kMaxRanks];
  bool opened[kMaxRanks];  // a peer's handle opened here (closed at destroy)
  int* error_host;
  int* error_dev;
};

// Whether `bounds` (size + 1 entries) cut `len` elements into owner ranges
// that start on 4 elements, each at most `row` long.
bool valid_bounds(const long long* bounds, int size, long long len, long long row) {
  if (bounds[0] != 0 || bounds[size] != len) return false;
  for (int j = 0; j < size; ++j) {
    if (bounds[j + 1] < bounds[j] || bounds[j + 1] - bounds[j] > row) return false;
    if (bounds[j] % 4 != 0 && bounds[j] != len) return false;
  }
  return true;
}

// Whether the host's plan fits this region and covers `count` elements.
bool valid_plan(const Region& g, const Args& a, int blocks) {
  if (a.block_elems < 1 || blocks < 1) return false;
  if (a.protocol == kOneShot) {
    return a.rounds == 1 && blocks <= kOneShotBlocks && a.block_elems % 2 == 0 && a.block_elems <= g.ll_window &&
           static_cast<long long>(blocks) * a.block_elems >= a.count &&
           static_cast<long long>(blocks - 1) * a.block_elems < a.count;
  }
  if (a.protocol != kTwoShot || blocks > kMaxBlocks || a.block_elems % 4 != 0 || a.per_round % 4 != 0 ||
      a.per_round < 1 || a.per_round > g.slot || a.rounds < 1 ||
      static_cast<long long>(a.rounds - 1) * a.per_round >= a.count ||
      static_cast<long long>(a.rounds) * a.per_round < a.count) {
    return false;
  }
  const long long tail = a.count - static_cast<long long>(a.rounds - 1) * a.per_round;
  if (!valid_bounds(a.last, a.size, tail, g.rs_row)) return false;
  if (a.rounds > 1 && !valid_bounds(a.full, a.size, a.per_round, g.rs_row)) return false;
  const long long* widest = a.rounds > 1 ? a.full : a.last;
  for (int j = 0; j < a.size; ++j) {
    if (static_cast<long long>(blocks) * a.block_elems < widest[j + 1] - widest[j]) return false;
  }
  return true;
}

}  // namespace

// This rank's region on the current device, laid out for `size` ranks:
// the header zeroed, the one-shot inbox for payloads of up to
// `one_shot_bytes`, the two-shot inbox and gather slots for rounds of
// `slot_bytes`, and the mapped error word → *ctx; its exchange row
// (kRowBytes: the IPC handle, then the card's PCI bus id) into `row`.
extern "C" int nislam_ar_create(int rank, int size, long long slot_bytes, long long one_shot_bytes, void** ctx,
                                void* row) {
  if (ctx == nullptr || row == nullptr || size < 1 || size > kMaxRanks || rank < 0 || rank >= size ||
      slot_bytes < 16 || slot_bytes % 16 || one_shot_bytes < 8LL * kOneShotBlocks ||
      one_shot_bytes % (8LL * kOneShotBlocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* g = new Region();
  g->rank = rank;
  g->size = size;
  const long long peers = size > 1 ? size : 0;  // one rank: the header alone
  g->ll_window = one_shot_bytes / 4 / kOneShotBlocks;
  g->ll_row = g->ll_window * kOneShotBlocks;
  g->ll_off = kHeader;
  g->slot = slot_bytes / 4;
  g->rs_row = (g->slot + size - 1) / size;
  g->rs_row = (g->rs_row + 3) / 4 * 4;
  g->rs_off = g->ll_off + 2 * peers * g->ll_row * 8;
  g->ag_off = g->rs_off + 2 * peers * g->rs_row * 4;
  g->bytes = g->ag_off + (peers ? 2 * g->slot * 4 : 0);
  cudaError_t err = cudaGetDevice(&g->device);
  char* own = nullptr;
  if (err == cudaSuccess) err = cudaMalloc(&own, g->bytes);
  if (err == cudaSuccess) g->base[rank] = own;
  if (err == cudaSuccess) err = cudaMemset(own, 0, g->bytes);
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
// `out` (the same pointer for in place) on `stream`, by the host's `plan`
// (kPlanWords int64 words, ops/all_reduce.py::launch_plan); returns the
// launch's error, or cudaErrorInvalidValue for a plan this region cannot
// run.  At one rank the plan is kNone and an in-place call launches
// nothing.  Every rank of the group must make the same calls in the same
// order.
extern "C" int nislam_ar_launch(void* ctx, const void* in, void* out, long long count, int dtype,
                                const long long* plan, int plan_words, unsigned long long timeout_ns, void* stream) {
  auto* g = static_cast<Region*>(ctx);
  if (g == nullptr || in == nullptr || out == nullptr || count < 1 || (dtype != kFloat32 && dtype != kInt32) ||
      plan == nullptr || plan_words != kPlanWords || plan[5] != count) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (g->size == 1) return plan[0] == kNone && in == out ? 0 : static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < g->size; ++q) {
    if (g->base[q] == nullptr) return static_cast<int>(cudaErrorInvalidValue);  // not opened
  }
  Args a = {};
  a.in = in;
  a.out = out;
  a.count = count;
  a.protocol = static_cast<int>(plan[0]);
  const long long blocks = plan[1];
  a.block_elems = plan[2];
  a.per_round = plan[3];
  a.rounds = static_cast<int>(plan[4]);
  for (int j = 0; j <= kMaxRanks; ++j) {
    a.full[j] = plan[kPlanHead + j];
    a.last[j] = plan[kPlanHead + kMaxRanks + 1 + j];
  }
  a.rank = g->rank;
  a.size = g->size;
  a.vec = (reinterpret_cast<std::uintptr_t>(in) | reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  a.timeout_ns = timeout_ns;
  a.error = g->error_dev;
  a.ll_window = g->ll_window;
  a.ll_row = g->ll_row;
  a.ll_off = g->ll_off;
  a.rs_row = g->rs_row;
  a.rs_off = g->rs_off;
  a.slot = g->slot;
  a.ag_off = g->ag_off;
  for (int q = 0; q < g->size; ++q) a.base[q] = g->base[q];
  if (blocks < 1 || blocks > kMaxBlocks || !valid_plan(*g, a, static_cast<int>(blocks))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    all_reduce_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(a);
  } else {
    all_reduce_kernel<int><<<static_cast<int>(blocks), kThreads, 0, s>>>(a);
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

// The exchange row's size, the most ranks a group holds, the plan's words,
// the threads of a block and the most blocks of each protocol: the host's
// plan reads them.
extern "C" int nislam_ar_row_bytes() { return kRowBytes; }
extern "C" int nislam_ar_max_ranks() { return kMaxRanks; }
extern "C" int nislam_ar_plan_words() { return kPlanWords; }
extern "C" int nislam_ar_threads() { return kThreads; }
extern "C" int nislam_ar_max_blocks(int protocol) {
  return protocol == kOneShot ? kOneShotBlocks : protocol == kTwoShot ? kMaxBlocks : 0;
}

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
