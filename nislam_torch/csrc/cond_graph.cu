// A chunk of tracked frames as ONE CUDA graph launch, for Hopper (sm_90a):
// a WHILE conditional node over the frames, whose body nests the graphs
// that PyTorch captured (the track graph; the keyframe branch graphs
// under one SWITCH conditional node), built through the CUDA
// runtime's conditional-node API (SWITCH nodes: CUDA >= 12.8).
//
// Counterpart of JAX's SlamEngine.run_chunk (nislam_tpu/core/slam.py,
// one jitted lax.scan whose step runs the keyframe branch as lax.cond):
// the chunk makes no host read between its frames.  The graph is
//
//   copy          frame i0's img_u and polar -> the track graph's inputs
//   WHILE loop:                               (handle on the outer graph)
//     child       the track graph (its captured cudaGraph_t, cloned)
//     flags       one warp over the lanes' [insert, stored] flags -> the
//                 SWITCH value (the body the frame needs, or none) and
//                 that body's run count; stop when the frame needs a body
//                 the graph lacks; next = i + 1 unless stop
//     SWITCH:     body s: the frame-i spectra -> the fft buffer (one
//                 segment), then child (body s's branch graph)
//     advance     every block: frame next's img_u and polar -> the track
//                 graph's inputs, unless stop or next == n; block 0: the
//                 packed output -> row i, i = next, loop = !stop && next < n
//
// The flags kernel picks the body in one of two ways (nislam_cg_add_flags):
//  - the single engine (one lane): body 0 for a keyframe the bank stores,
//    body 1 for one it drops, as JAX's scan step runs one lax.cond;
//  - the batch engine: body k - 1 when k lanes insert (a ballot and its
//    popcount), the branch over the k lanes gathered on the device, as
//    JAX's batch step runs one vmapped insert and one vmapped loop search
//    (nislam_tpu/parallel/batch.py).  The segment is every lane's spectra.
//
// over a control block of int32 words that the caller owns (the layout
// below; nislam_torch/core/chunk_graph.py mirrors it): the frame index,
// the end, the stop flag, the frames done, one run count per slot, the
// next frame, and the chunk's table (feature sources and strides, the
// output), which nislam_cg_launch writes with one small kernel before the
// graph launch.  The host reads the block once, after the chunk.
//
// The advance's blocks are not scheduled together, so none of them may
// read the frame index that block 0 advances: a late block would copy
// frame i + 2.  They read kNext, which the flags kernel wrote before them
// and no block of the advance writes.
//
// What the build found on the card (NVIDIA H100, driver 580, PyTorch
// 2.11 with its CUDA 12.8 runtime, this library built by nvcc 12.9 with
// its static cudart):
//  - a conditional body holds child graph nodes, so a captured graph goes
//    in whole (cudaGraphAddChildGraphNode clones it; nothing is copied
//    node by node, and nothing is captured into a body).  PyTorch's
//    captures of the track and branch graphs hold kernel, memcpy and
//    memset nodes only, which a body accepts (nislam_graph_node_types
//    walks them before a build; the caller refuses any other type);
//  - cudaGraph_t is the driver's CUgraph, so PyTorch's graphs (its own
//    dynamic cudart) go straight to this library's static cudart;
//  - a SWITCH handle nested in the WHILE body is created on the body
//    graph, the graph that holds its conditional node; the WHILE handle on
//    the outer graph;
//  - the WHILE handle starts each launch at 1 (cudaGraphCondAssignDefault,
//    default 1): the caller launches only a chunk with a frame to run,
//    and the advance kernel sets it after every frame.  The SWITCH handles
//    are set by the flags kernel in every iteration;
//  - a SWITCH body may hold no node (a kind the graph lacks);
//  - cudaGraphNodeGetType fails (cudaErrorUnknown) on a conditional node,
//    so nislam_cg_describe knows each node it finds by the kind recorded
//    when the node was added.
//
// Bound, per frame at 480x640 (720x480 polar grid): img_u (1,228,800 B of
// f32) and polar (694,080 B: 360x241 c64) read once and written once,
// 3,845,760 B, 1.15 us at 3.35 TB/s; a frame that inserts moves its
// spectrum too (1,232,640 B: 480x321 c64), 2,465,280 B more, 0.74 us.  At
// 1200x1600: 16,748,160 B (5.0 us) and 15,379,200 B (4.59 us).  The
// WHILE iteration and its nodes cost what a launch does per node, which
// the empty-body chunk graph (nislam_cg_empty_graph as its nested graphs)
// measures.  The copy gives each block one 16 KB piece of one segment,
// each thread four 16-byte loads in flight before its first store, and as
// many blocks as pieces: the whole copy is in flight at once.
//
// The deferred pose-graph trigger as ONE graph launch (the solve graph,
// nislam_torch/core/solve_graph.py), the counterpart of JAX's
// maybe_optimize (nislam_tpu/core/slam.py: one lax.cond over the pending
// edges, a lax.while_loop LM solve, the pending clear and the chain):
//
//   trigger       one warp over the lanes: the live pending count of each
//                 (i < count and loop_slot >= 0, over the whole buffer)
//                 against 2 -> its run flag; mu = mu_init, active = run,
//                 the iteration count 0; the IF handle = any(run)
//   IF:                                       (handle on the outer graph)
//     child       setup: the masked pending-edge loop, the problem, the
//                 scatter plans, x0 and cost0 (PyTorch's capture)
//     loop_begin  the WHILE handle = the loop condition the trigger set
//     WHILE:                                  (handle on the IF body)
//       child     one LM iteration (PyTorch's capture)
//       lm_step   one warp over the lanes: each active lane's mu on the
//                 host schedule, its stop; count + 1; the WHILE handle =
//                 any(active) && count < max_iterations
//     child       finish: the poses, the online canvas, the pending count,
//                 the chain, the final costs, for the lanes that ran
//
// One helper (append_solve) appends this program to a graph after a given
// node: nislam_sg_create to a graph of its own, nislam_cg_add_inline to a
// chunk graph's stored body.  The caller leaves the WHILE out when the
// configuration stops the loop before its first iteration (max_iterations
// < 1 or mu_init >= mu_max), so its first test is JAX's cond at the start.
// loop_begin sets the WHILE handle from the condition that the trigger
// wrote each time the IF body runs (in a chunk graph it may run once per
// solving keyframe of a launch, where a handle's default would be applied
// once per launch).  trigger and lm_step also write the control words that
// the host reads after the launch (the run flags, the iteration count),
// and outside a graph (no handle) they are the host loop's kernels.  mu / f
// and mu * f round as IEEE float32 does (__fdiv_rn, __fmul_rn), as the
// host schedule's np.float32 does.  Each kernel counts its own launches on
// the device.
//
// Bound: a few hundred bytes per launch (the pending buffer, 4 bytes per
// slot and lane; the control words), far below a launch: both kernels are
// bound by the launch floor.
//
// The inline trigger, the counterpart of the lax.cond over
// _flush_pending_loops in JAX's scan step (nislam_tpu/core/slam.py:1096,
// its gate stored & ~loop_found): with the inline solve, the single
// engine's stored SWITCH body goes on after its branch child
// (nislam_cg_add_inline):
//
//   SWITCH, body 0:  copy, child (the stored branch)
//     trigger     gated: the lane runs only where the frame's loop_found
//                 (the packed output's field 2, which the branch wrote) is
//                 0, and a gated lane that does not run has its pending
//                 count cleared (the reference discards a single match);
//                 the IF handle (made on this body) = any(run)
//     IF:         setup, loop_begin, WHILE(iteration, lm_step), and the
//                 inline finish: poses, online canvas, pending count,
//                 chain, and the frame's output fields
//
// WHILE(frames) -> SWITCH(kind) -> IF(run) -> WHILE(LM): four levels of
// conditional nodes, each added to the body graph that holds it (a
// conditional node inside a child graph node is refused, so the solve
// graph cannot be nested whole).  The flag-read frame graph launches the
// same program on its own (nislam_sg_create with the gate).  The kernels
// write counts that only grow (kTriggers ... kIterations) when they run
// inside a graph: the host reads them with the chunk's control block and
// adds what the nested steps ran.  What the card took (NVIDIA H100,
// driver 580, PyTorch 2.11 with its CUDA 12.8 runtime, nvcc 12.9): the
// four levels, with handles made on the graphs that hold their nodes.
//
// The distributed engine's GN-CG trigger (nislam_tg_create; parallel/
// solver.py::CGTrigger): the trigger kernel and an IF holding the setup,
// a WHILE over the Gauss-Newton steps and inside it a WHILE over the CG
// iterations, whose captured children hold NCCL's all-reduces; the
// cg_step kernel sets both WHILE handles (its CG test in double against
// the host's double tolerance).  Bound: a few words per launch; the
// launch floor bounds it.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <new>

namespace {

constexpr int kMaxLanes = 32;
constexpr int kMaxSlots = kMaxLanes;      // SWITCH bodies: 2 (stored, dropped) or one per k
constexpr int kSegments = 3;              // the table's sources
constexpr int kImg = 0, kFft = 1, kPolar = 2;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                                // 16-byte loads in flight per thread
constexpr long long kPiece = 16LL * kUnroll * kThreads;  // bytes one block copies: 16 KB

// The control block, in int32 words.
constexpr int kI = 0;     // the frame the body runs
constexpr int kN = 1;     // the chunk's end (exclusive)
constexpr int kStop = 2;  // 1: frame kI needs a body the graph lacks
constexpr int kDone = 3;  // frames completed in this launch
constexpr int kRuns = 4;  // kMaxSlots run counts
constexpr int kNext = kRuns + kMaxSlots;  // the frame the advance moves to (the flags kernel writes it)
constexpr int kTable = kNext + 2;         // 8-byte aligned: the Table below
static_assert(kTable % 2 == 0, "the table needs 8-byte alignment");

struct Table {
  long long src[kSegments];     // frame 0's features (device addresses)
  long long stride[kSegments];  // bytes from one frame to the next
  long long out;                // the chunk's packed output (float)
  long long out_lane;           // floats from one lane's rows to the next
};

__device__ __forceinline__ const Table* table(const int* ctl) {
  return reinterpret_cast<const Table*>(ctl + kTable);
}

// Bytes [offset, offset + bytes) of a frame of table source `source` ->
// dst; the blocks from `first` on copy it, one kPiece each.
struct Segment {
  char* dst;
  long long bytes;
  long long offset;
  int source;
  int first;
};

constexpr int kMaxCopy = 2;

struct Copy {
  int* ctl;
  int frame;  // the control word that names the frame: kI, or kNext in the advance
  int segments;
  Segment seg[kMaxCopy];
  // The advance's (block 0) when packed is set: row next - 1 of the
  // output, i = next, the WHILE handle.
  const float* packed;  // (lanes, width)
  int lanes;
  int width;
  cudaGraphConditionalHandle loop;
};

struct Flags {
  int* ctl;
  const unsigned char* flags;  // (lanes, 2) bool: insert, stored
  int lanes;
  int by_count;             // the body: 0 the one lane's kind (0 stored, 1 dropped), 1 k - 1
  unsigned slots;           // the SWITCH's bodies; a value of `slots` runs none
  unsigned long long have;  // bit s: the graph holds body s
  cudaGraphConditionalHandle handle;  // the SWITCH's (when have != 0)
};

__global__ void begin_kernel(int* ctl, int i0, int n, Table t) {
  const int k = threadIdx.x;
  if (k == 0) {
    ctl[kI] = i0;
    ctl[kN] = n;
    ctl[kStop] = 0;
    ctl[kDone] = 0;
    ctl[kNext] = i0;
    *reinterpret_cast<Table*>(ctl + kTable) = t;
  }
  for (int s = k; s < kMaxSlots; s += blockDim.x) ctl[kRuns + s] = 0;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, long long n) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | static_cast<uintptr_t>(n)) & 15) == 0;
}

// Bytes [lo, hi) of src -> dst by this block: every thread's kUnroll loads
// issued before its first store (16-byte units when `vec`).
__device__ __forceinline__ void copy_piece(char* dst, const char* src, long long lo, long long hi, bool vec) {
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + lo);
    uint4* d4 = reinterpret_cast<uint4*>(dst + lo);
    const int n = static_cast<int>((hi - lo) / 16);
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < n) v[k] = __ldg(s4 + q);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int q = threadIdx.x + k * kThreads;
      if (q < n) d4[q] = v[k];
    }
  } else {
    for (long long q = lo + threadIdx.x; q < hi; q += kThreads) dst[q] = src[q];
  }
}

// The advance's own work, in block 0.  Its threads read kNext, kStop and
// kN, which no block of this kernel writes; thread 0 writes kI and kDone.
__device__ __forceinline__ void advance_frame(const Copy& p) {
  int* ctl = p.ctl;
  const int next = ctl[kNext];
  const int stop = ctl[kStop];
  if (!stop) {
    const Table* t = table(ctl);
    float* out = reinterpret_cast<float*>(t->out);
    const long long row = static_cast<long long>(next - 1) * p.width;
    for (int q = threadIdx.x; q < p.lanes * p.width; q += blockDim.x) {
      out[(q / p.width) * t->out_lane + row + q % p.width] = p.packed[q];
    }
  }
  if (threadIdx.x == 0) {
    if (!stop) {
      ctl[kI] = next;
      ctl[kDone] += 1;
    }
    cudaGraphSetConditional(p.loop, !stop && next < ctl[kN]);
  }
}

// Copies frame ctl[p.frame]'s segments (in the advance: unless stop or the
// chunk's end), then, in the advance, block 0's work.
__global__ void __launch_bounds__(kThreads) copy_kernel(Copy p) {
  const int* ctl = p.ctl;
  const bool advance = p.packed != nullptr;
  const long long f = ctl[p.frame];
  if (!advance || (!ctl[kStop] && f < ctl[kN])) {
    const Table* t = table(ctl);
    const int s = (p.segments > 1 && static_cast<int>(blockIdx.x) >= p.seg[1].first) ? 1 : 0;
    const Segment& g = p.seg[s];
    const long long lo = (static_cast<long long>(blockIdx.x) - g.first) * kPiece;
    if (lo < g.bytes) {
      const long long hi = lo + kPiece < g.bytes ? lo + kPiece : g.bytes;
      const char* src = reinterpret_cast<const char*>(t->src[g.source]) + f * t->stride[g.source] + g.offset;
      copy_piece(g.dst, src, lo, hi, aligned16(src, g.dst, g.bytes));
    }
  }
  if (advance && blockIdx.x == 0) advance_frame(p);
}

// A copy of `n` segments, one block per kPiece of each → its grid.
int lay_out(Copy* c, int n, const Segment* segs) {
  c->segments = n;
  int blocks = 0;
  for (int s = 0; s < n; ++s) {
    c->seg[s] = segs[s];
    c->seg[s].first = blocks;
    blocks += static_cast<int>((segs[s].bytes + kPiece - 1) / kPiece);
  }
  return blocks > 0 ? blocks : 1;
}

// The body the frame needs: with k lanes inserting, the one lane's kind or
// k - 1; its run count, or stop when the graph lacks it.
__global__ void flags_kernel(Flags p) {
  const int l = threadIdx.x;
  const bool insert = l < p.lanes && p.flags[2 * l] != 0;
  const int k = __popc(__ballot_sync(0xffffffffu, insert));
  if (l == 0) {
    const int slot = p.by_count ? k - 1 : (p.flags[1] != 0 ? 0 : 1);
    const bool stop = k > 0 && !((p.have >> slot) & 1ull);
    const bool take = k > 0 && !stop;
    const int i = p.ctl[kI];
    p.ctl[kStop] = stop;
    p.ctl[kNext] = stop ? i : i + 1;
    if (p.have) cudaGraphSetConditional(p.handle, take ? static_cast<unsigned>(slot) : p.slots);
    if (take) p.ctl[kRuns + slot] += 1;
  }
}

__global__ void empty_kernel() {}

// A node added to the graph and its kind, which nislam_cg_describe reads
// for each node that it finds in the graph.
enum NodeKind { kKernelNode, kCopyNode, kConditionalNode, kChildNode };
// The outer copy and WHILE; the track child, flags, SWITCH and advance; a
// copy and a child per body; the inline trigger's 8 nodes.
constexpr int kMaxAdded = 16 + 2 * kMaxSlots;

struct Added {
  cudaGraphNode_t node;
  NodeKind kind;
  cudaGraph_t bodies[kMaxSlots];  // a conditional node's
  int nbodies;
};

struct ChunkGraph {
  cudaGraph_t graph = nullptr;  // the outer graph: the first copy, the WHILE node
  cudaGraph_t body = nullptr;   // the WHILE body (owned by the graph)
  cudaGraphConditionalHandle loop = 0;
  cudaGraphNode_t tail = nullptr;  // the body's last node: the next one depends on it
  int* ctl = nullptr;
  int lanes = 0;
  unsigned long long have = 0;
  bool flags = false;
  bool by_count = false;  // the flags kernel's choice of body (Flags::by_count)
  unsigned slots = 0;     // the SWITCH's bodies
  cudaGraphConditionalHandle handle = 0;  // the SWITCH's
  Copy frame = {};  // img_u and polar: the first copy's and the advance's segments
  int blocks = 1;
  cudaGraph_t bodies[kMaxSlots] = {};  // the SWITCH bodies, in order
  int nbodies = 0;
  // The single engine's stored body and its last node (the branch child),
  // and, once nislam_cg_add_inline appended the inline trigger, its IF and
  // WHILE bodies.
  cudaGraph_t stored_body = nullptr;
  cudaGraphNode_t stored_tail = nullptr;
  cudaGraph_t if_body = nullptr;
  cudaGraph_t loop_body = nullptr;
  Added added[kMaxAdded] = {};  // every node added, by kind
  int nadded = 0;
  cudaGraphExec_t exec = nullptr;
};

void record(ChunkGraph* g, cudaGraphNode_t node, NodeKind kind, const cudaGraph_t* bodies = nullptr,
            int nbodies = 0) {
  if (g == nullptr || g->nadded >= kMaxAdded) return;
  Added& a = g->added[g->nadded++];
  a = {};
  a.node = node;
  a.kind = kind;
  a.nbodies = nbodies;
  for (int k = 0; k < nbodies; ++k) a.bodies[k] = bodies[k];
}

// Appends a node of `kind` made by `add` to the body's chain.
template <typename Add>
int chain(ChunkGraph* g, NodeKind kind, Add add) {
  cudaGraphNode_t node;
  const cudaGraphNode_t* dep = g->tail ? &g->tail : nullptr;
  const cudaError_t err = add(&node, dep, g->tail ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  g->tail = node;
  record(g, node, kind);
  return 0;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, size_t ndep,
                       void* func, dim3 grid, dim3 block, void** args) {
  cudaKernelNodeParams k = {};
  k.func = func;
  k.gridDim = grid;
  k.blockDim = block;
  k.sharedMemBytes = 0;
  k.kernelParams = args;
  k.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep, ndep, &k);
}

// A conditional node of `type` on `handle` in `graph` after `dep`, with
// `size` bodies → their graphs in bodies[0 .. size).
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, size_t ndep,
                            cudaGraphConditionalHandle handle, cudaGraphConditionalNodeType type, unsigned size,
                            cudaGraph_t* bodies) {
  cudaGraphNodeParams c = {};
  c.type = cudaGraphNodeTypeConditional;
  c.conditional.handle = handle;
  c.conditional.type = type;
  c.conditional.size = size;
  const cudaError_t err = cudaGraphAddNode(node, graph, dep, ndep, &c);
  if (err == cudaSuccess) {
    for (unsigned k = 0; k < size; ++k) bodies[k] = c.conditional.phGraph_out[k];
  }
  return err;
}

int count_types(cudaGraph_t graph, int* counts, int ntypes) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new (std::nothrow) cudaGraphNode_t[n ? n : 1];
  if (nodes == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t k = 0; err == cudaSuccess && k < n; ++k) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[k], &type);
    if (err != cudaSuccess) break;
    const int t = static_cast<int>(type);
    counts[t >= 0 && t < ntypes - 1 ? t : ntypes - 1] += 1;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[k], &child);
      if (err == cudaSuccess) {
        const int e = count_types(child, counts, ntypes);
        if (e != 0) err = static_cast<cudaError_t>(e);
      }
    }
  }
  delete[] nodes;
  return static_cast<int>(err);
}

// The top-level nodes of `graph` (cudaGraphGetNodes), each known by the
// kind recorded when it was added: counts[0] all, [1] conditional, [2]
// kernel, [3] of them the copy kernel, [4] child graph nodes.
int count_nodes(const ChunkGraph* g, cudaGraph_t graph, int* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new (std::nothrow) cudaGraphNode_t[n];
  if (nodes == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  err = cudaGraphGetNodes(graph, nodes, &n);
  for (size_t k = 0; err == cudaSuccess && k < n; ++k) {
    counts[0] += 1;
    for (int a = 0; a < g->nadded; ++a) {
      if (g->added[a].node != nodes[k]) continue;
      const NodeKind kind = g->added[a].kind;
      counts[1] += kind == kConditionalNode;
      counts[2] += kind == kKernelNode || kind == kCopyNode;
      counts[3] += kind == kCopyNode;
      counts[4] += kind == kChildNode;
    }
  }
  delete[] nodes;
  return static_cast<int>(err);
}

// The deepest nesting of conditional nodes under `graph` (at `level`) into
// *deepest: each node read back from the graph, a conditional one's bodies
// from its record.
int nesting(const ChunkGraph* g, cudaGraph_t graph, int level, int* deepest) {
  if (level > *deepest) *deepest = level;
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  cudaGraphNode_t* nodes = new (std::nothrow) cudaGraphNode_t[n];
  if (nodes == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  err = cudaGraphGetNodes(graph, nodes, &n);
  int e = static_cast<int>(err);
  for (size_t k = 0; e == 0 && k < n; ++k) {
    for (int a = 0; e == 0 && a < g->nadded; ++a) {
      const Added& rec = g->added[a];
      if (rec.node != nodes[k] || rec.kind != kConditionalNode) continue;
      for (int b = 0; e == 0 && b < rec.nbodies; ++b) e = nesting(g, rec.bodies[b], level + 1, deepest);
    }
  }
  delete[] nodes;
  return e;
}

int start_chunk(int* ctl, int i0, int n, void* src0, long long stride0, void* src1, long long stride1, void* src2,
          long long stride2, void* out, long long out_lane, cudaStream_t s) {
  Table t = {{reinterpret_cast<long long>(src0), reinterpret_cast<long long>(src1),
              reinterpret_cast<long long>(src2)},
             {stride0, stride1, stride2},
             reinterpret_cast<long long>(out),
             out_lane};
  begin_kernel<<<1, 64, 0, s>>>(ctl, i0, n, t);
  return static_cast<int>(cudaGetLastError());
}

// The solve graph's control words (int32), nislam_torch/core/solve_graph.py
// mirrors them: the LM iteration count and loop condition (core/pose_graph.py's
// IT and LOOP), any lane runs, then one run flag per lane.
constexpr int kIt = 0;
constexpr int kLoop = 1;
constexpr int kAny = 2;
constexpr int kRun = 3;
// Counts that only grow, written by the kernels inside a graph (has_handle):
// the triggers run, the IF bodies taken (deferred, inline), the LM iterations.
constexpr int kTriggers = kRun + kMaxLanes;
constexpr int kSolves = kTriggers + 1;
constexpr int kInlineSolves = kTriggers + 2;
constexpr int kIterations = kTriggers + 3;

__device__ unsigned long long trigger_launches;  // launches run on this device
__device__ unsigned long long lm_step_launches;

struct Trigger {
  int* ctl;
  int* count;            // (lanes,) pending count (the gated trigger clears it)
  const int* loop_slot;  // (lanes, pending) pending loop slots, -1: voided
  int pending;
  unsigned char* run;     // (lanes,) bool
  unsigned char* active;  // (lanes,) bool
  float* mu;              // (lanes,)
  int lanes;
  float mu_init;
  float mu_max;
  int max_iterations;
  const float* gate;  // null, or lane l's loop_found at gate[l * gate_stride]: the inline trigger
  int gate_stride;
  int has_handle;
  cudaGraphConditionalHandle handle;  // the IF's
};

struct LMStep {
  int* ctl;
  float* mu;
  unsigned char* active;
  const unsigned char* accept;
  const unsigned char* small;
  int lanes;
  float factor;
  float mu_min;
  float mu_max;
  int max_iterations;
  int has_handle;
  cudaGraphConditionalHandle handle;  // the WHILE's
};

__global__ void trigger_kernel(Trigger p) {
  const int l = threadIdx.x;
  const bool lane = l < p.lanes;
  int live = 0;
  bool gate = lane;
  if (lane) {
    const int c = p.count[l];
    for (int i = 0; i < p.pending; ++i) live += (i < c && p.loop_slot[l * p.pending + i] >= 0) ? 1 : 0;
    if (p.gate) gate = !(p.gate[l * p.gate_stride] > 0.5f);
  }
  const bool run = gate && live >= 2;
  const bool act = run && p.mu_init < p.mu_max;
  if (lane) {
    // The inline trigger discards a match that nothing confirmed.
    if (p.gate && gate && !run) p.count[l] = 0;
    p.run[l] = run;
    p.active[l] = act;
    p.mu[l] = p.mu_init;
    p.ctl[kRun + l] = run;
  }
  const bool any_run = __any_sync(0xffffffffu, run);
  const bool any_act = __any_sync(0xffffffffu, act);
  if (l == 0) {
    p.ctl[kIt] = 0;
    p.ctl[kAny] = any_run;
    p.ctl[kLoop] = any_act && p.max_iterations > 0;
    if (p.has_handle) {
      cudaGraphSetConditional(p.handle, any_run ? 1u : 0u);
      p.ctl[kTriggers] += 1;
      if (any_run) p.ctl[p.gate ? kInlineSolves : kSolves] += 1;
    }
    atomicAdd(&trigger_launches, 1ull);
  }
}

__global__ void lm_step_kernel(LMStep p) {
  const int l = threadIdx.x;
  bool act = l < p.lanes && p.active[l] != 0;
  if (act) {
    float mu = p.mu[l];
    if (p.accept[l]) {
      mu = fmaxf(__fdiv_rn(mu, p.factor), p.mu_min);
      act = p.small[l] == 0;
    } else {
      mu = fminf(__fmul_rn(mu, p.factor), p.mu_max);
    }
    act = act && mu < p.mu_max;
    p.mu[l] = mu;
    p.active[l] = act;
  }
  const bool any = __any_sync(0xffffffffu, act);
  if (l == 0) {
    const int it = p.ctl[kIt] + 1;
    const bool loop = any && it < p.max_iterations;
    p.ctl[kIt] = it;
    p.ctl[kLoop] = loop;
    if (p.has_handle) {
      cudaGraphSetConditional(p.handle, loop ? 1u : 0u);
      p.ctl[kIterations] += 1;
    }
    atomicAdd(&lm_step_launches, 1ull);
  }
}

// Inside the inline trigger's IF body, ahead of its WHILE node: the WHILE
// handle = the loop condition that the trigger set.  The IF body runs once
// per solving keyframe of a chunk, so the handle cannot rest on a default
// that is applied once per launch.
__global__ void loop_begin_kernel(const int* ctl, cudaGraphConditionalHandle handle) {
  if (threadIdx.x == 0) cudaGraphSetConditional(handle, ctl[kLoop] ? 1u : 0u);
}

// The GN-CG trigger's words, after the solve graph's (the same control
// block; nislam_torch/parallel/solver.py mirrors them): the Gauss-Newton
// step and the CG iteration of the running solve, the two WHILE
// conditions, then two counts that only grow inside a graph (has_handle):
// the Gauss-Newton steps and the CG iterations run.
constexpr int kGn = kIterations + 1;
constexpr int kCgIt = kGn + 1;
constexpr int kCgLoop = kCgIt + 1;
constexpr int kGnLoop = kCgLoop + 1;
constexpr int kGnTotal = kGnLoop + 1;
constexpr int kCgTotal = kGnTotal + 1;
// What a cg_step launch does: the Gauss-Newton loop's start and step, the
// CG loop's start and step.
enum CGMode { kGnBegin = 0, kGnStep = 1, kCgBegin = 2, kCgStep = 3 };

__device__ unsigned long long cg_step_launches;

struct CGStep {
  int* ctl;
  const float* r2;  // the CG's ||r||^2, made from all-reduced values only
  int mode;
  int cg_iterations;
  int outer_iterations;
  double tol2;  // cg_tol ** 2 as the host's double
  int has_handle;
  cudaGraphConditionalHandle handle;  // the WHILE's that the mode sets
};

// The counterpart of the CG lax.while_loop's condition and of the
// Gauss-Newton fori_loop's counter (nislam_tpu/parallel/solver.py): a
// start sets its counter to 0, a step adds one; the CG condition is
// it < cg_iterations && r2 > tol2 with r2 widened to double, as the
// host's float(r2) > cg_tol ** 2 compares it (an f32 test against a
// rounded tolerance could leave the loop one iteration apart at the
// boundary); the Gauss-Newton condition gn < outer_iterations.
__global__ void cg_step_kernel(CGStep p) {
  if (threadIdx.x != 0) return;
  int* c = p.ctl;
  bool loop;
  if (p.mode == kGnBegin || p.mode == kGnStep) {
    const int gn = p.mode == kGnBegin ? 0 : c[kGn] + 1;
    loop = gn < p.outer_iterations;
    c[kGn] = gn;
    c[kGnLoop] = loop;
    if (p.has_handle && p.mode == kGnStep) c[kGnTotal] += 1;
  } else {
    const int it = p.mode == kCgBegin ? 0 : c[kCgIt] + 1;
    loop = it < p.cg_iterations && static_cast<double>(*p.r2) > p.tol2;
    c[kCgIt] = it;
    c[kCgLoop] = loop;
    if (p.has_handle && p.mode == kCgStep) c[kCgTotal] += 1;
  }
  if (p.has_handle) cudaGraphSetConditional(p.handle, loop ? 1u : 0u);
  atomicAdd(&cg_step_launches, 1ull);
}

// The solve graph: the trigger node and the IF node on the outer graph;
// the IF body a chain (setup, loop_begin, WHILE, finish); the WHILE body
// the iteration and lm_step.  The GN-CG trigger's graph (nislam_tg_create)
// has a second WHILE inside the first: `inner`.
struct SolveGraph {
  cudaGraph_t graph = nullptr;
  cudaGraph_t body = nullptr;   // the IF's (owned by the graph)
  cudaGraph_t loop = nullptr;   // the WHILE's (owned by the graph)
  cudaGraph_t inner = nullptr;  // the GN-CG trigger's CG WHILE's
  cudaGraphExec_t exec = nullptr;
};

}  // namespace

// The node types of `graph` (a cudaGraph_t), child graphs walked: counts[t]
// += the nodes of cudaGraphNodeType t, for t < ntypes - 1; counts[ntypes -
// 1] the nodes of any later type.  Returns a cudaError_t.
extern "C" int nislam_graph_node_types(void* graph, int* counts, int ntypes) {
  if (graph == nullptr || counts == nullptr || ntypes < 2) return static_cast<int>(cudaErrorInvalidValue);
  return count_types(static_cast<cudaGraph_t>(graph), counts, ntypes);
}

// A new chunk graph over the control block `ctl` (device, int32) for
// `lanes` lanes: the outer graph, its copy of frame i0's img_u (img_bytes
// into img) and polar (polar_bytes into polar; a zero size copies
// nothing), and its WHILE node after it, with an empty body.
extern "C" int nislam_cg_create(void** out, void* ctl, int lanes, void* img, long long img_bytes, void* polar,
                                long long polar_bytes) {
  if (out == nullptr || ctl == nullptr || lanes < 1 || lanes > kMaxLanes || img_bytes < 0 || polar_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChunkGraph* g = new (std::nothrow) ChunkGraph();
  if (g == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  g->ctl = static_cast<int*>(ctl);
  g->lanes = lanes;
  const Segment segs[2] = {{static_cast<char*>(img), img_bytes, 0, kImg, 0},
                           {static_cast<char*>(polar), polar_bytes, 0, kPolar, 0}};
  g->frame.ctl = g->ctl;
  g->frame.frame = kI;
  g->blocks = lay_out(&g->frame, 2, segs);
  cudaError_t err = cudaGraphCreate(&g->graph, 0);
  if (err == cudaSuccess) {
    err = cudaGraphConditionalHandleCreate(&g->loop, g->graph, 1, cudaGraphCondAssignDefault);
  }
  cudaGraphNode_t first, node;
  if (err == cudaSuccess) {
    Copy c = g->frame;
    void* args[] = {&c};
    err = add_kernel(&first, g->graph, nullptr, 0, reinterpret_cast<void*>(copy_kernel), dim3(g->blocks), dim3(kThreads), args);
    if (err == cudaSuccess) record(g, first, kCopyNode);
  }
  if (err == cudaSuccess) {
    err = add_conditional(&node, g->graph, &first, 1, g->loop, cudaGraphCondTypeWhile, 1, &g->body);
    if (err == cudaSuccess) record(g, node, kConditionalNode, &g->body, 1);
  }
  if (err != cudaSuccess) {
    if (g->graph) cudaGraphDestroy(g->graph);
    delete g;
    return static_cast<int>(err);
  }
  *out = g;
  return 0;
}

// The body's child graph node: a clone of `child` (a cudaGraph_t).
extern "C" int nislam_cg_add_child(void* h, void* child) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || child == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chain(g, kChildNode, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return cudaGraphAddChildGraphNode(n, g->body, d, nd, static_cast<cudaGraph_t>(child));
  });
}

// The body's flags kernel (one warp) over `flags` ((lanes, 2) bool on the
// device), choosing the body by the one lane's kind (by_count 0: body 0
// stored, 1 dropped; one lane only) or by the count k of lanes that
// insert (by_count 1: body k - 1 of `lanes`), and, when the graph holds a
// body (bit s of `have`: body s), the SWITCH handle it sets; the SWITCH
// follows (nislam_cg_add_switch).  With no body held the kernel only
// stops the chunk at a frame that inserts.
extern "C" int nislam_cg_add_flags(void* h, const void* flags, unsigned long long have, int by_count) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || flags == nullptr || g->flags || (!by_count && g->lanes != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned slots = by_count ? static_cast<unsigned>(g->lanes) : 2u;
  if (slots < 64 && (have >> slots) != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (have != 0) {
    const cudaError_t err = cudaGraphConditionalHandleCreate(&g->handle, g->body, slots, cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g->have = have;
  g->flags = true;
  g->by_count = by_count != 0;
  g->slots = slots;
  Flags p = {};
  p.ctl = g->ctl;
  p.flags = static_cast<const unsigned char*>(flags);
  p.lanes = g->lanes;
  p.by_count = by_count != 0;
  p.slots = slots;
  p.have = have;
  p.handle = g->handle;
  void* args[] = {&p};
  return chain(g, kKernelNode, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_kernel(n, g->body, d, nd, reinterpret_cast<void*>(flags_kernel), dim3(1), dim3(32), args);
  });
}

// The SWITCH node (its handle made by nislam_cg_add_flags), of the bodies
// that nislam_cg_add_flags chose: body s the copy of the frame-i spectra
// (fft_bytes from the table's fft source into fft) and a clone of
// bodies[s] (a cudaGraph_t; null for a body the graph lacks, which stays
// empty: the flags kernel never selects it).
extern "C" int nislam_cg_add_switch(void* h, void** bodies, void* fft, long long fft_bytes) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || !g->flags || g->have == 0 || bodies == nullptr || fft_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (unsigned k = 0; k < g->slots; ++k) {
    if (((g->have >> k) & 1ull) != (bodies[k] != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGraph_t graphs[kMaxSlots] = {};
  int err = chain(g, kConditionalNode, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_conditional(n, g->body, d, nd, g->handle, cudaGraphCondTypeSwitch, g->slots, graphs);
  });
  if (err != 0) return err;
  Added& rec = g->added[g->nadded - 1];
  rec.nbodies = static_cast<int>(g->slots);
  for (unsigned k = 0; k < g->slots; ++k) {
    rec.bodies[k] = graphs[k];
    g->bodies[g->nbodies++] = graphs[k];
    if (bodies[k] == nullptr) continue;
    const Segment seg = {static_cast<char*>(fft), fft_bytes, 0, kFft, 0};
    Copy c = {};
    c.ctl = g->ctl;
    c.frame = kI;
    const int blocks = lay_out(&c, 1, &seg);
    void* args[] = {&c};
    cudaGraphNode_t copy, inner;
    cudaError_t e = add_kernel(&copy, graphs[k], nullptr, 0, reinterpret_cast<void*>(copy_kernel), dim3(blocks),
                               dim3(kThreads), args);
    if (e == cudaSuccess) {
      record(g, copy, kCopyNode);
      e = cudaGraphAddChildGraphNode(&inner, graphs[k], &copy, 1, static_cast<cudaGraph_t>(bodies[k]));
    }
    if (e == cudaSuccess) record(g, inner, kChildNode);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (k == 0 && !g->by_count) {
      g->stored_body = graphs[0];
      g->stored_tail = inner;
    }
  }
  return 0;
}

// The body's last node: the advance (the packed output, (lanes, width)
// floats at `packed`, into row i of the table's output, i = next, the
// WHILE handle) with the copy of frame next's img_u and polar in.
extern "C" int nislam_cg_add_advance(void* h, const void* packed, int width) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || packed == nullptr || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  Copy c = g->frame;
  c.frame = kNext;
  c.packed = static_cast<const float*>(packed);
  c.lanes = g->lanes;
  c.width = width;
  c.loop = g->loop;
  void* args[] = {&c};
  return chain(g, kCopyNode, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_kernel(n, g->body, d, nd, reinterpret_cast<void*>(copy_kernel), dim3(g->blocks), dim3(kThreads), args);
  });
}

extern "C" int nislam_cg_instantiate(void* h) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || g->exec != nullptr || g->tail == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphInstantiate(&g->exec, g->graph, 0));
}

// The control block's start for frames [i0, n) on `stream`: the table
// (the features of frame 0 at src0..2, `stride0..2` bytes apart; the
// output at `out`, `out_lane` floats between lanes), i = next = i0, the
// counts 0.  Returns a cudaError_t.
extern "C" int nislam_cg_begin(void* ctl, int i0, int n, void* src0, long long stride0, void* src1,
                               long long stride1, void* src2, long long stride2, void* out, long long out_lane,
                               void* stream) {
  if (ctl == nullptr || i0 < 0 || i0 >= n) return static_cast<int>(cudaErrorInvalidValue);
  return start_chunk(static_cast<int*>(ctl), i0, n, src0, stride0, src1, stride1, src2, stride2, out, out_lane,
               static_cast<cudaStream_t>(stream));
}

// Frames [i0, n) on `stream`: nislam_cg_begin's kernel, then the graph.
// Returns the first cudaError_t.
extern "C" int nislam_cg_launch(void* h, int i0, int n, void* src0, long long stride0, void* src1,
                                long long stride1, void* src2, long long stride2, void* out, long long out_lane,
                                void* stream) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || g->exec == nullptr || i0 < 0 || i0 >= n || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = start_chunk(g->ctl, i0, n, src0, stride0, src1, stride1, src2, stride2, out, out_lane, s);
  if (err != 0) return err;
  return static_cast<int>(cudaGraphLaunch(g->exec, s));
}

// The built graph's structure, into out[0 .. 19): [0] the outer graph's
// nodes; one WHILE iteration's nodes [1] in all, [2] conditional, [3]
// kernel, [4] of them the copy kernel, [5] child graphs; the SWITCH bodies
// [6] in all, [7] empty; in them [8] nodes, [9] conditional, [10] kernel,
// [11] of them the copy kernel, [12] child graphs; the inline trigger's IF
// bodies [13] in all, in them [14] nodes, [15] conditional, [16] child
// graphs; its WHILE bodies' nodes [17]; [18] the deepest nesting of
// conditional nodes (the outer WHILE is 1), each level read back from the
// graph (cudaGraphGetNodes) and known by what was recorded when its node
// was added.
extern "C" int nislam_cg_describe(void* h, int* out, int n) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || out == nullptr || n < 19) return static_cast<int>(cudaErrorInvalidValue);
  std::memset(out, 0, sizeof(int) * n);
  size_t outer = 0;
  cudaError_t err = cudaGraphGetNodes(g->graph, nullptr, &outer);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = static_cast<int>(outer);
  int e = count_nodes(g, g->body, out + 1);
  for (int k = 0; e == 0 && k < g->nbodies; ++k) {
    const int before = out[8];
    e = count_nodes(g, g->bodies[k], out + 8);
    out[6] += 1;
    out[7] += out[8] == before;
  }
  int scratch[5];
  if (e == 0 && g->if_body != nullptr) {
    out[13] = 1;
    std::memset(scratch, 0, sizeof(scratch));
    e = count_nodes(g, g->if_body, scratch);
    out[14] = scratch[0];
    out[15] = scratch[1];
    out[16] = scratch[4];
    if (e == 0 && g->loop_body != nullptr) {
      std::memset(scratch, 0, sizeof(scratch));
      e = count_nodes(g, g->loop_body, scratch);
      out[17] = scratch[0];
    }
  }
  if (e == 0) e = nesting(g, g->graph, 0, &out[18]);
  return e;
}

extern "C" int nislam_cg_destroy(void* h) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr) return 0;
  cudaError_t err = cudaSuccess;
  if (g->exec) err = cudaGraphExecDestroy(g->exec);
  if (g->graph) {
    const cudaError_t e = cudaGraphDestroy(g->graph);
    if (err == cudaSuccess) err = e;
  }
  delete g;
  return static_cast<int>(err);
}

// A graph of a chain of `kernels` empty kernel nodes: a body that costs
// what that many nodes do.
extern "C" int nislam_cg_empty_graph(void** out, int kernels) {
  if (out == nullptr || kernels < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t node = nullptr;
  for (int k = 0; err == cudaSuccess && k < kernels; ++k) {
    const cudaGraphNode_t dep = node;
    err = add_kernel(&node, graph, k ? &dep : nullptr, k ? 1 : 0, reinterpret_cast<void*>(empty_kernel), dim3(1),
                     dim3(32), nullptr);
  }
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(err);
  }
  *out = graph;
  return 0;
}

extern "C" int nislam_graph_destroy(void* graph) {
  return graph ? static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph))) : 0;
}

// The trigger's and lm_step's launches that have run on this device (those
// inside graphs included): out[0] trigger, out[1] lm_step.
extern "C" int nislam_solve_device_launches(unsigned long long* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemcpyFromSymbol(out, trigger_launches, sizeof(*out));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out + 1, lm_step_launches, sizeof(*out));
  return static_cast<int>(err);
}

namespace {

Trigger make_trigger(void* ctl, void* count, const void* loop_slot, int pending, void* run, void* active,
                     void* mu, int lanes, float mu_init, float mu_max, int max_iterations, const void* gate,
                     int gate_stride) {
  Trigger p = {};
  p.ctl = static_cast<int*>(ctl);
  p.count = static_cast<int*>(count);
  p.loop_slot = static_cast<const int*>(loop_slot);
  p.pending = pending;
  p.run = static_cast<unsigned char*>(run);
  p.active = static_cast<unsigned char*>(active);
  p.mu = static_cast<float*>(mu);
  p.lanes = lanes;
  p.mu_init = mu_init;
  p.mu_max = mu_max;
  p.max_iterations = max_iterations;
  p.gate = static_cast<const float*>(gate);
  p.gate_stride = gate_stride;
  return p;
}

LMStep make_lm_step(void* ctl, void* mu, void* active, const void* accept, const void* small, int lanes,
                    float factor, float mu_min, float mu_max, int max_iterations) {
  LMStep p = {};
  p.ctl = static_cast<int*>(ctl);
  p.mu = static_cast<float*>(mu);
  p.active = static_cast<unsigned char*>(active);
  p.accept = static_cast<const unsigned char*>(accept);
  p.small = static_cast<const unsigned char*>(small);
  p.lanes = lanes;
  p.factor = factor;
  p.mu_min = mu_min;
  p.mu_max = mu_max;
  p.max_iterations = max_iterations;
  return p;
}

bool trigger_ok(const Trigger& p) {
  return p.ctl && p.count && p.loop_slot && p.run && p.active && p.mu && p.lanes >= 1 && p.lanes <= kMaxLanes &&
         p.pending >= 0 && p.gate_stride >= 0;
}

bool lm_step_ok(const LMStep& p) {
  return p.ctl && p.mu && p.active && p.accept && p.small && p.lanes >= 1 && p.lanes <= kMaxLanes;
}

// The solve program appended to `graph` after `dep` (null: first): the
// trigger kernel `p` setting an IF handle made on `graph`, and the IF node;
// in the IF body a clone of `setup`, then, unless `iteration` is null (the
// configuration stops the LM loop before its first iteration), the
// loop_begin kernel and a WHILE node on a handle made on the IF body, whose
// body is a clone of `iteration` and the lm_step kernel `q`; then a clone
// of `finish`.  Each conditional node is added to the graph that holds it
// (one inside a child graph node is refused).  Every node added is
// recorded in `rec` (null: none) → the IF node, the IF and WHILE bodies.
cudaError_t append_solve(cudaGraph_t graph, const cudaGraphNode_t* dep, Trigger p, LMStep q, cudaGraph_t setup,
                         cudaGraph_t iteration, cudaGraph_t finish, ChunkGraph* rec, cudaGraphNode_t* if_node,
                         cudaGraph_t* if_body, cudaGraph_t* loop_body) {
  cudaGraphConditionalHandle if_handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&if_handle, graph, 0, 0);
  cudaGraphNode_t trig, prev;
  if (err == cudaSuccess) {
    p.has_handle = 1;
    p.handle = if_handle;
    void* args[] = {&p};
    err = add_kernel(&trig, graph, dep, dep ? 1 : 0, reinterpret_cast<void*>(trigger_kernel), dim3(1), dim3(32),
                     args);
  }
  if (err == cudaSuccess) {
    record(rec, trig, kKernelNode);
    err = add_conditional(if_node, graph, &trig, 1, if_handle, cudaGraphCondTypeIf, 1, if_body);
  }
  if (err == cudaSuccess) {
    record(rec, *if_node, kConditionalNode, if_body, 1);
    err = cudaGraphAddChildGraphNode(&prev, *if_body, nullptr, 0, setup);
  }
  if (err == cudaSuccess) record(rec, prev, kChildNode);
  if (err == cudaSuccess && iteration != nullptr) {
    cudaGraphConditionalHandle loop;
    err = cudaGraphConditionalHandleCreate(&loop, *if_body, 0, 0);
    cudaGraphNode_t begin, node, child, step;
    if (err == cudaSuccess) {
      const int* words = p.ctl;
      void* args[] = {&words, &loop};
      err = add_kernel(&begin, *if_body, &prev, 1, reinterpret_cast<void*>(loop_begin_kernel), dim3(1), dim3(32),
                       args);
    }
    if (err == cudaSuccess) {
      record(rec, begin, kKernelNode);
      err = add_conditional(&node, *if_body, &begin, 1, loop, cudaGraphCondTypeWhile, 1, loop_body);
    }
    if (err == cudaSuccess) {
      record(rec, node, kConditionalNode, loop_body, 1);
      prev = node;
      err = cudaGraphAddChildGraphNode(&child, *loop_body, nullptr, 0, iteration);
    }
    if (err == cudaSuccess) {
      record(rec, child, kChildNode);
      q.has_handle = 1;
      q.handle = loop;
      void* args[] = {&q};
      err = add_kernel(&step, *loop_body, &child, 1, reinterpret_cast<void*>(lm_step_kernel), dim3(1), dim3(32),
                       args);
    }
    if (err == cudaSuccess) record(rec, step, kKernelNode);
  }
  if (err == cudaSuccess) {
    cudaGraphNode_t node;
    err = cudaGraphAddChildGraphNode(&node, *if_body, &prev, 1, finish);
    if (err == cudaSuccess) record(rec, node, kChildNode);
  }
  return err;
}

// The arguments of a solve program's builder, checked: the trigger's, the
// steps' graphs and lm_step's (unused without an iteration).
bool solve_ok(const Trigger& p, const LMStep& q, const void* setup, const void* iteration, const void* finish) {
  return trigger_ok(p) && setup != nullptr && finish != nullptr && (iteration == nullptr || lm_step_ok(q));
}

}  // namespace

// The trigger kernel on `stream`, outside a graph (no IF handle): the
// control words (ctl: kIterations + 1 int32), the run flags, the lane mask
// and mu of `lanes` lanes from their pending counts and (lanes, pending)
// loop slots; with a `gate` (lane l's loop_found at gate[l * gate_stride];
// null: none) the inline trigger: a lane runs only where it found no loop,
// and a gated lane that does not run has its pending count cleared.
// Returns a cudaError_t.
extern "C" int nislam_trigger_launch(void* ctl, void* count, const void* loop_slot, int pending, void* run,
                                     void* active, void* mu, int lanes, float mu_init, float mu_max,
                                     int max_iterations, const void* gate, int gate_stride, void* stream) {
  const Trigger p = make_trigger(ctl, count, loop_slot, pending, run, active, mu, lanes, mu_init, mu_max,
                                 max_iterations, gate, gate_stride);
  if (!trigger_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  trigger_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The lm_step kernel on `stream`, outside a graph (no WHILE handle).
extern "C" int nislam_lm_step_launch(void* ctl, void* mu, void* active, const void* accept, const void* small,
                                     int lanes, float factor, float mu_min, float mu_max, int max_iterations,
                                     void* stream) {
  const LMStep p = make_lm_step(ctl, mu, active, accept, small, lanes, factor, mu_min, mu_max, max_iterations);
  if (!lm_step_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  lm_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// A new solve graph: the solve program (append_solve) on a graph of its
// own, with the trigger kernel as nislam_trigger_launch takes it (a `gate`:
// the inline trigger's), the captured `setup`, `iteration` (null: no
// WHILE) and `finish` graphs (each a cudaGraph_t, cloned), and the
// lm_step kernel as nislam_lm_step_launch takes it.
extern "C" int nislam_sg_create(void** out, void* ctl, void* count, const void* loop_slot, int pending,
                                void* run, void* active, void* mu, int lanes, float mu_init, float mu_max,
                                int max_iterations, const void* gate, int gate_stride, void* setup,
                                void* iteration, void* finish, void* lm_ctl, void* lm_mu, void* lm_active,
                                const void* accept, const void* small, int lm_lanes, float factor, float mu_min,
                                float lm_mu_max, int lm_max_iterations) {
  const Trigger p = make_trigger(ctl, count, loop_slot, pending, run, active, mu, lanes, mu_init, mu_max,
                                 max_iterations, gate, gate_stride);
  const LMStep q = make_lm_step(lm_ctl, lm_mu, lm_active, accept, small, lm_lanes, factor, mu_min, lm_mu_max,
                                lm_max_iterations);
  if (out == nullptr || !solve_ok(p, q, setup, iteration, finish)) return static_cast<int>(cudaErrorInvalidValue);
  SolveGraph* g = new (std::nothrow) SolveGraph();
  if (g == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  cudaError_t err = cudaGraphCreate(&g->graph, 0);
  cudaGraphNode_t node;
  if (err == cudaSuccess) {
    err = append_solve(g->graph, nullptr, p, q, static_cast<cudaGraph_t>(setup), static_cast<cudaGraph_t>(iteration),
                       static_cast<cudaGraph_t>(finish), nullptr, &node, &g->body, &g->loop);
  }
  if (err != cudaSuccess) {
    if (g->graph) cudaGraphDestroy(g->graph);
    delete g;
    return static_cast<int>(err);
  }
  *out = g;
  return 0;
}

extern "C" int nislam_sg_instantiate(void* h) {
  SolveGraph* g = static_cast<SolveGraph*>(h);
  if (g == nullptr || g->exec != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphInstantiate(&g->exec, g->graph, 0));
}

// One trigger: the graph on `stream`.  Returns a cudaError_t.
extern "C" int nislam_sg_launch(void* h, void* stream) {
  SolveGraph* g = static_cast<SolveGraph*>(h);
  if (g == nullptr || g->exec == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(g->exec, static_cast<cudaStream_t>(stream)));
}

// The built graph's nodes, into out[0 .. 3): the outer graph's (the
// trigger, the IF), the IF body's (children and the WHILE), the WHILE
// body's (the iteration and lm_step), each read back from the graph; with
// n >= 4, out[3] the GN-CG trigger's CG WHILE body's.
extern "C" int nislam_sg_describe(void* h, int* out, int n) {
  SolveGraph* g = static_cast<SolveGraph*>(h);
  if (g == nullptr || out == nullptr || n < 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graphs[4] = {g->graph, g->body, g->loop, g->inner};
  for (int k = 0; k < (n < 4 ? 3 : 4); ++k) {
    size_t count = 0;
    if (graphs[k] != nullptr) {
      const cudaError_t err = cudaGraphGetNodes(graphs[k], nullptr, &count);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    out[k] = static_cast<int>(count);
  }
  return 0;
}

extern "C" int nislam_sg_destroy(void* h) {
  SolveGraph* g = static_cast<SolveGraph*>(h);
  if (g == nullptr) return 0;
  cudaError_t err = cudaSuccess;
  if (g->exec) err = cudaGraphExecDestroy(g->exec);
  if (g->graph) {
    const cudaError_t e = cudaGraphDestroy(g->graph);
    if (err == cudaSuccess) err = e;
  }
  delete g;
  return static_cast<int>(err);
}

// The single engine's inline trigger, appended to its stored SWITCH body
// after the branch child (nislam_cg_add_switch made that body): the solve
// program (append_solve) with the arguments that nislam_sg_create takes,
// its trigger gated.
extern "C" int nislam_cg_add_inline(void* h, void* ctl, void* count, const void* loop_slot, int pending,
                                    void* run, void* active, void* mu, int lanes, float mu_init, float mu_max,
                                    int max_iterations, const void* gate, int gate_stride, void* setup,
                                    void* iteration, void* finish, void* lm_ctl, void* lm_mu, void* lm_active,
                                    const void* accept, const void* small, int lm_lanes, float factor, float mu_min,
                                    float lm_mu_max, int lm_max_iterations) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  const Trigger p = make_trigger(ctl, count, loop_slot, pending, run, active, mu, lanes, mu_init, mu_max,
                                 max_iterations, gate, gate_stride);
  const LMStep q = make_lm_step(lm_ctl, lm_mu, lm_active, accept, small, lm_lanes, factor, mu_min, lm_mu_max,
                                lm_max_iterations);
  if (g == nullptr || g->exec != nullptr || g->stored_body == nullptr || g->if_body != nullptr ||
      gate == nullptr || !solve_ok(p, q, setup, iteration, finish)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGraphNode_t node;
  const cudaError_t err = append_solve(g->stored_body, &g->stored_tail, p, q, static_cast<cudaGraph_t>(setup),
                                       static_cast<cudaGraph_t>(iteration), static_cast<cudaGraph_t>(finish), g,
                                       &node, &g->if_body, &g->loop_body);
  if (err == cudaSuccess) g->stored_tail = node;
  return static_cast<int>(err);
}

// The cg_step kernel on `stream`, outside a graph (no WHILE handle): one
// start or step (`mode`, CGMode) of the GN-CG loops over the control words
// `ctl` (kCgTotal + 1 int32) and the CG's ||r||^2 `r2` (one float).
extern "C" int nislam_cg_step_launch(void* ctl, const void* r2, int mode, int cg_iterations, int outer_iterations,
                                     double tol2, void* stream) {
  if (ctl == nullptr || r2 == nullptr || mode < kGnBegin || mode > kCgStep) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CGStep q = {};
  q.ctl = static_cast<int*>(ctl);
  q.r2 = static_cast<const float*>(r2);
  q.mode = mode;
  q.cg_iterations = cg_iterations;
  q.outer_iterations = outer_iterations;
  q.tol2 = tol2;
  cg_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(q);
  return static_cast<int>(cudaGetLastError());
}

// The cg_step kernel's launches that have run on this device (those
// inside graphs included).
extern "C" int nislam_cg_step_device_launches(unsigned long long* out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyFromSymbol(out, cg_step_launches, sizeof(*out)));
}

namespace {

// A cg_step node of `mode` setting `handle`, in `graph` after `dep`.
cudaError_t add_cg_step(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, CGStep q, int mode,
                        cudaGraphConditionalHandle handle) {
  q.mode = mode;
  q.has_handle = 1;
  q.handle = handle;
  void* args[] = {&q};
  return add_kernel(node, graph, dep, dep ? 1 : 0, reinterpret_cast<void*>(cg_step_kernel), dim3(1), dim3(32),
                    args);
}

// A child node of `child` (cloned) in `graph` after `dep`.
cudaError_t add_child(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, cudaGraph_t child) {
  return cudaGraphAddChildGraphNode(node, graph, dep, dep ? 1 : 0, child);
}

}  // namespace

// The distributed engine's deferred trigger as ONE graph launch, the
// counterpart of JAX's maybe_optimize around solve_pose_graph_cg
// (nislam_tpu/core/slam.py, nislam_tpu/parallel/solver.py: one shard_map
// whose fori_loop over the Gauss-Newton steps holds a CG lax.while_loop,
// its psum and its stop test on the device), for a group whose all-reduce
// PyTorch captures into nodes that a conditional body holds (the port's
// peer all-reduce, csrc/all_reduce.cu: one kernel node at any rank count):
//
//   trigger       the solve graph's kernel, one lane: run = >= 2 live
//                 pending matches; the IF handle = run
//   IF:                                       (handle on the outer graph)
//     child       setup: the masked pending-edge loop, the problem, this
//                 rank's edge block, its scatter plan, the free mask, x0
//     cg_step     gn = 0; the Gauss-Newton WHILE handle = gn < outer
//     WHILE:                                  (handle on the IF body)
//       child     the rank's gradient and JtJ diagonal, their all-reduce,
//                 the CG's start (||r||^2 among it)
//       cg_step   it = 0; the CG WHILE handle = it < cg && r2 > tol2
//       WHILE:                                (handle on the GN body)
//         child   the rank's JtJ p, its all-reduce, the CG update
//         cg_step it + 1 (the count that only grows + 1); the handle again
//       child     advance: the poses moved by x
//       cg_step   gn + 1 (the count that only grows + 1); the handle again
//     child       finish: the cost and its all-reduce, the poses, the
//                 pending count, the chain (with the online canvas: this
//                 rank's masked recompute, the delta's all-reduce, the copy)
//
// The stop tests read only all-reduced values, so every rank leaves each
// loop at the same iteration.  `setup` .. `finish` are PyTorch's captures
// (cudaGraph_t, cloned); the trigger's arguments are nislam_trigger_launch's;
// `r2` the one float that the head and iteration children write.
extern "C" int nislam_tg_create(void** out, void* ctl, void* count, const void* loop_slot, int pending, void* run,
                                void* active, void* mu, int lanes, float mu_init, float mu_max, int max_iterations,
                                const void* gate, int gate_stride, void* setup, void* head, void* iteration,
                                void* advance, void* finish, const void* r2, int cg_iterations, int outer_iterations,
                                double tol2) {
  Trigger p = make_trigger(ctl, count, loop_slot, pending, run, active, mu, lanes, mu_init, mu_max, max_iterations,
                           gate, gate_stride);
  if (out == nullptr || !trigger_ok(p) || lanes != 1 || gate != nullptr || setup == nullptr || head == nullptr ||
      iteration == nullptr || advance == nullptr || finish == nullptr || r2 == nullptr || outer_iterations < 1 ||
      cg_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CGStep q = {};
  q.ctl = static_cast<int*>(ctl);
  q.r2 = static_cast<const float*>(r2);
  q.cg_iterations = cg_iterations;
  q.outer_iterations = outer_iterations;
  q.tol2 = tol2;
  SolveGraph* g = new (std::nothrow) SolveGraph();
  if (g == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  cudaError_t err = cudaGraphCreate(&g->graph, 0);
  cudaGraphConditionalHandle if_handle, gn_handle, cg_handle;
  cudaGraphNode_t trig, if_node, prev, node, gn_node, cg_node;
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&if_handle, g->graph, 0, 0);
  if (err == cudaSuccess) {
    p.has_handle = 1;
    p.handle = if_handle;
    void* args[] = {&p};
    err = add_kernel(&trig, g->graph, nullptr, 0, reinterpret_cast<void*>(trigger_kernel), dim3(1), dim3(32), args);
  }
  if (err == cudaSuccess) err = add_conditional(&if_node, g->graph, &trig, 1, if_handle, cudaGraphCondTypeIf, 1, &g->body);
  // The IF body: setup, the Gauss-Newton loop, finish.
  if (err == cudaSuccess) err = add_child(&prev, g->body, nullptr, static_cast<cudaGraph_t>(setup));
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&gn_handle, g->body, 0, 0);
  if (err == cudaSuccess) err = add_cg_step(&node, g->body, &prev, q, kGnBegin, gn_handle);
  if (err == cudaSuccess) {
    err = add_conditional(&gn_node, g->body, &node, 1, gn_handle, cudaGraphCondTypeWhile, 1, &g->loop);
  }
  if (err == cudaSuccess) err = add_child(&node, g->body, &gn_node, static_cast<cudaGraph_t>(finish));
  // The Gauss-Newton body: head, the CG loop, advance, the step.
  if (err == cudaSuccess) err = add_child(&prev, g->loop, nullptr, static_cast<cudaGraph_t>(head));
  if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&cg_handle, g->loop, 0, 0);
  if (err == cudaSuccess) err = add_cg_step(&node, g->loop, &prev, q, kCgBegin, cg_handle);
  if (err == cudaSuccess) {
    err = add_conditional(&cg_node, g->loop, &node, 1, cg_handle, cudaGraphCondTypeWhile, 1, &g->inner);
  }
  if (err == cudaSuccess) err = add_child(&prev, g->loop, &cg_node, static_cast<cudaGraph_t>(advance));
  if (err == cudaSuccess) err = add_cg_step(&node, g->loop, &prev, q, kGnStep, gn_handle);
  // The CG body: the iteration, the step.
  if (err == cudaSuccess) err = add_child(&prev, g->inner, nullptr, static_cast<cudaGraph_t>(iteration));
  if (err == cudaSuccess) err = add_cg_step(&node, g->inner, &prev, q, kCgStep, cg_handle);
  if (err != cudaSuccess) {
    if (g->graph) cudaGraphDestroy(g->graph);
    delete g;
    return static_cast<int>(err);
  }
  *out = g;
  return 0;
}
