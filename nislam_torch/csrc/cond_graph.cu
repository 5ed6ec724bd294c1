// A chunk of tracked frames as ONE CUDA graph launch, for Hopper (sm_90a):
// a WHILE conditional node over the frames, whose body nests the graphs
// that PyTorch captured (the track graph; the keyframe branch graphs under
// IF conditional nodes), built through the CUDA runtime's conditional-node
// API (CUDA >= 12.4).
//
// Counterpart of JAX's SlamEngine.run_chunk (nislam_tpu/core/slam.py,
// one jitted lax.scan whose step runs the keyframe branch as lax.cond):
// the chunk makes no host read between its frames.  The graph is
//
//   WHILE loop:                               (handle on the outer graph)
//     copy_in     frame i's features -> the track graph's inputs
//     child       the track graph (its captured cudaGraph_t, cloned)
//     flags       [insert, stored] of each lane -> the IF handles; sets
//                 stop when a lane needs a branch kind the graph lacks
//     IF slot s:  child (lane s/2's branch graph of kind s%2), count
//     ...         one IF per (lane, kind) that the graph holds, in order
//     advance     unless stop: the packed output -> row i of the chunk's
//                 output, i += 1; loop = !stop && i < n
//
// over a control block of int32 words that the caller owns (the layout
// below; nislam_torch/core/chunk_graph.py mirrors it): the frame index,
// the end, the stop flag, the frames done, one run count per IF slot, and
// the chunk's table (feature sources and strides, the output), which
// nislam_cg_launch writes with one small kernel before the graph launch.
// The host reads the block once, after the chunk.
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
//  - an IF handle nested in the WHILE body is created on the body graph,
//    the graph that holds its conditional node; the WHILE handle on the
//    outer graph;
//  - the WHILE handle starts each launch at 1 (cudaGraphCondAssignDefault,
//    default 1): the caller launches only a chunk with a frame to run,
//    and the advance kernel sets it after every frame.  The IF handles are
//    set by the flags kernel in every iteration.
//
// Bound: per frame, the copy of the features (read once, written once:
// 7.6 MB at 480x640 with its 720x480 polar grid, 2.3 us at 3.35 TB/s) and
// a few hundred bytes of control; the WHILE iteration and the IF nodes
// cost the card what a launch does, which the empty-body chunk graph
// (nislam_cg_empty_graph) measures.  The copy is a grid-stride loop of
// 16-byte loads and stores (bytes otherwise).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <new>

namespace {

constexpr int kMaxLanes = 32;
constexpr int kMaxSlots = 2 * kMaxLanes;  // IF slots: lane * 2 + (0 stored, 1 dropped)
constexpr int kSegments = 3;               // img_u, fft, polar
constexpr int kCopyBlocks = 264;           // two blocks of 256 on each of the H100's 132 SMs
constexpr int kThreads = 256;

// The control block, in int32 words.
constexpr int kI = 0;     // the frame the body runs
constexpr int kN = 1;     // the chunk's end (exclusive)
constexpr int kStop = 2;  // 1: frame kI needs a branch kind the graph lacks
constexpr int kDone = 3;  // frames completed in this launch
constexpr int kRuns = 4;  // kMaxSlots run counts
constexpr int kTable = kRuns + kMaxSlots;  // 8-byte aligned: the Table below

struct Table {
  long long src[kSegments];     // frame 0's features (device addresses)
  long long stride[kSegments];  // bytes from one frame to the next
  long long out;                // the chunk's packed output (float)
  long long out_lane;           // floats from one lane's rows to the next
};
static_assert(kTable % 2 == 0, "the table needs 8-byte alignment");

__device__ __forceinline__ const Table* table(const int* ctl) {
  return reinterpret_cast<const Table*>(ctl + kTable);
}

struct CopyIn {
  const int* ctl;
  char* dst[kSegments];
  long long bytes[kSegments];
};

struct Flags {
  int* ctl;
  const unsigned char* flags;  // (lanes, 2) bool: insert, stored
  int lanes;
  unsigned long long have;  // bit s: the graph holds IF slot s
  cudaGraphConditionalHandle handle[kMaxSlots];
};

struct Advance {
  int* ctl;
  const float* packed;  // (lanes, width)
  int lanes;
  int width;
  cudaGraphConditionalHandle loop;
};

__global__ void begin_kernel(int* ctl, int i0, int n, Table t) {
  const int k = threadIdx.x;
  if (k == 0) {
    ctl[kI] = i0;
    ctl[kN] = n;
    ctl[kStop] = 0;
    ctl[kDone] = 0;
    *reinterpret_cast<Table*>(ctl + kTable) = t;
  }
  for (int s = k; s < kMaxSlots; s += blockDim.x) ctl[kRuns + s] = 0;
}

__global__ void __launch_bounds__(kThreads) copy_in_kernel(CopyIn p) {
  const Table* t = table(p.ctl);
  const long long i = p.ctl[kI];
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
#pragma unroll
  for (int s = 0; s < kSegments; ++s) {
    const long long n = p.bytes[s];
    if (n == 0) continue;
    const char* src = reinterpret_cast<const char*>(t->src[s]) + i * t->stride[s];
    char* dst = p.dst[s];
    if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) | n) & 15) == 0) {
      const uint4* s4 = reinterpret_cast<const uint4*>(src);
      uint4* d4 = reinterpret_cast<uint4*>(dst);
      for (long long q = tid; q < n / 16; q += step) d4[q] = __ldg(s4 + q);
    } else {
      for (long long q = tid; q < n; q += step) dst[q] = src[q];
    }
  }
}

__global__ void flags_kernel(Flags p) {
  if (threadIdx.x != 0) return;
  int stop = 0;
  for (int l = 0; l < p.lanes; ++l) {
    const int slot = 2 * l + (p.flags[2 * l + 1] ? 0 : 1);
    if (p.flags[2 * l] && !((p.have >> slot) & 1ull)) stop = 1;
  }
  p.ctl[kStop] = stop;
  for (int l = 0; l < p.lanes; ++l) {
    const bool insert = p.flags[2 * l] != 0;
    const bool stored = p.flags[2 * l + 1] != 0;
    for (int k = 0; k < 2; ++k) {
      const int slot = 2 * l + k;
      if ((p.have >> slot) & 1ull) {
        cudaGraphSetConditional(p.handle[slot], !stop && insert && (stored == (k == 0)));
      }
    }
  }
}

__global__ void count_kernel(int* ctl, int slot) {
  if (threadIdx.x == 0) ctl[kRuns + slot] += 1;
}

__global__ void __launch_bounds__(kThreads) advance_kernel(Advance p) {
  const int i = p.ctl[kI];
  const int stop = p.ctl[kStop];
  if (!stop) {
    const Table* t = table(p.ctl);
    float* out = reinterpret_cast<float*>(t->out);
    for (int q = threadIdx.x; q < p.lanes * p.width; q += blockDim.x) {
      const int lane = q / p.width;
      out[lane * t->out_lane + static_cast<long long>(i) * p.width + q % p.width] = p.packed[q];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!stop) {
      p.ctl[kI] = i + 1;
      p.ctl[kDone] += 1;
    }
    cudaGraphSetConditional(p.loop, !stop && i + 1 < p.ctl[kN]);
  }
}

__global__ void empty_kernel() {}

struct ChunkGraph {
  cudaGraph_t graph = nullptr;  // the outer graph: the WHILE node
  cudaGraph_t body = nullptr;   // the WHILE body (owned by the graph)
  cudaGraphConditionalHandle loop = 0;
  cudaGraphNode_t tail = nullptr;  // the body's last node: the next one depends on it
  int* ctl = nullptr;
  int lanes = 0;
  unsigned long long have = 0;
  cudaGraphConditionalHandle handle[kMaxSlots] = {};
  cudaGraphExec_t exec = nullptr;
};

// Appends a node made by `add` to the body's chain.
template <typename Add>
int chain(ChunkGraph* g, Add add) {
  cudaGraphNode_t node;
  const cudaGraphNode_t* dep = g->tail ? &g->tail : nullptr;
  const cudaError_t err = add(&node, dep, g->tail ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  g->tail = node;
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

// A conditional node of `type` on `handle` in `graph` after `dep`; its
// body graph in *body.
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep, size_t ndep,
                            cudaGraphConditionalHandle handle, cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams c = {};
  c.type = cudaGraphNodeTypeConditional;
  c.conditional.handle = handle;
  c.conditional.type = type;
  c.conditional.size = 1;
  const cudaError_t err = cudaGraphAddNode(node, graph, dep, ndep, &c);
  if (err == cudaSuccess) *body = c.conditional.phGraph_out[0];
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

}  // namespace

// The node types of `graph` (a cudaGraph_t), child graphs walked: counts[t]
// += the nodes of cudaGraphNodeType t, for t < ntypes - 1; counts[ntypes -
// 1] the nodes of any later type.  Returns a cudaError_t.
extern "C" int nislam_graph_node_types(void* graph, int* counts, int ntypes) {
  if (graph == nullptr || counts == nullptr || ntypes < 2) return static_cast<int>(cudaErrorInvalidValue);
  return count_types(static_cast<cudaGraph_t>(graph), counts, ntypes);
}

// A new chunk graph over the control block `ctl` (device, int32) for
// `lanes` lanes: the outer graph and its WHILE node, with an empty body.
extern "C" int nislam_cg_create(void** out, void* ctl, int lanes) {
  if (out == nullptr || ctl == nullptr || lanes < 1 || lanes > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ChunkGraph* g = new (std::nothrow) ChunkGraph();
  if (g == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  g->ctl = static_cast<int*>(ctl);
  g->lanes = lanes;
  cudaError_t err = cudaGraphCreate(&g->graph, 0);
  if (err == cudaSuccess) {
    err = cudaGraphConditionalHandleCreate(&g->loop, g->graph, 1, cudaGraphCondAssignDefault);
  }
  cudaGraphNode_t node;
  if (err == cudaSuccess) {
    err = add_conditional(&node, g->graph, nullptr, 0, g->loop, cudaGraphCondTypeWhile, &g->body);
  }
  if (err != cudaSuccess) {
    if (g->graph) cudaGraphDestroy(g->graph);
    delete g;
    return static_cast<int>(err);
  }
  *out = g;
  return 0;
}

// The body's copy of frame i's features: bytes[s] bytes into dst[s] from
// the table's src[s] + i * stride[s] (a zero size copies nothing).
extern "C" int nislam_cg_add_copy_in(void* h, void* d0, long long b0, void* d1, long long b1, void* d2,
                                     long long b2) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || b0 < 0 || b1 < 0 || b2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  CopyIn p = {g->ctl, {static_cast<char*>(d0), static_cast<char*>(d1), static_cast<char*>(d2)}, {b0, b1, b2}};
  void* args[] = {&p};
  return chain(g, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_kernel(n, g->body, d, nd, reinterpret_cast<void*>(copy_in_kernel), dim3(kCopyBlocks),
                      dim3(kThreads), args);
  });
}

// The body's child graph node: a clone of `child` (a cudaGraph_t).
extern "C" int nislam_cg_add_child(void* h, void* child) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || child == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chain(g, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return cudaGraphAddChildGraphNode(n, g->body, d, nd, static_cast<cudaGraph_t>(child));
  });
}

// The body's flag kernel over `flags` ((lanes, 2) bool on the device),
// and one IF handle for each slot s whose bit is set in `have` (slot s:
// lane s / 2, kind s % 2, 0 stored and 1 dropped).  The IF nodes follow
// (nislam_cg_add_branch), one per handle.
extern "C" int nislam_cg_add_flags(void* h, const void* flags, unsigned long long have) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || flags == nullptr || g->have != 0 ||
      (2 * g->lanes < 64 && (have >> (2 * g->lanes)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < 2 * g->lanes; ++s) {
    if ((have >> s) & 1ull) {
      const cudaError_t err = cudaGraphConditionalHandleCreate(&g->handle[s], g->body, 0,
                                                               cudaGraphCondAssignDefault);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  g->have = have;
  Flags p = {};
  p.ctl = g->ctl;
  p.flags = static_cast<const unsigned char*>(flags);
  p.lanes = g->lanes;
  p.have = have;
  std::memcpy(p.handle, g->handle, sizeof(p.handle));
  void* args[] = {&p};
  return chain(g, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_kernel(n, g->body, d, nd, reinterpret_cast<void*>(flags_kernel), dim3(1), dim3(32), args);
  });
}

// The IF node of slot `slot` (its handle made by nislam_cg_add_flags): its
// body a clone of `child` (a cudaGraph_t), then the slot's run count.
extern "C" int nislam_cg_add_branch(void* h, int slot, void* child) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || child == nullptr || slot < 0 || slot >= 2 * g->lanes || !((g->have >> slot) & 1ull)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaGraph_t body = nullptr;
  int err = chain(g, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_conditional(n, g->body, d, nd, g->handle[slot], cudaGraphCondTypeIf, &body);
  });
  if (err != 0) return err;
  cudaGraphNode_t inner, count;
  cudaError_t e = cudaGraphAddChildGraphNode(&inner, body, nullptr, 0, static_cast<cudaGraph_t>(child));
  if (e != cudaSuccess) return static_cast<int>(e);
  int* ctl = g->ctl;
  void* args[] = {&ctl, &slot};
  return static_cast<int>(add_kernel(&count, body, &inner, 1, reinterpret_cast<void*>(count_kernel), dim3(1),
                                     dim3(32), args));
}

// The body's last node: the packed output ((lanes, width) floats at
// `packed`) into row i of the table's output, i += 1, the WHILE handle.
extern "C" int nislam_cg_add_advance(void* h, const void* packed, int width) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || packed == nullptr || width < 1) return static_cast<int>(cudaErrorInvalidValue);
  Advance p = {g->ctl, static_cast<const float*>(packed), g->lanes, width, g->loop};
  void* args[] = {&p};
  return chain(g, [&](cudaGraphNode_t* n, const cudaGraphNode_t* d, size_t nd) {
    return add_kernel(n, g->body, d, nd, reinterpret_cast<void*>(advance_kernel), dim3(1), dim3(kThreads), args);
  });
}

extern "C" int nislam_cg_instantiate(void* h) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || g->exec != nullptr || g->tail == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphInstantiate(&g->exec, g->graph, 0));
}

// Frames [i0, n) on `stream`: one kernel that writes the control block
// (the table: the features of frame 0 at src0..2, `stride0..2` bytes
// apart; the output at `out`, `out_lane` floats between lanes), then the
// graph.  Returns the first cudaError_t.
extern "C" int nislam_cg_launch(void* h, int i0, int n, void* src0, long long stride0, void* src1,
                                long long stride1, void* src2, long long stride2, void* out, long long out_lane,
                                void* stream) {
  ChunkGraph* g = static_cast<ChunkGraph*>(h);
  if (g == nullptr || g->exec == nullptr || i0 < 0 || i0 >= n || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t = {{reinterpret_cast<long long>(src0), reinterpret_cast<long long>(src1),
              reinterpret_cast<long long>(src2)},
             {stride0, stride1, stride2},
             reinterpret_cast<long long>(out),
             out_lane};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  begin_kernel<<<1, 64, 0, s>>>(g->ctl, i0, n, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGraphLaunch(g->exec, s));
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

// A graph of one empty kernel node: a body that costs what a node does.
extern "C" int nislam_cg_empty_graph(void** out) {
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaGraph_t graph;
  cudaError_t err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t node;
  err = add_kernel(&node, graph, nullptr, 0, reinterpret_cast<void*>(empty_kernel), dim3(1), dim3(32), nullptr);
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
