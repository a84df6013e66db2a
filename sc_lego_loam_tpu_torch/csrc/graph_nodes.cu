// Host helpers beside the kernels for graphs.py: CUDA-graph conditional
// (IF) nodes captured from a stream, and the node count of a graph.  They
// replace no TPU kernel: they are the CUDA-graph counterpart of the JAX
// package's lax.cond on a device flag (the loop tick's gates, the pose
// graph's per-iteration convergence), for a torch without
// CUDAGraph.begin_capture_to_if_node.  One device kernel, set_condition
// (one thread: it reads the predicate and sets the node's handle), bound
// by its launch.
//
// graph_cond_begin, on a stream being captured: a conditional handle on
// the graph under capture, set_condition captured on the stream, an IF
// node after the stream's current dependencies (which become the node),
// and the body stream begun capturing into the node's body graph.
// graph_cond_end ends that capture and counts the body's nodes by type.
// Needs CUDA 12.4 or later.
//
// probe (one thread), the device half of the engine's tracer (graphs.probe,
// utils/profiling.py): captured into the step graphs always, it returns at
// once while its int32 on-flag is 0; otherwise it takes the next slot of a
// record buffer with atomicAdd and writes (%globaltimer ns, site id << 32 |
// the bits of one float32 value) there, the value read at run time through
// a pointer (kind 0: none, 1: bool, 2: int32, 3: float32, 4: two bools as
// a + 2 b).  A full buffer takes no record; the head counts on,
// so that the drops can be told.  taken, when set, is the effective
// predicate of the gates around an eagerly run ("select") body: the probe
// records only where it holds.

#include <cuda_runtime.h>

#include <cstddef>
#include <vector>

extern "C" int graph_node_count(void* graph, unsigned long long* out) {
  size_t n = 0;
  const cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *out = static_cast<unsigned long long>(n);
  return static_cast<int>(err);
}

// out[t] += the nodes of type t (cudaGraphNodeType, t < n_types).
extern "C" int graph_node_types(void* graph, unsigned long long* out,
                                int n_types) {
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    const int t = static_cast<int>(type);
    if (err == cudaSuccess && t >= 0 && t < n_types) out[t] += 1;
  }
  return static_cast<int>(err);
}

extern "C" int graph_stream_create(void** out) {
  cudaStream_t stream = nullptr;
  const cudaError_t err =
      cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  *out = stream;
  return static_cast<int>(err);
}

__global__ void probe(const int* on, long long* ring, int* head, int cap,
                      int site, const void* value, int kind,
                      const bool* taken) {
  if (*on == 0) return;
  if (taken != nullptr && !*taken) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  float v = 0.0f;
  switch (kind) {
    case 1: v = *static_cast<const bool*>(value) ? 1.0f : 0.0f; break;
    case 2: v = static_cast<float>(*static_cast<const int*>(value)); break;
    case 3: v = *static_cast<const float*>(value); break;
    case 4: {
      const bool* b = static_cast<const bool*>(value);
      v = (b[0] ? 1.0f : 0.0f) + (b[1] ? 2.0f : 0.0f);
      break;
    }
    default: break;
  }
  const int slot = atomicAdd(head, 1);
  if (slot >= cap) return;
  ring[2 * slot] = static_cast<long long>(t);
  ring[2 * slot + 1] = static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned int>(site)) << 32)
      | __float_as_uint(v));
}

extern "C" int graph_probe(void* stream, const void* on, void* ring,
                           void* head, int cap, int site, const void* value,
                           int kind, const void* taken) {
  probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(on), static_cast<long long*>(ring),
      static_cast<int*>(head), cap, site, value, kind,
      static_cast<const bool*>(taken));
  return static_cast<int>(cudaGetLastError());
}

#if CUDART_VERSION >= 12040

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

#define GRAPH_TRY(call)                        \
  do {                                         \
    const cudaError_t e_ = (call);             \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

extern "C" int graph_cond_begin(void* parent, const void* pred, void* body,
                                int capture_mode) {
  cudaStream_t stream = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  GRAPH_TRY(cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps,
                                     &n_deps));
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  cudaGraphConditionalHandle handle;
  GRAPH_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 0, 0));
  set_condition<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  GRAPH_TRY(cudaGetLastError());
  GRAPH_TRY(cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps,
                                     &n_deps));
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  GRAPH_TRY(cudaGraphAddNode(&node, graph, deps, n_deps, &params));
  GRAPH_TRY(cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies));
  GRAPH_TRY(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(capture_mode)));
  return 0;
}

// Ends the body's capture; nodes[t] += its nodes of type t (n_types), or,
// with n_types 0, nodes[0] = its node count.  (The caller asks for types
// only of a body without conditional nodes of its own: on the H100's
// CUDA 12.8 stack, cudaGraphNodeGetType on a conditional node fails with
// cudaErrorUnknown.)
extern "C" int graph_cond_end(void* body, unsigned long long* nodes,
                              int n_types) {
  cudaGraph_t graph = nullptr;
  GRAPH_TRY(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
  if (n_types == 0) return graph_node_count(graph, nodes);
  return graph_node_types(graph, nodes, n_types);
}

#else

extern "C" int graph_cond_begin(void*, const void*, void*, int) {
  return static_cast<int>(cudaErrorNotSupported);
}

extern "C" int graph_cond_end(void*, unsigned long long*, int) {
  return static_cast<int>(cudaErrorNotSupported);
}

#endif
