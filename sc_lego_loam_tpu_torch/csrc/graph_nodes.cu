// Host helper beside the kernels: the number of nodes of a captured CUDA
// graph (graphs.py reports it for each step graph).  No device code.

#include <cuda_runtime.h>

#include <cstddef>

extern "C" int graph_node_count(void* graph, unsigned long long* out) {
  size_t n = 0;
  const cudaError_t err =
      cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  *out = static_cast<unsigned long long>(n);
  return static_cast<int>(err);
}
