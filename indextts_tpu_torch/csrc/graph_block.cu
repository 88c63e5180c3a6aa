// A decode loop's block of steps as one CUDA graph: the port of the device
// side of lax.while_loop (indextts_tpu/models/gpt_decode.py:542, :971, :1312,
// :1569; indextts_tpu/models/gpt_slots.py:316), whose condition JAX evaluates
// on the device between iterations.
//
// The block is assembled from two graphs captured by PyTorch on the loop's
// static buffers (graphs.py): `head`, which zeroes the block's step counter
// and evaluates the loop's condition, and `step`, one iteration followed by
// the counter's increment and the condition evaluated again. The block is
//
//   head -> [pred_0 -> IF(step)] -> [pred_1 -> IF(step)] -> ... (k times)
//
// pred_j is a one-thread kernel that sets the IF node's conditional handle
// from the control buffer `status` (int64 [2]: steps run in this block, the
// condition) and `budget` (int64 [1], the steps the host allows this block):
// step j runs iff the steps before it ran, it is inside the budget and the
// condition holds, so the steps after a stop are skipped on the card, as the
// while_loop skips them. Every IF body is a child-graph copy of the same
// `step`: the copies read and write the same addresses (the temporaries of
// one step, in the capture's memory pool), which is safe because they run
// one after another.
//
// A conditional body takes only kernel, memcpy, memset, empty, child-graph
// and conditional nodes. A step captured on a mesh over NCCL holds event
// nodes besides its collectives' kernels: PyTorch's ProcessGroupNCCL records
// an external event after each collective it captures and waits on one. The
// block runs on one stream and nothing waits on those events, so the body is
// a copy of the step with each event node replaced by edges from its
// dependencies to its dependents (strip_event_nodes): the order the step's
// nodes keep among themselves stays. A step without event nodes is copied
// unchanged.
//
// Plain C interface (no PyTorch headers): graphs.py passes the captured
// graphs' cudaGraph_t handles (torch.cuda.CUDAGraph(keep_graph=True)
// .raw_cuda_graph()) and the buffers' device addresses. Conditional nodes
// need CUDA 12.4 or later in the runtime and the driver.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void block_predicate_kernel(cudaGraphConditionalHandle handle, const long long* status,
                                       const long long* budget) {
  cudaGraphSetConditional(handle, (status[0] < budget[0] && status[1] != 0) ? 1u : 0u);
}

// the call that failed last in this thread, for the caller's message
thread_local const char* last_failed = "";

#if CUDART_VERSION >= 13000
cudaError_t dependencies(cudaGraphNode_t n, cudaGraphNode_t* out, size_t* count) {
  return cudaGraphNodeGetDependencies(n, out, nullptr, count);
}
cudaError_t dependents(cudaGraphNode_t n, cudaGraphNode_t* out, size_t* count) {
  return cudaGraphNodeGetDependentNodes(n, out, nullptr, count);
}
cudaError_t add_edge(cudaGraph_t g, cudaGraphNode_t from, cudaGraphNode_t to) {
  return cudaGraphAddDependencies(g, &from, &to, nullptr, 1);
}
#else
cudaError_t dependencies(cudaGraphNode_t n, cudaGraphNode_t* out, size_t* count) {
  return cudaGraphNodeGetDependencies(n, out, count);
}
cudaError_t dependents(cudaGraphNode_t n, cudaGraphNode_t* out, size_t* count) {
  return cudaGraphNodeGetDependentNodes(n, out, count);
}
cudaError_t add_edge(cudaGraph_t g, cudaGraphNode_t from, cudaGraphNode_t to) {
  return cudaGraphAddDependencies(g, &from, &to, 1);
}
#endif

#define STRIP_CHECK(call)         \
  do {                            \
    cudaError_t e_ = (call);      \
    if (e_ != cudaSuccess) {      \
      last_failed = #call;        \
      return e_;                  \
    }                             \
  } while (0)

// The nodes a node depends on (incoming) or that depend on it (outgoing).
cudaError_t edges(cudaGraphNode_t n, bool incoming, std::vector<cudaGraphNode_t>* out) {
  size_t count = 0;
  STRIP_CHECK(incoming ? dependencies(n, nullptr, &count) : dependents(n, nullptr, &count));
  out->resize(count);
  if (count > 0) STRIP_CHECK(incoming ? dependencies(n, out->data(), &count) : dependents(n, out->data(), &count));
  return cudaSuccess;
}

// Replaces every event record and event wait node of g, and of the child
// graphs inside it, by edges from the node's dependencies to its dependents.
cudaError_t strip_event_nodes(cudaGraph_t g) {
  size_t n = 0;
  STRIP_CHECK(cudaGraphGetNodes(g, nullptr, &n));
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) STRIP_CHECK(cudaGraphGetNodes(g, nodes.data(), &n));
  std::vector<cudaGraphNode_t> in, out, later;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    STRIP_CHECK(cudaGraphNodeGetType(node, &type));
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      STRIP_CHECK(cudaGraphChildGraphNodeGetGraph(node, &child));
      cudaError_t e = strip_event_nodes(child);
      if (e != cudaSuccess) return e;
      continue;
    }
    if (type != cudaGraphNodeTypeEventRecord && type != cudaGraphNodeTypeWaitEvent) continue;
    cudaError_t e = edges(node, true, &in);
    if (e == cudaSuccess) e = edges(node, false, &out);
    if (e != cudaSuccess) return e;
    for (cudaGraphNode_t from : in) {
      e = edges(from, false, &later);
      if (e != cudaSuccess) return e;
      for (cudaGraphNode_t to : out) {
        bool linked = false;
        for (cudaGraphNode_t x : later) linked = linked || x == to;
        if (!linked) STRIP_CHECK(add_edge(g, from, to));
      }
    }
    STRIP_CHECK(cudaGraphDestroyNode(node));
  }
  return cudaSuccess;
}

}  // namespace

#define BLOCK_CHECK(call)                          \
  do {                                             \
    cudaError_t e_ = (call);                       \
    if (e_ != cudaSuccess) {                       \
      if (*last_failed == '\0') last_failed = #call; \
      if (g != nullptr) cudaGraphDestroy(g);       \
      if (body_src != nullptr) cudaGraphDestroy(body_src); \
      return static_cast<int>(e_);                 \
    }                                              \
  } while (0)

// Builds and instantiates the block of `k` steps; *exec_out receives its
// cudaGraphExec_t. Returns a CUDA error code (0 on success).
extern "C" int indextts_block_build(void* head, void* step, int k, const void* status, const void* budget,
                                    void** exec_out) {
  cudaGraph_t g = nullptr, body_src = nullptr;
  last_failed = "";
  if (k <= 0 || head == nullptr || step == nullptr || status == nullptr || budget == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the body: a copy of the step without its event nodes
  BLOCK_CHECK(cudaGraphClone(&body_src, static_cast<cudaGraph_t>(step)));
  BLOCK_CHECK(strip_event_nodes(body_src));
  BLOCK_CHECK(cudaGraphCreate(&g, 0));
  cudaGraphNode_t prev = nullptr;
  BLOCK_CHECK(cudaGraphAddChildGraphNode(&prev, g, nullptr, 0, static_cast<cudaGraph_t>(head)));
  const long long* status_p = static_cast<const long long*>(status);
  const long long* budget_p = static_cast<const long long*>(budget);
  for (int j = 0; j < k; ++j) {
    cudaGraphConditionalHandle handle;
    BLOCK_CHECK(cudaGraphConditionalHandleCreate(&handle, g, 0, cudaGraphCondAssignDefault));
    void* args[] = {&handle, &status_p, &budget_p};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(block_predicate_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    cudaGraphNode_t pred = nullptr;
    BLOCK_CHECK(cudaGraphAddKernelNode(&pred, g, &prev, 1, &kp));
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t cond = nullptr;
#if CUDART_VERSION >= 13000
    BLOCK_CHECK(cudaGraphAddNode(&cond, g, &pred, nullptr, 1, &cp));
#else
    BLOCK_CHECK(cudaGraphAddNode(&cond, g, &pred, 1, &cp));
#endif
    cudaGraphNode_t body = nullptr;
    BLOCK_CHECK(cudaGraphAddChildGraphNode(&body, cp.conditional.phGraph_out[0], nullptr, 0, body_src));
    prev = cond;
  }
  cudaGraphExec_t exec = nullptr;
  BLOCK_CHECK(cudaGraphInstantiate(&exec, g, 0));
  cudaGraphDestroy(g);
  cudaGraphDestroy(body_src);
  *exec_out = exec;
  return 0;
}

// The CUDA call that failed last in this thread ("" when none did).
extern "C" const char* indextts_block_failed_call() { return last_failed; }

// The name of a CUDA error code.
extern "C" const char* indextts_block_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

extern "C" int indextts_block_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int indextts_block_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
