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
// Plain C interface (no PyTorch headers): graphs.py passes the captured
// graphs' cudaGraph_t handles (torch.cuda.CUDAGraph(keep_graph=True)
// .raw_cuda_graph()) and the buffers' device addresses. Conditional nodes
// need CUDA 12.4 or later in the runtime and the driver.

#include <cuda_runtime.h>

namespace {

__global__ void block_predicate_kernel(cudaGraphConditionalHandle handle, const long long* status,
                                       const long long* budget) {
  cudaGraphSetConditional(handle, (status[0] < budget[0] && status[1] != 0) ? 1u : 0u);
}

}  // namespace

#define BLOCK_CHECK(call)                      \
  do {                                         \
    cudaError_t e_ = (call);                   \
    if (e_ != cudaSuccess) {                   \
      if (g != nullptr) cudaGraphDestroy(g);   \
      return static_cast<int>(e_);             \
    }                                          \
  } while (0)

// Builds and instantiates the block of `k` steps; *exec_out receives its
// cudaGraphExec_t. Returns a CUDA error code (0 on success).
extern "C" int indextts_block_build(void* head, void* step, int k, const void* status, const void* budget,
                                    void** exec_out) {
  cudaGraph_t g = nullptr;
  if (k <= 0 || head == nullptr || step == nullptr || status == nullptr || budget == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
    BLOCK_CHECK(cudaGraphAddChildGraphNode(&body, cp.conditional.phGraph_out[0], nullptr, 0,
                                           static_cast<cudaGraph_t>(step)));
    prev = cond;
  }
  cudaGraphExec_t exec = nullptr;
  BLOCK_CHECK(cudaGraphInstantiate(&exec, g, 0));
  cudaGraphDestroy(g);
  *exec_out = exec;
  return 0;
}

extern "C" int indextts_block_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int indextts_block_destroy(void* exec) {
  return static_cast<int>(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
