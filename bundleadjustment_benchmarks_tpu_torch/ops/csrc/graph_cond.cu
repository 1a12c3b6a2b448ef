// Conditional nodes for CUDA graphs composed from captured PyTorch segments.
//
// The device-resident LM drive (solvers/lm.py, drive="jit") runs its
// data-dependent control flow (the chunk's trials until it is done, start an
// outer iteration or not, the float32 Cholesky or its QR fallback) on the
// device, as the JAX package's lax.while_loop/lax.cond do. PyTorch captures
// straight-line stream work into CUDA graphs; this file adds the branches
// and loops: a graph node whose body graph runs where (cudaGraphCondTypeIf)
// or while (cudaGraphCondTypeWhile) a one-byte device predicate is nonzero
// (CUDA 12.4+). A one-thread kernel node copies the predicate into the
// node's condition handle just before the node and, for a loop, again at
// the end of its body. ops/cuda_graph.py composes the captured segments
// (child graph nodes) and these conditional nodes into one executable
// graph; the host launches it and reads nothing until it chooses to.
//
// The marks: one-thread kernels that the LM drive puts on its stream at
// the ends of its phases, and so into the captured graph, where they run at
// every replay. Each reads the device's %globaltimer (ns) into one small
// int64 record per device (ops/cuda_graph.py, ``record``): a begin mark
// stores the time in its span's slot, an end mark adds the time since then
// to the span's total and one to its count, a counter mark adds one to its
// counter. Each mark is a kernel of its own name (``ba_mark_<mark>``), so
// a profiler trace shows where each span begins and ends.
//
// Plain C interface, loaded with ctypes: every function returns a
// cudaError_t as int (0 = success); graphs, nodes and executables travel as
// opaque pointers.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char *pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The record: begin times, totals (ns) and counts of CG_SPANS spans, then
// the counters (cuda_graph.SPANS, COUNTERS).
#define CG_SPANS 4

__device__ __forceinline__ void mark(long long *record, int slot, int kind) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  if (kind == 0) {  // begin
    record[slot] = (long long)now;
  } else if (kind == 1) {  // end
    record[CG_SPANS + slot] += (long long)now - record[slot];
    record[2 * CG_SPANS + slot] += 1;
  } else {  // counter
    record[3 * CG_SPANS + slot] += 1;
  }
}

}  // namespace

#define CG_MARK(name, slot, kind) \
  extern "C" __global__ void name(long long *record) { mark(record, slot, kind); }

// In cuda_graph.MARKS' order (cg_mark's `which`).
CG_MARK(ba_mark_prepare_begin, 0, 0)
CG_MARK(ba_mark_prepare_end, 0, 1)
CG_MARK(ba_mark_trial_begin, 1, 0)
CG_MARK(ba_mark_trial_end, 1, 1)
CG_MARK(ba_mark_camera_solve_begin, 2, 0)
CG_MARK(ba_mark_camera_solve_end, 2, 1)
CG_MARK(ba_mark_pair_gram_begin, 3, 0)
CG_MARK(ba_mark_pair_gram_end, 3, 1)
CG_MARK(ba_mark_camera_fallback, 0, 2)

static void (*const MARKS[])(long long *) = {
    ba_mark_prepare_begin,      ba_mark_prepare_end,
    ba_mark_trial_begin,        ba_mark_trial_end,
    ba_mark_camera_solve_begin, ba_mark_camera_solve_end,
    ba_mark_pair_gram_begin,    ba_mark_pair_gram_end,
    ba_mark_camera_fallback};

extern "C" {

// Launch mark `which` (an index of MARKS) on `stream` into `record`.
int cg_mark(int which, void *record, void *stream) {
  if (which < 0 || which >= (int)(sizeof(MARKS) / sizeof(MARKS[0])))
    return (int)cudaErrorInvalidValue;
  long long *r = static_cast<long long *>(record);
  void *args[] = {&r};
  return (int)cudaLaunchKernel(reinterpret_cast<const void *>(MARKS[which]),
                               dim3(1), dim3(1), args, 0,
                               static_cast<cudaStream_t>(stream));
}

int cg_graph_create(void **graph) {
  cudaGraph_t g = nullptr;
  cudaError_t err = cudaGraphCreate(&g, 0);
  *graph = g;
  return (int)err;
}

int cg_graph_destroy(void *graph) {
  return (int)cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// Number of nodes of a graph (an empty captured segment is not added), in
// `total`, and by cudaGraphNodeType in `by_type` (CG_NODE_TYPES entries,
// zeroed first), the nodes of child graphs counted again by their types.
#define CG_NODE_TYPES 16

static cudaError_t count_types(cudaGraph_t g, size_t *by_type) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  cudaGraphNode_t *nodes = new cudaGraphNode_t[n];
  err = cudaGraphGetNodes(g, nodes, &n);
  for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) break;
    by_type[(int)t < CG_NODE_TYPES ? (int)t : CG_NODE_TYPES - 1] += 1;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_types(child, by_type);
    }
  }
  delete[] nodes;
  return err;
}

int cg_node_count(void *graph, size_t *total, size_t *by_type) {
  for (int i = 0; i < CG_NODE_TYPES; ++i) by_type[i] = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaError_t err = cudaGraphGetNodes(g, nullptr, total);
  if (err != cudaSuccess) return (int)err;
  return (int)count_types(g, by_type);
}

// Append a child graph node (a clone of `child`) after `dep` (or as a root
// when `dep` is null).
int cg_add_child(void *graph, void *dep, void *child, void **node) {
  cudaGraphNode_t n = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaError_t err = cudaGraphAddChildGraphNode(
      &n, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child));
  *node = n;
  return (int)err;
}

// Append, after `dep` (or as a root when `dep` is null), the kernel node
// that sets the condition `handle` from the device byte `pred`.
int cg_add_set(void *graph, void *dep, unsigned long long handle,
               const void *pred, void **node) {
  cudaGraphConditionalHandle h = handle;
  const unsigned char *p = static_cast<const unsigned char *>(pred);
  void *args[] = {&h, &p};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void *>(set_condition_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphNode_t n = nullptr;
  cudaError_t err = cudaGraphAddKernelNode(
      &n, static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0, &kp);
  *node = n;
  return (int)err;
}

// Append "if (*pred) body" (loop = 0) or "while (*pred) body" (loop = 1)
// after `dep`: a condition handle of `graph`, the kernel node that sets it
// from `pred`, and the conditional node. Returns the conditional node, its
// (empty) body graph, which the caller fills, and the handle, which a loop's
// body must set again last (cg_add_set) or it runs forever.
int cg_add_cond(void *graph, void *dep, const void *pred, int loop,
                void **node, void **body, unsigned long long *handle) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) return (int)err;
  void *setter = nullptr;
  int e = cg_add_set(graph, dep, h, pred, &setter);
  if (e != 0) return e;

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t s = static_cast<cudaGraphNode_t>(setter);
  cudaGraphNode_t n = nullptr;
  err = cudaGraphAddNode(&n, g, &s, 1, &cp);
  if (err != cudaSuccess) return (int)err;
  *node = n;
  *body = cp.conditional.phGraph_out[0];
  *handle = h;
  return 0;
}

int cg_instantiate(void *graph, void **exec) {
  cudaGraphExec_t e = nullptr;
  cudaError_t err =
      cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(graph), 0);
  *exec = e;
  return (int)err;
}

int cg_launch(void *exec, void *stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

int cg_exec_destroy(void *exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

const char *cg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
