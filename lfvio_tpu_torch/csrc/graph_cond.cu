// Conditional (IF) nodes inside a CUDA-graph capture: the port's form of
// the JAX package's lax.cond in a jitted program (the LM loop's
// lax.cond(done, skip, work) and lax.cond(need_lin, lin_fn, lin),
// lfvio_tpu/backend/solver.py:402, :428), used by
// lfvio_tpu_torch/device.py::cond while a graph is being captured.
//
// No TPU kernel stands behind it: lax.cond is control flow, which XLA runs
// on the TPU by branching, and which a CUDA graph holds as a conditional
// node whose body graph runs at a replay only where a device value is
// non-zero. torch's own binding of these nodes
// (CUDAGraph.begin_capture_to_if_node) is missing from some of its builds,
// so the port binds the CUDA runtime calls itself, as torch does:
//
//   cond_begin: on the stream being captured, a one-thread kernel copies
//   the predicate (a device bool) into a new conditional handle; an IF node
//   on that handle is added after the stream's current capture
//   dependencies and becomes its only one; the node's body graph is then
//   captured from the stream ``body`` (cudaStreamBeginCaptureToGraph).
//   cond_end: ends the body's capture.
//
// The caller makes ``body`` the current stream while it enqueues the
// body's work and routes that thread's allocations to the capture's memory
// pool. A body may hold kernels, memsets, device-to-device copies and
// nested conditionals; an event, a host node or an allocation node in it
// makes its capture fail.
//
// What bounds it on an H100: the launch latency of set_condition_kernel
// (one thread, one byte read), once per IF node reached at a replay.

#include <cuda_runtime.h>

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// Returns a cudaError_t; the IF node and its body graph in *node_out and
// *body_out. cudaErrorIllegalState: ``outer`` is not being captured.
extern "C" int cond_begin(cudaStream_t outer, cudaStream_t body, const bool* pred,
                          unsigned long long* node_out, unsigned long long* body_out) {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    set_condition_kernel<<<1, 1, 0, outer>>>(handle, pred);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // The dependencies after the kernel: the IF node follows it.
    err = cudaStreamGetCaptureInfo(outer, &status, nullptr, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return err;
    err = cudaStreamUpdateCaptureDependencies(outer, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return err;
    cudaGraph_t body_graph = params.conditional.phGraph_out[0];
    err = cudaStreamBeginCaptureToGraph(body, body_graph, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal);
    if (err != cudaSuccess) return err;
    *node_out = reinterpret_cast<unsigned long long>(node);
    *body_out = reinterpret_cast<unsigned long long>(body_graph);
    return cudaSuccess;
}

extern "C" int cond_end(cudaStream_t body) {
    cudaGraph_t graph;
    return cudaStreamEndCapture(body, &graph);
}
