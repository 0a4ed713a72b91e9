// Device-side loops for CUDA graphs: a conditional WHILE node whose trip
// count depends on data, with its body captured from PyTorch's stream.
//
// No TPU kernel is replaced here. The JAX package runs its on-device LM
// driver as jax.lax.while_loop (deeparc_tpu/solver/rig_grid.py
// solve_ba_grid(driver="while_loop"), solver/tiles.py solve_tiles_prepared,
// solver/ba.py solve_ba) and its PCG as another (solver/linalg.py pcg);
// XLA lowers both to device loops. Here a captured CUDA graph takes the
// place of the jitted computation and a conditional WHILE node (CUDA 12.4+)
// that of the while_loop: the node runs its body graph again while its
// handle holds a non-zero value, so a block of LM steps, or a PCG solve,
// runs with no read by the host.
//
// set_condition. One thread reads a device flag (one byte, 0 or 1,
// written by PyTorch ops before it on the same stream) and sets the
// handle with cudaGraphSetConditional. It runs once before the node (the
// loop's first test) and once at the end of each pass of the body (the
// test of the next pass). One launch moves one byte: its time is the
// launch's latency.
//
// The host launchers work on a stream that is being captured (PyTorch's
// current stream inside torch.cuda.graph, or a body stream of an outer
// loop, so loops nest):
//   gl_while_begin: reads the capture's graph and its dependency set
//     (cudaStreamGetCaptureInfo), creates a handle on that graph, captures
//     set_condition there, adds the conditional WHILE node behind it,
//     makes the node the capture's only dependency
//     (cudaStreamUpdateCaptureDependencies), and starts capturing the body
//     stream into the node's body graph (cudaStreamBeginCaptureToGraph).
//   gl_set_condition: captures set_condition on the body stream.
//   gl_while_end: ends the body stream's capture.
// Each returns the first cudaError_t that is not cudaSuccess
// (cudaErrorStreamCaptureImplicit for a stream that is not capturing),
// and clears it from the thread's last error, which the next launcher's
// cudaGetLastError() would otherwise report as its own.
#include <cuda_runtime.h>

namespace graph_loop {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* __restrict__ flag) {
  cudaGraphSetConditional(handle, flag[0] ? 1u : 0u);
}

int done(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

cudaError_t while_begin(cudaStream_t s, const void* flag,
                        cudaStream_t body_stream,
                        unsigned long long* handle_out,
                        void** body_graph_out) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, s>>>(handle,
                                static_cast<const unsigned char*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(body_stream, body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  *body_graph_out = body;
  return cudaSuccess;
}

}  // namespace graph_loop

extern "C" {

int gl_while_begin(void* stream, const void* flag, void* body_stream,
                   unsigned long long* handle_out, void** body_graph_out) {
  return graph_loop::done(graph_loop::while_begin(
      static_cast<cudaStream_t>(stream), flag,
      static_cast<cudaStream_t>(body_stream), handle_out, body_graph_out));
}

int gl_set_condition(void* stream, unsigned long long handle,
                     const void* flag) {
  graph_loop::set_condition<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      handle, static_cast<const unsigned char*>(flag));
  return graph_loop::done(cudaGetLastError());
}

int gl_while_end(void* body_stream) {
  cudaGraph_t graph = nullptr;
  return graph_loop::done(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &graph));
}

}  // extern "C"
