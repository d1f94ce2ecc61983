// The multi-round device loop for Hopper: the exit condition of the serving
// grid's loop programs, evaluated on the device, and the host functions that
// build `multi` as a CUDA graph with a conditional WHILE node.
//
// Replaces the `cond` of the two lax.while_loops of the JAX package's grid
// programs (src/repro/serve/executor.py, `multi_fn` and `roll_fn`):
//
//   multi: i < max_rounds & any(live) & ~any(done & ~done0)
//   roll:  i < k & any(live)
//
// where done0 is the done flags at the program's entry. On the card `multi`
// is one graph (`roll` reads nothing back, so there it is k launches of the
// round graph, serve/graphs.py; its condition runs in the eager programs):
//
//   entry kernel -> WHILE(handle) { child graph: the captured round
//                                   -> step kernel }
//
// The batch stream program (StreamingSampler's early-exit loop, the JAX
// package's `_build_stream_fn` while_loop) is the same loop with a captured
// prologue and epilogue, and its exit `~all(accepted) & r <= n` is this
// condition with live = ~accepted, budget N and done = done0 = 0:
//
//   prologue (init) -> entry kernel -> WHILE { round -> step kernel }
//     -> epilogue (the fall-through step and the outputs)
//
// The entry kernel sets i = 0, snapshots done0 and sets the handle to the
// condition at i = 0; the step kernel, after each round, counts the round and
// sets the handle to the condition of the new state. The host writes the
// budget into ctrl[0] before a launch and reads ctrl[1] (rounds run) back
// with the grid's flags, so a launch runs up to `budget` rounds with no host
// round trip between them. Conditional WHILE nodes need a CUDA 12.4 runtime
// and driver.
//
// Bound: launch latency. The kernel reads 2-3 flag bytes per slot (S is 1 to
// a few hundred) and writes 16 bytes of control words: one block, one pass
// over the flags, two block-wide ORs, one thread writes.
//
// ctrl (int32[4]): 0 budget (rounds this launch may run), 1 rounds run by
// this launch, 2 rounds run by every loop launch so far, 3 the last
// condition (1: run another round).
//
// Device time of the loop programs, with no profiler: as a graph node the
// kernel reads %globaltimer and adds the nanoseconds since its previous
// evaluation in the same launch (the round just run, and the node itself)
// to g_loop_clock[1]. The count covers every loop launch on the device;
// `device_loop_clock` reads it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kExitOnAccept = 1;  // multi: leave at the first new accept
constexpr int kFirst = 2;         // entry: i = 0, done0 = done

// 0 the last evaluation's %globaltimer, 1 ns spent inside loop programs
__device__ unsigned long long g_loop_clock[2];

template <bool kGraph>
__global__ void __launch_bounds__(kThreads) device_loop_kernel(
    cudaGraphConditionalHandle handle, const uint8_t* __restrict__ live,
    const uint8_t* __restrict__ done, uint8_t* __restrict__ done0,
    int32_t* __restrict__ ctrl, int s, int flags) {
  count_launch(0);
  const bool first = flags & kFirst;
  int any_live = 0, any_new = 0;
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const uint8_t d = done[i];
    if (first)
      done0[i] = d;
    else
      any_new |= (d != 0) & (done0[i] == 0);
    any_live |= live[i] != 0;
  }
  any_live = __syncthreads_or(any_live);
  any_new = __syncthreads_or(any_new);
  if (threadIdx.x == 0) {
    const int ran = first ? 0 : ctrl[1] + 1;
    const bool go = ran < ctrl[0] && any_live &&
                    !((flags & kExitOnAccept) && any_new);
    ctrl[1] = ran;
    if (!first) ctrl[2] = (int32_t)((uint32_t)ctrl[2] + 1u);  // wraps
    ctrl[3] = go;
    if constexpr (kGraph) {
      cudaGraphSetConditional(handle, go ? 1u : 0u);
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (!first) g_loop_clock[1] += now - g_loop_clock[0];
      g_loop_clock[0] = now;
    }
  }
}

struct Loop {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

int fail(cudaGraph_t g, cudaError_t e) {
  if (g) cudaGraphDestroy(g);
  return (int)e;
}

}  // namespace

extern "C" {

// One standalone launch of the condition kernel (no graph, no handle), for
// tests and timing: the same update of done0 and ctrl as a graph node.
// `flags`: bit 0 exit at the first new accept (multi), bit 1 entry.
// `threads` is the launch description's block (kernels/device_loop/
// kernel.py `launch_meta`: one block of kThreads), checked here.
int device_loop_step(const void* live, const void* done, void* done0,
                     void* ctrl, int s, int flags, int threads,
                     void* stream) {
  if (s < 1 || flags < 0 || flags > 3 || threads != kThreads)
    return (int)cudaErrorInvalidValue;
  record_launch((const void*)device_loop_kernel<false>, dim3(1),
                dim3(threads), 0);
  device_loop_kernel<false><<<1, threads, 0, (cudaStream_t)stream>>>(
      0, (const uint8_t*)live, (const uint8_t*)done, (uint8_t*)done0,
      (int32_t*)ctrl, s, flags);
  return (int)cudaGetLastError();
}

// Build and instantiate a loop program around `round_graph` (a captured
// cudaGraph_t, cloned into the body: it must stay alive and its buffers
// allocated while the loop exists). `pre_graph` and `post_graph`, each
// optional (null), are captured graphs run before the entry kernel and
// after the loop (the stream program's init and finish). live/done/done0
// are [s] bool (one byte each), ctrl int32[4]. On failure *node_type holds
// the type of the node instantiation refused (-1 if none) and *result its
// cudaGraphInstantiateResult. `threads` is the condition kernel's block,
// as for device_loop_step.
int device_loop_graph_create(void* pre_graph, void* round_graph,
                             void* post_graph, const void* live,
                             const void* done, void* done0, void* ctrl, int s,
                             int threads, void** out, int* node_type,
                             int* result) {
  *out = nullptr;
  *node_type = -1;
  *result = 0;
  if (s < 1 || !round_graph || threads != kThreads)
    return (int)cudaErrorInvalidValue;
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t pre = nullptr;
  if (pre_graph) {
    e = cudaGraphAddChildGraphNode(&pre, g, nullptr, 0,
                                   (cudaGraph_t)pre_graph);
    if (e != cudaSuccess) return fail(g, e);
  }
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 1, cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return fail(g, e);

  const uint8_t* lv = (const uint8_t*)live;
  const uint8_t* dn = (const uint8_t*)done;
  uint8_t* d0 = (uint8_t*)done0;
  int32_t* ct = (int32_t*)ctrl;
  int f_entry = kExitOnAccept | kFirst;
  int f_step = kExitOnAccept;
  void* entry_args[] = {&h, &lv, &dn, &d0, &ct, &s, &f_entry};
  void* step_args[] = {&h, &lv, &dn, &d0, &ct, &s, &f_step};
  cudaKernelNodeParams kp = {};
  kp.func = (void*)device_loop_kernel<true>;
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(threads);
  kp.kernelParams = entry_args;
  cudaGraphNode_t entry, loop_node, child, step;
  e = cudaGraphAddKernelNode(&entry, g, pre ? &pre : nullptr, pre ? 1 : 0,
                             &kp);
  if (e != cudaSuccess) return fail(g, e);

  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  e = cudaGraphAddNode(&loop_node, g, &entry, 1, &cp);
  if (e != cudaSuccess) return fail(g, e);
  cudaGraph_t body = cp.conditional.phGraph_out[0];
  e = cudaGraphAddChildGraphNode(&child, body, nullptr, 0,
                                 (cudaGraph_t)round_graph);
  if (e != cudaSuccess) return fail(g, e);
  kp.kernelParams = step_args;
  e = cudaGraphAddKernelNode(&step, body, &child, 1, &kp);
  if (e != cudaSuccess) return fail(g, e);
  if (post_graph) {
    cudaGraphNode_t post;
    e = cudaGraphAddChildGraphNode(&post, g, &loop_node, 1,
                                   (cudaGraph_t)post_graph);
    if (e != cudaSuccess) return fail(g, e);
  }

  cudaGraphExec_t exec = nullptr;
  cudaGraphInstantiateParams ip = {};
  e = cudaGraphInstantiateWithParams(&exec, g, &ip);
  if (e != cudaSuccess) {
    *result = (int)ip.result_out;
    cudaGraphNodeType t;
    if (ip.errNode_out && cudaGraphNodeGetType(ip.errNode_out, &t) ==
                              cudaSuccess)
      *node_type = (int)t;
    return fail(g, e);
  }
  Loop* loop = new Loop{g, exec};
  *out = loop;
  return 0;
}

int device_loop_graph_launch(void* loop, void* stream) {
  if (!loop) return (int)cudaErrorInvalidValue;
  return (int)cudaGraphLaunch(((Loop*)loop)->exec, (cudaStream_t)stream);
}

int device_loop_graph_destroy(void* loop) {
  if (!loop) return 0;
  Loop* l = (Loop*)loop;
  cudaError_t e = cudaGraphExecDestroy(l->exec);
  cudaError_t e2 = cudaGraphDestroy(l->graph);
  delete l;
  return (int)(e != cudaSuccess ? e : e2);
}

// The loop programs' device clock of the current device (see the top of
// this file): out[0] the last %globaltimer stamp, out[1] the nanoseconds
// spent inside loop programs so far. A synchronous copy: it waits for the
// device. With `reset`, the nanoseconds are zeroed afterwards.
int device_loop_clock(unsigned long long* out, int reset) {
  cudaError_t e =
      cudaMemcpyFromSymbol(out, g_loop_clock, sizeof(g_loop_clock));
  if (e != cudaSuccess || !reset) return (int)e;
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(g_loop_clock, &zero, sizeof(zero),
                                 sizeof(zero));
}

// The CUDA runtime this library was built against and the driver's
// version (both as 1000 * major + 10 * minor).
int device_loop_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDriverGetVersion(driver);
}

const char* device_loop_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
