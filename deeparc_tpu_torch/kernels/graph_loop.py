"""Device-side WHILE loops inside a CUDA graph, with their plain version.

``while_loop(cond, body)`` runs ``body()`` while ``cond()`` (a one-element
bool tensor) holds. It takes the place of ``jax.lax.while_loop`` in the
JAX package's on-device drivers: the LM block of ``solve_ba_grid`` /
``solve_tiles_prepared`` (``driver="while_loop"``), the whole solve of
``solve_ba(driver="while_loop")``, and PCG inside each step
(``solver.linalg.pcg_device``).

On the card it exists only inside a graph capture opened by
:func:`capture` (``solver.device_loop.BlockLoop`` does so): it captures a
conditional WHILE node (``csrc/graph_loop.cu``) whose body is everything
``body()`` and the next ``cond()`` launch, and whose handle the
hand-written condition kernel ``set_condition`` sets from the flag, once
before the node and at the end of every pass. Loops nest: a loop inside
the body becomes a node of the body graph. The body is captured on a
stream of its own (one per nesting depth, kept for the process), and its
allocations go to a private pool of its own, routed by that stream, which
lives as long as the capture's record. A CUDA flag outside a capture raises,
except in :func:`eager_loops`, which the driver's warm-up step uses.

On CPU tensors (and in :func:`eager_loops`) the plain version runs: the
same ``body()`` and ``cond()`` in a Python loop that reads the flag each
pass, so both forms run the same ops in the same order.
``while_loop.launches`` counts the condition kernel's captured launches
(two per node); a replay launches it once per node entry plus once per
pass.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_state = {"eager": False, "record": None}
# loops nest this deep: an LM block's body, and PCG's inside it
LOOP_DEPTH = 2
# the body streams of each device, one per depth, made once outside any
# capture and kept for the process (see _body_streams)
_streams: dict = {}


def _body_streams(device: torch.device) -> list:
    """The device's body streams. PyTorch keeps a cuBLAS workspace per
    (handle, stream) for the process's life: a stream's first matrix
    product, made here outside any capture, allocates it, where a first
    product inside a loop body would allocate it in that body's pool and
    keep the pool from ever being freed."""
    idx = torch.cuda._get_device_index(device, optional=True)
    if idx not in _streams:
        streams = []
        for _ in range(LOOP_DEPTH):
            stream = torch.cuda.Stream(idx)
            with torch.cuda.stream(stream):
                a = torch.ones((8, 8), dtype=torch.float64, device=idx)
                a @ a
            streams.append(stream)
        torch.cuda.synchronize(idx)
        _streams[idx] = streams
    return _streams[idx]


class LoopCapture:
    """What a capture with device loops holds on to: the flags that the
    condition kernel reads, the body graphs (``cudaGraph_t`` as ints,
    owned by their nodes) and the body pools (released by
    :meth:`release`); the body streams are the device's."""

    def __init__(self, device: torch.device):
        self.device = device
        self.flags: list = []
        self.streams = _body_streams(device)
        self.bodies: list = []
        self.pools: list = []
        self.depth = 0

    def stream(self) -> torch.cuda.Stream:
        if self.depth > LOOP_DEPTH:
            raise RuntimeError(f"device loops nest at most {LOOP_DEPTH} "
                               f"deep")
        return self.streams[self.depth - 1]

    def release(self) -> None:
        self.flags = []
        idx = torch.cuda._get_device_index(self.device, optional=True)
        for pool in self.pools:
            torch._C._cuda_releasePool(idx, pool)
        self.pools = []


@contextlib.contextmanager
def capture(device):
    """Record the device loops captured inside (see :class:`LoopCapture`);
    the caller opens the graph capture inside this context."""
    rec = LoopCapture(torch.device(device))
    prev, _state["record"] = _state["record"], rec
    try:
        yield rec
    finally:
        _state["record"] = prev


@contextlib.contextmanager
def eager_loops():
    """Run device loops on CUDA tensors in their plain form (one flag read
    a pass), with ``torch.cuda`` sync debugging off for those reads only;
    the driver's warm-up step runs so before the capture."""
    prev, _state["eager"] = _state["eager"], True
    try:
        yield
    finally:
        _state["eager"] = prev


def _read(flag: torch.Tensor) -> bool:
    if not flag.is_cuda:
        return bool(flag)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return bool(flag)
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _check_flag(flag: torch.Tensor) -> torch.Tensor:
    if flag.dtype != torch.bool or flag.numel() != 1:
        raise TypeError(f"a loop condition is one bool, not {flag.dtype} "
                        f"{tuple(flag.shape)}")
    return flag.reshape(()).contiguous()


def while_loop(cond, body) -> None:
    """Run ``body()`` while ``cond()`` holds (see the module docstring)."""
    flag = _check_flag(cond())
    if flag.device.type == "cpu" or _state["eager"]:
        while _read(flag):
            body()
            flag = _check_flag(cond())
        return
    if flag.device.type != "cuda":
        raise ValueError(f"while_loop: no device loop for {flag.device}")
    rec = _state["record"]
    if rec is None or not torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "while_loop on the card runs only inside a CUDA graph capture "
            "opened under kernels.graph_loop.capture "
            "(solver.device_loop.BlockLoop)")
    _capture_while(rec, flag, cond, body)


def _capture_while(rec: LoopCapture, flag, cond, body) -> None:
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    outer = torch.cuda.current_stream(flag.device)
    rec.flags.append(flag)
    rec.depth += 1
    side = rec.stream()
    handle, body_graph = ctypes.c_ulonglong(), ctypes.c_void_p()
    try:
        check(lib.gl_while_begin(outer.cuda_stream, flag.data_ptr(),
                                 side.cuda_stream, ctypes.byref(handle),
                                 ctypes.byref(body_graph)), "gl_while_begin")
        while_loop.launches += 1
        rec.bodies.append(body_graph.value)
        pool = torch.cuda.graph_pool_handle()
        rec.pools.append(pool)
        idx = torch.cuda._get_device_index(flag.device, optional=True)
        try:
            with torch.cuda.stream(side):
                torch._C._cuda_beginAllocateCurrentStreamToPool(idx, pool)
                try:
                    body()
                    nxt = _check_flag(cond())
                    rec.flags.append(nxt)
                    check(lib.gl_set_condition(side.cuda_stream, handle.value,
                                               nxt.data_ptr()),
                          "gl_set_condition")
                    while_loop.launches += 1
                finally:
                    torch._C._cuda_endAllocateToPool(idx, pool)
        finally:
            rc = lib.gl_while_end(side.cuda_stream)
        check(rc, "gl_while_end")
    finally:
        rec.depth -= 1


# CUgraphNodeType values (cuda.h)
KERNEL_NODE, CONDITIONAL_NODE = 0, 13


def _nodes(graph: int) -> list:
    """The nodes (``CUgraphNode`` as ints) of ``graph``, a ``cudaGraph_t``
    as an int, read through the driver API: the runtime that the kernel
    library links statically refuses graphs that PyTorch's runtime
    made."""
    cuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph), None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if not rc:
        rc = cuda.cuGraphGetNodes(ctypes.c_void_p(graph), nodes,
                                  ctypes.byref(n))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes: CUresult {rc}")
    return [nodes[i] for i in range(n.value)]


def node_types(graph: int) -> list:
    """The types (``CUgraphNodeType`` values) of the nodes of ``graph``, a
    ``cudaGraph_t`` as an int (see :func:`_nodes`)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    types = []
    for node in _nodes(graph):
        t = ctypes.c_int()
        rc = cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        if rc:
            raise RuntimeError(f"cuGraphNodeGetType: CUresult {rc}")
        types.append(t.value)
    return types


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""

    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("gridDimX", "gridDimY", "gridDimZ",
                                     "blockDimX", "blockDimY", "blockDimZ",
                                     "sharedMemBytes")] + [
        ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def kernel_names(graph: int) -> list:
    """The (mangled) function names of the kernel nodes of ``graph``, a
    ``cudaGraph_t`` as an int: what a replay of it launches, read from the
    graph itself through the driver API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    names = []
    for node in _nodes(graph):
        kind = ctypes.c_int()
        rc = cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind))
        if rc:
            raise RuntimeError(f"cuGraphNodeGetType: CUresult {rc}")
        if kind.value != KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        rc = cuda.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                                ctypes.byref(params))
        name = ctypes.c_char_p()
        if not rc and params.func:
            rc = cuda.cuFuncGetName(ctypes.byref(name),
                                    ctypes.c_void_p(params.func))
        elif not rc:
            rc = cuda.cuKernelGetName(ctypes.byref(name),
                                      ctypes.c_void_p(params.kern))
        if rc:
            raise RuntimeError(f"a kernel node's name: CUresult {rc}")
        names.append(name.value.decode())
    return names


def count_conditional(graph: int) -> int:
    """The conditional nodes of ``graph`` (a ``cudaGraph_t`` as an int)."""
    return sum(t == CONDITIONAL_NODE for t in node_types(graph))


while_loop.launches = 0


def reset_launch_counts() -> None:
    while_loop.launches = 0
