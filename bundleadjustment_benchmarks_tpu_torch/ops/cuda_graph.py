"""Device conditionals and loops, and CUDA graphs that hold them.

The JAX package runs its LM loop as one XLA computation whose branches
(``lax.while_loop``, ``lax.cond``) decide on the device. PyTorch captures
only straight-line stream work into a CUDA graph, and the card's PyTorch has
no conditional nodes of its own. ``DeviceGraph`` adds them: it captures a
Python function as a sequence of PyTorch graph segments (one shared memory
pool, captured and so replayed in program order) and, at each
``device_if(pred, body)`` or ``device_while(cond, body)``, ends the segment,
appends a conditional node whose body is ``body`` captured the same way,
and starts the next segment. The nodes come from ``csrc/graph_cond.cu``
(cudaGraphCondTypeIf and cudaGraphCondTypeWhile, set from a one-byte
predicate by a one-thread kernel), built with nvcc at first use and bound
through ctypes.

``device_if`` and ``device_while`` are the one way the port's
device-resident code branches and loops on data:
  * while a ``DeviceGraph`` captures, on a CUDA predicate: a conditional
    node; the host never reads the predicate;
  * on a CPU predicate (the CPU has no graphs; the tests run there): it
    reads the predicate and runs ``body`` or not, or again;
  * on a CUDA predicate outside a capture it raises: the device path never
    falls back to a host read.

A tensor that ``body`` allocates keeps its memory while Python holds it, so
a value made inside a conditional body and read after it is the value of
the last replay that ran the body (the LM drive's Schur context, made once
per outer iteration and read by every trial of it).
"""

from __future__ import annotations

import ctypes
import threading
import time
import warnings

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import nvcc

SOURCES = ("graph_cond.cu",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
#: What the last build did: seconds, library path, nvcc's output.
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()
_active = threading.local()
#: One capture stream per device, shared by every DeviceGraph (see
#: ``capture_stream``).
_streams: dict = {}


def load_library():
    """Build (once per source content) and load the conditional-node library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_INFO.update(nvcc.build("graph_cond", "graph_cond.cu", SOURCES,
                                     NVCC_FLAGS))
        lib = ctypes.CDLL(BUILD_INFO["library"])
        p, i = ctypes.c_void_p, ctypes.c_int
        pp = ctypes.POINTER(ctypes.c_void_p)
        for name, args in (
                ("cg_graph_create", [pp]), ("cg_graph_destroy", [p]),
                ("cg_node_count", [p, ctypes.POINTER(ctypes.c_size_t)]),
                ("cg_add_child", [p, p, p, pp]),
                ("cg_add_set", [p, p, ctypes.c_ulonglong, p, pp]),
                ("cg_add_cond", [p, p, p, i, pp, pp,
                                 ctypes.POINTER(ctypes.c_ulonglong)]),
                ("cg_instantiate", [p, pp]), ("cg_launch", [p, p]),
                ("cg_exec_destroy", [p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
        lib.cg_error_string.argtypes = [i]
        lib.cg_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _call(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"CUDA graph {what} failed: {lib.cg_error_string(err).decode()}")


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's capture stream, made once and primed by one throwaway
    capture. Measured on an H100 (torch 2.11, CUDA 12.8): cuSOLVER's QR
    and Cholesky solve captured on a stream fresh to capture record
    stream-ordered allocations (cudaMallocAsync nodes), which a graph
    cannot hold in a conditional body or a child graph; on a stream that
    has been captured on before they record none."""
    stream = _streams.get(device.index)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            x = torch.zeros(1, device=device)
            g = torch.cuda.CUDAGraph()
            g.capture_begin()
            x.add_(1)
            g.capture_end()
            del g
        torch.cuda.synchronize(device)
        _streams[device.index] = stream
    return stream


def capturing() -> bool:
    """True while a ``DeviceGraph`` captures on this thread."""
    return getattr(_active, "graph", None) is not None


def device_if(pred: torch.Tensor, body) -> None:
    """Run ``body()`` where the 0-dim bool ``pred`` is true (see the module
    docstring: a conditional node under capture, a read on the CPU)."""
    if pred.device.type == "cpu":
        if bool(pred):
            body()
        return
    graph = getattr(_active, "graph", None)
    if graph is None:
        raise RuntimeError(
            "device_if on a CUDA predicate outside a DeviceGraph capture: "
            "the device path does not read its predicates on the host")
    graph._if(pred, body)


def device_while(cond, body) -> None:
    """Run ``body()`` while the 0-dim bool ``cond()`` is true, ``cond``
    computed before each pass (see the module docstring: a loop node under
    capture, a read per pass on the CPU)."""
    pred = cond()
    if pred.device.type == "cpu":
        while bool(pred):
            body()
            pred = cond()
        return
    graph = getattr(_active, "graph", None)
    if graph is None:
        raise RuntimeError(
            "device_while on a CUDA predicate outside a DeviceGraph capture: "
            "the device path does not read its predicates on the host")
    graph._while(pred, cond, body)


def device_cond(pred: torch.Tensor, true_fn, false_fn, out: torch.Tensor):
    """``true_fn()`` where ``pred`` else ``false_fn()``; both return a
    tensor of ``out``'s shape and dtype. Under capture the two branches are
    two conditional nodes (pred, not pred) that write ``out``; on the CPU
    the chosen branch's result is returned as it is."""
    if pred.device.type == "cpu":
        return true_fn() if bool(pred) else false_fn()
    other = torch.logical_not(pred)
    device_if(pred, lambda: out.copy_(true_fn()))
    device_if(other, lambda: out.copy_(false_fn()))
    return out


class DeviceGraph:
    """One executable CUDA graph captured from Python code that branches
    with ``device_if``. ``capture(fn)`` runs ``fn`` once under capture on
    the graph's own stream and returns what it returns; ``replay()``
    launches the graph on the current stream without a host read.
    ``capture_s`` is the capture's wall time (segments, composition and
    instantiation); ``replays`` counts launches. ``close()`` frees the
    graph and its memory pool."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"DeviceGraph needs a CUDA device, got {device}")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = capture_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.capture_s = None
        self.replays = 0
        self._segments = []  # captured torch graphs: they hold the pool
        self._keep = []  # predicates the conditional nodes read
        self._graph = None
        self._exec = None
        self._scopes = []  # [cudaGraph_t, last node] per open body
        self._cur = None

    # -- capture ------------------------------------------------------------------

    def capture(self, fn):
        if self._graph is not None:
            raise RuntimeError("this DeviceGraph has been captured already")
        lib = load_library()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        top = ctypes.c_void_p()
        _call(lib, "create", lib.cg_graph_create(ctypes.byref(top)))
        self._graph = top.value
        self._scopes = [[top.value, None]]
        _active.graph = self
        try:
            with torch.cuda.stream(self.stream):
                self._begin()
                out = self._run(fn)
        finally:
            _active.graph = None
        exe = ctypes.c_void_p()
        _call(lib, "instantiation",
              lib.cg_instantiate(self._graph, ctypes.byref(exe)))
        self._exec = exe.value
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        return out

    def _begin(self):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self._cur = g

    def _end(self):
        g, self._cur = self._cur, None
        if g is None:
            return
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "The CUDA Graph is empty"
            g.capture_end()
        self._segments.append(g)
        lib = load_library()
        raw = g.raw_cuda_graph()
        count = ctypes.c_size_t()
        _call(lib, "node count", lib.cg_node_count(raw, ctypes.byref(count)))
        if count.value:
            scope = self._scopes[-1]
            node = ctypes.c_void_p()
            _call(lib, "child node", lib.cg_add_child(scope[0], scope[1], raw,
                                                      ctypes.byref(node)))
            scope[1] = node.value

    def _check(self, pred):
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError("a device predicate is a one-element bool tensor")
        if pred.device != self.device:
            raise ValueError(f"predicate on {pred.device}, graph on {self.device}")
        self._keep.append(pred)

    def _cond(self, pred, loop: bool):
        """End the segment, append the conditional node on ``pred`` and open
        its body; returns the node's condition handle."""
        lib = load_library()
        self._check(pred)
        self._end()
        scope = self._scopes[-1]
        node, child = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.c_ulonglong()
        _call(lib, "conditional node", lib.cg_add_cond(
            scope[0], scope[1], pred.data_ptr(), int(loop), ctypes.byref(node),
            ctypes.byref(child), ctypes.byref(handle)))
        scope[1] = node.value
        self._scopes.append([child.value, None])
        self._begin()
        return handle

    def _if(self, pred, body):
        self._cond(pred, loop=False)
        self._run(body)
        self._scopes.pop()
        self._begin()

    def _while(self, pred, cond, body):
        handle = self._cond(pred, loop=True)

        def pass_():
            body()
            return cond()

        again = self._run(pass_)
        self._check(again)
        lib = load_library()
        scope = self._scopes[-1]
        node = ctypes.c_void_p()
        _call(lib, "loop condition", lib.cg_add_set(
            scope[0], scope[1], handle, again.data_ptr(), ctypes.byref(node)))
        self._scopes.pop()
        self._begin()

    def _run(self, fn):
        """fn() inside the open segment, which it then ends; where fn
        raises, the segment is ended quietly and fn's error propagates."""
        try:
            out = fn()
        except BaseException:
            try:
                self._end()
            except Exception:
                pass
            raise
        self._end()
        return out

    # -- replay -------------------------------------------------------------------

    def replay(self) -> None:
        lib = load_library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _call(lib, "launch", lib.cg_launch(self._exec, stream))
        self.replays += 1

    def close(self) -> None:
        lib = _lib
        if lib is not None:
            if self._exec is not None:
                torch.cuda.synchronize(self.device)
                lib.cg_exec_destroy(self._exec)
            if self._graph is not None:
                lib.cg_graph_destroy(self._graph)
        self._exec = self._graph = None
        self._segments.clear()
        self._keep.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
