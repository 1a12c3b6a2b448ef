"""Symmetric eigendecomposition on the device that a CUDA graph can capture.

qrkit on a problem without pair tables factors its augmented camera gram
once per LM iteration by an eigendecomposition (``schur._gram_sqrt_factor``;
the JAX package leaves it to XLA's eigh, no Pallas kernel).
``torch.linalg.eigh`` on CUDA reads its info flag on the host, and cuSOLVER's
``syevd`` and ``syevj`` synchronize inside (each invalidates a stream
capture on the H100), so none can run in the jit drive's graph. ``eigh``
runs the block Jacobi method of ``csrc/eigh.cu`` (built with nvcc for sm_90a
at first use, bound through ctypes) on the current stream, in float64: a
fixed sequence of two launches a round (the pair solves, with the round
before's V update beside them, then the A update) with no host read,
whose convergence is a device flag. On an H100 it takes ~0.22 s at
n = 2,314 and ~5 ms at n = 145, where ``torch.linalg.eigh`` takes ~37 and
~1.3 ms (PERF.md): its pair solves are bound by the latency of their
steps, its updates move A and V every round.
It returns info on the device (0 converged, 1 not within ``MAX_SWEEPS``
sweeps); ``schur._gram_sqrt_factor`` turns a nonzero info into NaN there, so
the LM loop's non-finite guard stops the run. Both LM drives call it on
CUDA; a build or a launch that fails raises, with no fall-back to
``torch.linalg.eigh``. Every call of the kernels adds one to ``LAUNCHES``; a
call captured into a CUDA graph adds one on the device each time the graph
runs it, into its slot of the device's in-graph record
(``cuda_graph.counter``), and ``collect_graph_launches`` brings those
counts into ``LAUNCHES`` (as ``cuda_chain`` counts its kernels).

``eigh_plain`` (``torch.linalg.eigh`` and a zero info) is what ``eigh``
takes for a CPU tensor, and the reference it is held to on the card.
Jacobi's eigenvectors are another orthonormal basis of each eigenspace, and
its rounding is its own: the two agree to the working precision, not bit
for bit.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, nvcc

SOURCES = ("eigh.cu",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)
#: Sweeps the launch sequence holds; a matrix that has not converged by
#: then gets info 1. On the H100 the p257 and p16 grams and random and
#: clustered matrices of their sizes took 9-22 (PERF.md); a sweep after
#: convergence costs only its launches, which return at once.
MAX_SWEEPS = 30
#: Calls of the kernels (``jacobi_eigh``); a call captured into a CUDA graph
#: counts once per time the graph runs it (see ``collect_graph_launches``).
LAUNCHES = {"jacobi_eigh": 0}
#: What the last build did: seconds, library path, nvcc's -Xptxas=-v output.
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()
_DTYPES = (torch.float32, torch.float64)


def reset_launches() -> None:
    LAUNCHES["jacobi_eigh"] = 0
    for dev in cuda_graph.cuda_devices():
        cuda_graph.counter(dev, "jacobi_eigh").zero_()


def credit_graph_launches(dev, calls: int) -> None:
    """Add ``calls``, which a caller read from the device's record, to
    ``LAUNCHES`` and zero their slot there."""
    LAUNCHES["jacobi_eigh"] += calls
    cuda_graph.counter(dev, "jacobi_eigh").zero_()


def collect_graph_launches() -> None:
    """Add the calls that CUDA graphs ran since the last call to
    ``LAUNCHES`` (one host read per device that has a record)."""
    for dev in cuda_graph.cuda_devices():
        credit_graph_launches(dev, int(cuda_graph.counter(dev, "jacobi_eigh").item()))


def prepare_capture(dev: torch.device) -> None:
    """Before a CUDA graph captures calls on the current stream: allocate
    the device's in-graph record, which holds the graph's launch counter,
    outside the capture (an allocation inside it would be zeroed again on
    every replay)."""
    cuda_graph.record(dev)


def load_library():
    """Build (once per source content) and load the eigensolver library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        BUILD_INFO.update(nvcc.build("eigh", "eigh.cu", SOURCES, NVCC_FLAGS))
        lib = ctypes.CDLL(BUILD_INFO["library"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.jacobi_eigh.argtypes = [p, p, p, p, i, p, p, i, p, p]
        lib.jacobi_eigh.restype = i
        lib.jacobi_block_rows.argtypes = []
        lib.jacobi_block_rows.restype = i
        lib.jacobi_error_string.argtypes = [i]
        lib.jacobi_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def eigh_plain(S: torch.Tensor):
    """(w, V, info) of the symmetric ``S`` by ``torch.linalg.eigh`` (its
    lower triangle; eigenvalues ascending, eigenvectors the columns of V),
    info a 0-dim int32 zero: a failure raises there."""
    w, V = torch.linalg.eigh(S)
    return w, V, torch.zeros((), dtype=torch.int32, device=S.device)


def jacobi_eigh(S: torch.Tensor, stats: Optional[torch.Tensor] = None):
    """(w, V, info, sweeps) of the symmetric CUDA matrix ``S`` by the block
    Jacobi kernels: eigenvalues ascending, eigenvectors the columns of V,
    both in S's dtype; info (0-dim int32) 0 where the sweeps converged, and
    the sweeps run; all on the device, nothing read by the host.
    ``stats``, a zeroed int32 (MAX_SWEEPS, 3) CUDA tensor, receives per
    outer sweep the pair solves that rotated, their inner sweeps and their
    rotations.

    The kernels run in float64. Their V is orthonormal to ~1e-11 at n =
    2,314 (the rounds' roundings add up), so one Newton-Schulz step
    V (3I - V^T V) / 2 restores it and the eigenvalues are the Rayleigh
    quotients diag(V^T S V), both float64 products."""
    if S.device.type != "cuda":
        raise ValueError(f"cuda_eigh.jacobi_eigh: tensor on {S.device}")
    if S.dim() != 2 or S.shape[0] != S.shape[1] or S.dtype not in _DTYPES:
        raise ValueError(f"cuda_eigh: a square float32 or float64 matrix, got "
                         f"{tuple(S.shape)} {S.dtype}")
    if stats is not None and (stats.shape != (MAX_SWEEPS, 3) or stats.dtype != torch.int32
                              or stats.device != S.device):
        raise ValueError(f"cuda_eigh: stats must be int32 ({MAX_SWEEPS}, 3) on "
                         f"{S.device}")
    lib = load_library()
    n, dev, f64 = S.shape[0], S.device, torch.float64
    S64 = S.to(f64)
    pair = 2 * lib.jacobi_block_rows()
    n_pad = max(pair, -(-n // pair) * pair)
    A = S64.new_zeros((n_pad, n_pad))
    A[:n, :n] = S64
    Vt = torch.eye(n_pad, dtype=f64, device=dev)  # the kernels keep V transposed
    thr = (torch.finfo(f64).eps * torch.sqrt((S64 * S64).sum())).reshape(1)
    # Two buffers: a round's V update runs beside the next round's pair solves.
    Qs = torch.empty((2, n_pad // pair, pair, pair), dtype=f64, device=dev)
    moved = torch.zeros((2, n_pad // pair), dtype=torch.int32, device=dev)
    flags = torch.zeros(3, dtype=torch.int32, device=dev)
    err = lib.jacobi_eigh(A.data_ptr(), Vt.data_ptr(), Qs.data_ptr(),
                          moved.data_ptr(), n_pad, thr.data_ptr(),
                          flags.data_ptr(), MAX_SWEEPS,
                          None if stats is None else stats.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"jacobi_eigh launch failed: "
                           f"{lib.jacobi_error_string(err).decode()}")
    if torch.cuda.is_current_stream_capturing():
        # The graph counts the call each time it runs it.
        cuda_graph.counter(dev, "jacobi_eigh").add_(1)
    else:
        LAUNCHES["jacobi_eigh"] += 1
    V = Vt[:n, :n].T
    V = V @ (1.5 * torch.eye(n, dtype=f64, device=dev) - 0.5 * (V.T @ V))
    w, order = torch.sort(((S64 @ V) * V).sum(dim=0))
    info = (1 - flags[0]).to(torch.int32)
    return w.to(S.dtype), V[:, order].to(S.dtype), info, flags[2]


def eigh(S: torch.Tensor):
    """(w, V, info) as ``eigh_plain``: by ``jacobi_eigh`` for a CUDA
    tensor (info left on the device, 1 where it did not converge), by
    ``eigh_plain`` for a CPU tensor."""
    if S.device.type == "cpu":
        return eigh_plain(S)
    return jacobi_eigh(S)[:3]
