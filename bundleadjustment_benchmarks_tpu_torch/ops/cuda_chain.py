"""Fused per-observation BA chain: hand-written CUDA kernels for Hopper.

Replaces the two Pallas TPU kernels of the reference package
(bundleadjustment_benchmarks_tpu/ops/pallas_chain.py):

  fused_blocks_energy  <- _blocks_kernel: robustified residuals, the 2x9 and
                          2x3 Jacobian blocks and the energy, once per outer
                          LM iteration;
  fused_energy         <- _energy_kernel: the trial energy, once per damping
                          trial.

The kernels (csrc/chain_kernels.cu, math in csrc/chain_math.cuh) are built on
first use with nvcc for sm_90a into ``_build/`` beside the package and bound
through ctypes (``ops/nvcc.py``). Each entry point issues one device kernel: it reads the
state's float64 cameras and DF points as they are and folds its energy in
the same launch (see chain_kernels.cu). Each kernel has its plain PyTorch
version beside it (``*_plain``). The wrappers take the plain version only for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise. Every
launch adds one to ``LAUNCHES``; a launch captured into a CUDA graph (the
device-resident LM drive) adds one on the device each time the graph runs
it, and ``collect_graph_launches`` brings those counts into ``LAUNCHES``.
The workspace (ticket + block partials) is one per (device, stream),
allocated before any capture; each kernel resets its ticket itself, so every
replay finds it at 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import jacobian, nvcc, projection

SOURCES = ("chain_kernels.cu", "chain_math.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

#: Launch counts of the kernels, by name. Only the wrappers' launches count;
#: a launch captured into a CUDA graph counts once per time the graph runs
#: it (see ``collect_graph_launches``).
LAUNCHES = {"chain_blocks": 0, "chain_energy": 0}
#: What the last build did: seconds, library path, nvcc's -Xptxas=-v output.
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()
#: Per device, an int64 (2,) tensor that a captured launch's graph adds one
#: to each time it runs the launch (chain_blocks, chain_energy).
_graph_counts: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in _graph_counts.values():
        counts.zero_()


def collect_graph_launches() -> None:
    """Add the launches that CUDA graphs ran since the last call to
    ``LAUNCHES`` (one host read per device that has captured launches)."""
    for counts in _graph_counts.values():
        blocks, energy = counts.tolist()
        LAUNCHES["chain_blocks"] += blocks
        LAUNCHES["chain_energy"] += energy
        counts.zero_()


def prepare_capture(dev: torch.device) -> None:
    """Before a CUDA graph captures launches on the current stream: build
    the library and allocate that stream's workspace and the device's
    graph launch counters outside the capture (an allocation inside it
    would be zeroed again on every replay)."""
    lib = load_library()
    _workspace(lib, dev, torch.cuda.current_stream(dev).cuda_stream)
    if dev.index not in _graph_counts:
        _graph_counts[dev.index] = torch.zeros(2, dtype=torch.int64, device=dev)


def load_library():
    """Build (once per source content) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        major, _ = torch.cuda.get_device_capability()
        if major != 9:
            raise RuntimeError(
                f"the chain kernels are built for sm_90a; this device is "
                f"{torch.cuda.get_device_name()} (sm_{major}x)"
            )
        BUILD_INFO.update(nvcc.build("chain", "chain_kernels.cu", SOURCES,
                                     NVCC_FLAGS))
        lib = ctypes.CDLL(BUILD_INFO["library"])
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        operands = [p] * 10 + [i, i, i, i, f]
        lib.chain_blocks.argtypes = operands + [p, p, p, p]
        lib.chain_blocks.restype = i
        lib.chain_energy.argtypes = operands + [p, p, p]
        lib.chain_energy.restype = i
        lib.chain_workspace_words.argtypes = [p]
        lib.chain_workspace_words.restype = i
        lib.chain_launch_shape.argtypes = [i, i, i, i, p]
        lib.chain_launch_shape.restype = i
        lib.chain_error_string.argtypes = [i]
        lib.chain_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: The kernels' workspaces (ticket + block partials), by (device, stream):
#: two streams never share a ticket.
_workspaces: dict = {}


def _workspace(lib, dev: torch.device, stream: int) -> torch.Tensor:
    ws = _workspaces.get((dev.index, stream))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the chain kernels' workspace for the capturing stream does "
                "not exist; call cuda_chain.prepare_capture before capture")
        words = ctypes.c_int()
        _raise(lib, "workspace", lib.chain_workspace_words(ctypes.byref(words)))
        ws = torch.zeros(words.value, dtype=torch.int32, device=dev)
        _workspaces[(dev.index, stream)] = ws
    return ws


def _raise(lib, what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} failed: {lib.chain_error_string(err).decode()}")


def launch(which: str, operands, tau2: float, valid_count=None):
    """Check the operands and launch one chain kernel (``which`` is
    "chain_blocks" or "chain_energy") on the current stream.

    ``operands`` is ``chain_operands``'s tuple. Returns ((26, K) float32
    rows or None, float64 0-dim energy over the first ``valid_count``
    observations)."""
    R, T, Kmat, k1, k2, pts_hi, pts_lo, meas, cam_idx, pt_idx = operands
    dev = pts_hi.device
    k, n, m = cam_idx.shape[0], R.shape[0], pts_hi.shape[1]
    f32, f64 = torch.float32, torch.float64
    for t, name, dtype, shape in (
            (R, "R", f64, (n, 3, 3)), (T, "T", f64, (n, 3)),
            (Kmat, "K", f64, (n, 3, 3)), (k1, "k1", f64, (n,)),
            (k2, "k2", f64, (n,)), (pts_hi, "pts_hi", f32, (3, m)),
            (pts_lo, "pts_lo", f32, (3, m)),
            (meas, "measurements_pl", f32, (2, k)),
            (cam_idx, "cam_idx", torch.int32, (k,)),
            (pt_idx, "pt_idx", torch.int32, (k,))):
        _check(t, name, dtype, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"{which}: operands must be CUDA tensors, got {dev}")
    valid = k if valid_count is None else int(valid_count)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(lib, dev, stream).data_ptr()
    energy = torch.empty((), dtype=f64, device=dev)
    ptrs = [t.data_ptr() for t in operands]
    if which == "chain_blocks":
        rows = torch.empty((jacobian.PLANAR_CHAIN_ROWS, k), dtype=f32, device=dev)
        err = lib.chain_blocks(*ptrs, n, k, m, valid, float(tau2),
                               rows.data_ptr(), ws, energy.data_ptr(), stream)
    elif which == "chain_energy":
        rows = None
        err = lib.chain_energy(*ptrs, n, k, m, valid, float(tau2), ws,
                               energy.data_ptr(), stream)
    else:
        raise ValueError(f"unknown chain kernel {which!r}")
    _raise(lib, f"{which} launch", err)
    if torch.cuda.is_current_stream_capturing():
        # The graph counts the launch each time it runs it.
        which_i = 0 if which == "chain_blocks" else 1
        counts = _graph_counts.get(dev.index)
        if counts is None:
            raise RuntimeError("call cuda_chain.prepare_capture before capture")
        counts[which_i:which_i + 1].add_(1)
    else:
        LAUNCHES[which] += 1
    return rows, energy


def launch_shape(which: str, n_cameras: int, k: int, valid_count=None) -> dict:
    """The launch of ``which`` for ``n_cameras`` and ``k`` observations on
    the current device: grid, threads, resident blocks per SM, SMs, the share
    of one full wave the grid fills, observations per thread (the most), and
    whether the block stages the split cameras in shared memory."""
    lib = load_library()
    out = (ctypes.c_int * 5)()
    valid = k if valid_count is None else int(valid_count)
    _raise(lib, "launch shape", lib.chain_launch_shape(
        {"chain_blocks": 0, "chain_energy": 1}[which], n_cameras, k, valid,
        out))
    grid, threads, per_sm, sms, staged = out
    n = k if which == "chain_blocks" else max(0, min(valid, k))
    return {"grid": grid, "threads": threads, "blocks_per_sm": per_sm,
            "sms": sms, "waves": grid / (per_sm * sms),
            "obs_per_thread": -(-n // (grid * threads)),
            "staged_cameras": bool(staged)}


def chain_operands(fast, obs):
    """The kernels' operands as the state holds them: the float64 cameras R
    (N, 3, 3), T (N, 3), K (N, 3, 3), k1 and k2 (N,) (split into DF halves
    inside the kernel), the DF point rows (3, M), the planar measurements
    (2, K) and the int32 indices (K,)."""
    return (fast.R, fast.T, fast.K, fast.k1, fast.k2, fast.points.hi,
            fast.points.lo, obs.measurements_pl, obs.cam_idx, obs.pt_idx)


# -- plain PyTorch versions ------------------------------------------------------


def chain_blocks_plain(fast, obs, tau2, valid_count=None):
    """Plain version of the blocks kernel: the (26, K) planar_blocks_chain
    rows and the DF tree sum of f0^2 + f1^2 over the first valid_count
    observations."""
    rows = jacobian.planar_chain_rows(fast, obs, tau2)
    return rows, projection.compensated_square_sum(rows[0:2].T[:valid_count])


def fused_blocks_energy_plain(fast, obs, tau2, valid_count=None):
    """residuals_and_jacobian_fast + compensated_square_sum (over the first
    valid_count observations)."""
    rows, energy = chain_blocks_plain(fast, obs, tau2, valid_count)
    return jacobian.blocks_from_planar_rows(rows), energy


def fused_energy_plain(fast, obs, tau2, valid_count=None) -> torch.Tensor:
    """energy_fast over the first valid_count observations."""
    if valid_count is not None:
        obs = _prefix(obs, int(valid_count))
    return projection.energy_fast(fast, obs, tau2)


def _prefix(obs, n):
    return dataclasses.replace(
        obs, cam_idx=obs.cam_idx[:n], pt_idx=obs.pt_idx[:n],
        measurements=obs.measurements[:n], weights=obs.weights[:n],
        measurements_pl=obs.measurements_pl[:, :n].contiguous(),
    )


# -- entry points ------------------------------------------------------------------


def fused_blocks_energy(fast, obs, tau2, valid_count=None):
    """(JacobianBlocks, float64 energy) of the chain; drop-in for
    residuals_and_jacobian_fast + compensated_square_sum. ``valid_count``
    limits the energy to the first valid_count observations."""
    if fast.points.hi.device.type == "cpu":
        return fused_blocks_energy_plain(fast, obs, tau2, valid_count)
    rows, energy = launch("chain_blocks", chain_operands(fast, obs), tau2,
                          valid_count)
    return jacobian.blocks_from_planar_rows(rows), energy


def fused_energy(fast, obs, tau2, valid_count=None) -> torch.Tensor:
    """Trial objective; drop-in for projection.energy_fast."""
    if fast.points.hi.device.type == "cpu":
        return fused_energy_plain(fast, obs, tau2, valid_count)
    return launch("chain_energy", chain_operands(fast, obs), tau2,
                  valid_count)[1]

