"""Fused per-observation BA chain: hand-written CUDA kernels for Hopper.

Replaces the two Pallas TPU kernels of the reference package
(bundleadjustment_benchmarks_tpu/ops/pallas_chain.py):

  fused_blocks_energy  <- _blocks_kernel: robustified residuals, the 2x9 and
                          2x3 Jacobian blocks and the energy, once per outer
                          LM iteration;
  fused_energy         <- _energy_kernel: the trial energy, once per damping
                          trial.

and gives the float64 drive its own pair, which replaces no TPU kernel (the
JAX package's float64 chain is XLA-fused jnp):

  blocks_energy_f64    the robustified residuals, Jacobian blocks and
                       energy of jacobian.residuals_and_jacobian, as (26, K)
                       float64 planar rows;
  energy_f64           the trial energy of projection.energy.

The kernels (csrc/chain_kernels.cu, math in csrc/chain_math.cuh and
csrc/chain_f64.cuh) are built on
first use with nvcc for sm_90a into ``_build/`` beside the package and bound
through ctypes (``ops/nvcc.py``). Each entry point issues one device kernel: it reads the
state's float64 cameras and DF points as they are and folds its energy in
the same launch (see chain_kernels.cu). Each kernel has its plain PyTorch
version beside it (``*_plain``). The wrappers take the plain version only for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise. Every
launch adds one to ``LAUNCHES``; a launch captured into a CUDA graph (the
device-resident LM drive) adds one on the device each time the graph runs
it, into its slot of the device's in-graph record
(``cuda_graph.counter``), and ``collect_graph_launches`` brings those
counts into ``LAUNCHES`` (the LM drive's one host read brings them back
with the LM state: ``credit_graph_launches``).
The workspace (ticket + block partials) is one per (device, stream),
allocated before any capture; each kernel resets its ticket itself, so every
replay finds it at 0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch

from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, jacobian, nvcc, projection

SOURCES = ("chain_kernels.cu", "chain_math.cuh", "chain_f64.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

#: The kernels, in the C library's order (its ``which``) and in the order of
#: their slots of the in-graph record.
KERNELS = ("chain_blocks", "chain_energy", "chain_blocks_f64", "chain_energy_f64")
#: The kernels each drive launches, by geometry ("f64": the float64 drive).
DRIVE_KERNELS = {"df32": KERNELS[:2], "f64": KERNELS[2:]}
#: Launch counts of the kernels, by name. Only the wrappers' launches count;
#: a launch captured into a CUDA graph counts once per time the graph runs
#: it (see ``collect_graph_launches``).
LAUNCHES = dict.fromkeys(KERNELS, 0)
#: What the last build did: seconds, library path, nvcc's -Xptxas=-v output.
BUILD_INFO: dict = {}

_lib = None
_lock = threading.Lock()


def _graph_counts(dev) -> torch.Tensor:
    """The device's slots of its in-graph record for ``KERNELS``, which a
    captured launch's graph adds one to each time it runs the launch."""
    return cuda_graph.counter(dev, KERNELS[0], len(KERNELS))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for dev in cuda_graph.cuda_devices():
        _graph_counts(dev).zero_()


def credit_graph_launches(dev, counts) -> None:
    """Add the launches ``counts[kernel]`` of each of ``KERNELS``, which a
    caller read from the device's record, to ``LAUNCHES`` and zero their
    slots there."""
    for k in KERNELS:
        LAUNCHES[k] += counts[k]
    _graph_counts(dev).zero_()


def collect_graph_launches() -> None:
    """Add the launches that CUDA graphs ran since the last call to
    ``LAUNCHES`` (one host read per device that has a record)."""
    for dev in cuda_graph.cuda_devices():
        credit_graph_launches(dev, dict(zip(KERNELS, _graph_counts(dev).tolist())))


def prepare_capture(dev: torch.device) -> None:
    """Before a CUDA graph captures launches on the current stream: build
    the library and allocate that stream's workspace and the device's
    in-graph record outside the capture (an allocation inside it would be
    zeroed again on every replay)."""
    lib = load_library()
    _workspace(lib, dev, torch.cuda.current_stream(dev).cuda_stream)
    cuda_graph.record(dev)


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
        d = ctypes.c_double
        lib.chain_f64.argtypes = [i] + [p] * 9 + [i, i, i, d, d, p, p, p, p]
        lib.chain_f64.restype = i
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
    _count(dev, which)
    return rows, energy


def _count(dev, which: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        # The graph counts the launch each time it runs it.
        cuda_graph.counter(dev, which).add_(1)
    else:
        LAUNCHES[which] += 1


def launch_f64(which: str, operands, tau2: float):
    """Check the operands and launch one float64 chain kernel (``which`` is
    "chain_blocks_f64" or "chain_energy_f64") on the current stream.

    ``operands`` is ``f64_operands``'s tuple. Returns ((26, K) float64 rows
    or None, float64 0-dim energy over every observation)."""
    R, T, Kmat, k1, k2, points, meas, cam_idx, pt_idx = operands
    dev = points.device
    k, n, m = cam_idx.shape[0], R.shape[0], points.shape[0]
    f64 = torch.float64
    for t, name, dtype, shape in (
            (R, "R", f64, (n, 3, 3)), (T, "T", f64, (n, 3)),
            (Kmat, "K", f64, (n, 3, 3)), (k1, "k1", f64, (n,)),
            (k2, "k2", f64, (n,)), (points, "points", f64, (m, 3)),
            (meas, "measurements", f64, (k, 2)),
            (cam_idx, "cam_idx", torch.int32, (k,)),
            (pt_idx, "pt_idx", torch.int32, (k,))):
        _check(t, name, dtype, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"{which}: operands must be CUDA tensors, got {dev}")
    if which not in DRIVE_KERNELS["f64"]:
        raise ValueError(f"unknown float64 chain kernel {which!r}")
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(lib, dev, stream).data_ptr()
    energy = torch.empty((), dtype=f64, device=dev)
    rows = (torch.empty((jacobian.PLANAR_CHAIN_ROWS, k), dtype=f64, device=dev)
            if which == "chain_blocks_f64" else None)
    tau2 = float(tau2)
    err = lib.chain_f64(KERNELS.index(which), *(t.data_ptr() for t in operands),
                        n, k, m, tau2, 1.0 / tau2,
                        None if rows is None else rows.data_ptr(), ws,
                        energy.data_ptr(), stream)
    _raise(lib, f"{which} launch", err)
    _count(dev, which)
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
        KERNELS.index(which), n_cameras, k, valid, out))
    grid, threads, per_sm, sms, staged = out
    n = max(0, min(valid, k)) if which == "chain_energy" else k
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


def f64_operands(state, obs):
    """The float64 kernels' operands as the BAState holds them: R (N, 3, 3),
    T (N, 3), K (N, 3, 3), k1 and k2 (N,), the points (M, 3), the
    measurements (K, 2) and the int32 indices (K,); a tensor that is not
    contiguous (the points of ``models.problem.from_fast``, which the
    two-phase drive's float64 phase starts from) is copied."""
    return tuple(t.contiguous() for t in (
        state.R, state.T, state.K, state.k1, state.k2, state.points,
        obs.measurements, obs.cam_idx, obs.pt_idx))


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


def chain_blocks_f64_plain(state, obs, tau2):
    """Plain version of the float64 blocks kernel: the blocks of
    residuals_and_jacobian as (26, K) planar rows, and
    compensated_square_sum of its residuals."""
    blocks = jacobian.residuals_and_jacobian(state, obs, tau2)
    return (jacobian.planar_rows_from_blocks(blocks),
            projection.compensated_square_sum(blocks.f))


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


def blocks_energy_f64(state, obs, tau2):
    """(JacobianBlocks, float64 energy) of the float64 chain on a BAState;
    drop-in for residuals_and_jacobian + compensated_square_sum. The blocks
    are views of (26, K) planar rows, as ``fused_blocks_energy`` gives."""
    if state.points.device.type == "cpu":
        rows, energy = chain_blocks_f64_plain(state, obs, tau2)
    else:
        rows, energy = launch_f64("chain_blocks_f64", f64_operands(state, obs),
                                  tau2)
    return jacobian.blocks_from_planar_rows(rows), energy


def energy_f64(state, obs, tau2) -> torch.Tensor:
    """Trial objective on a BAState; drop-in for projection.energy."""
    if state.points.device.type == "cpu":
        return projection.energy(state, obs, tau2)
    return launch_f64("chain_energy_f64", f64_operands(state, obs), tau2)[1]
