"""Checkpoint and resume of an LM run.

A checkpoint is one ``.npz`` file with the JAX package's keys:
``state.{K,R,T,k1,k2,points}``, ``lam``, ``iteration``, ``fun_evals``,
``energy_history`` and ``extra.<name>``, so a file written by either
package loads in the other. It is written to a temporary name and renamed
over ``path``, so a run stopped while writing leaves the previous one.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.models.problem import BAState

_STATE_FIELDS = ("K", "R", "T", "k1", "k2", "points")


def save_checkpoint(path: str, state: BAState, lam: float = 1e-3,
                    iteration: int = 0, fun_evals: int = 0,
                    energy_history=None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    arrays = {f"state.{k}": getattr(state, k).detach().cpu().numpy()
              for k in _STATE_FIELDS}
    arrays["lam"] = np.asarray(lam)
    arrays["iteration"] = np.asarray(iteration)
    arrays["fun_evals"] = np.asarray(fun_evals)
    arrays["energy_history"] = np.asarray(
        energy_history if energy_history is not None else [0.0, 0.0])
    for k, v in (extra or {}).items():
        arrays[f"extra.{k}"] = np.asarray(v)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                    device=None):
    """Returns (state, meta): the BAState on ``device`` (CUDA unless the
    caller names one, see resolve_device), in ``dtype`` if given, and meta
    with lam, iteration, fun_evals, energy_history and extra."""
    device = resolve_device(device)
    with np.load(path) as data:
        state = BAState(**{
            k: torch.from_numpy(data[f"state.{k}"]).to(device=device, dtype=dtype)
            for k in _STATE_FIELDS})
        meta = {
            "lam": float(data["lam"]),
            "iteration": int(data["iteration"]),
            "fun_evals": int(data["fun_evals"]),
            "energy_history": data["energy_history"].tolist(),
            "extra": {k[len("extra."):]: data[k] for k in data.files
                      if k.startswith("extra.")},
        }
    return state, meta
