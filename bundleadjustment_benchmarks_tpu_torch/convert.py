"""Carry a BA problem between this package and numpy arrays.

A problem's "weights" are its state, observations and load-time tables.
``problem_to_numpy`` flattens any problem object with the reference field
names (this package's, or the JAX package's: only attribute access and
``numpy.asarray`` are used) into a flat dict of numpy arrays and scalars;
``problem_from_numpy`` builds this package's ``BAProblem`` from such a dict,
so both packages can compute on exactly the same inputs, and a checkpoint's
arrays load into the port.

Keys: ``state.{K,R,T,k1,k2,points}``, ``obs.{cam_idx,pt_idx,measurements,
weights,measurements_pl}``, ``pt_obs_idx``, ``pt_obs_count``,
``cam_obs_idx``, ``cam_obs_pt``, ``inlier_threshold``, ``avg_focal_length``,
``pairs.{row_a,row_b,key_table,key_to_obs,row_pt}`` and
``{pt,cam}_banded.{unperm,tables.<i>,aux.<i>}``.
"""

from __future__ import annotations

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm

_STATE = ("K", "R", "T", "k1", "k2", "points")
_OBS = ("cam_idx", "pt_idx", "measurements", "weights", "measurements_pl")
_TABLES = ("pt_obs_idx", "pt_obs_count", "cam_obs_idx", "cam_obs_pt")
_PAIRS = ("row_a", "row_b", "key_table", "key_to_obs", "row_pt")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_to_numpy(state) -> dict:
    """BAState (either package) -> {name: numpy array}."""
    return {k: _np(getattr(state, k)) for k in _STATE}


def problem_to_numpy(problem) -> dict:
    """BAProblem (either package) -> flat dict of numpy arrays and scalars."""
    d = {f"state.{k}": v for k, v in state_to_numpy(problem.state).items()}
    for k in _OBS:
        v = getattr(problem.obs, k, None)
        if v is not None:
            d[f"obs.{k}"] = _np(v)
    for k in _TABLES:
        v = getattr(problem, k, None)
        if v is not None:
            d[k] = _np(v)
    d["inlier_threshold"] = float(problem.inlier_threshold)
    d["avg_focal_length"] = float(problem.avg_focal_length)
    if problem.pairs is not None:
        for k in _PAIRS:
            d[f"pairs.{k}"] = _np(getattr(problem.pairs, k))
    for name in ("pt_banded", "cam_banded"):
        b = getattr(problem, name, None)
        if b is None:
            continue
        d[f"{name}.unperm"] = _np(b.unperm)
        for i, t in enumerate(b.tables):
            d[f"{name}.tables.{i}"] = _np(t)
        for i, t in enumerate(b.aux or ()):
            d[f"{name}.aux.{i}"] = _np(t)
    return d


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True, order="C"))
    return t if dtype is None else t.to(dtype)


def _band_list(d, prefix):
    out, i = [], 0
    while f"{prefix}.{i}" in d:
        out.append(_t(d[f"{prefix}.{i}"]))
        i += 1
    return tuple(out)


def problem_from_numpy(d: dict, device=None) -> pm.BAProblem:
    """Build the port's BAProblem from ``problem_to_numpy``'s dict, on
    ``device`` (CUDA unless the caller names one, see resolve_device)."""
    device = resolve_device(device)
    state = pm.BAState(**{k: _t(d[f"state.{k}"]) for k in _STATE})
    meas = d["obs.measurements"]
    obs = pm.BAObservations(
        cam_idx=_t(d["obs.cam_idx"], torch.int32),
        pt_idx=_t(d["obs.pt_idx"], torch.int32),
        measurements=_t(meas),
        weights=_t(d["obs.weights"]) if "obs.weights" in d
        else torch.ones(meas.shape[0], dtype=torch.float64),
        measurements_pl=_t(d["obs.measurements_pl"]) if "obs.measurements_pl" in d
        else _t(np.asarray(meas).T.astype(np.float32)),
    )
    pairs = None
    if "pairs.row_a" in d:
        pairs = pm.PairTables(**{k: _t(d[f"pairs.{k}"], torch.int32)
                                 for k in _PAIRS})
    banded = {}
    for name in ("pt_banded", "cam_banded"):
        if f"{name}.unperm" in d:
            aux = _band_list(d, f"{name}.aux")
            banded[name] = pm.BandedTable(
                tables=_band_list(d, f"{name}.tables"),
                unperm=_t(d[f"{name}.unperm"]),
                aux=aux or None,
            )
    prob = pm.BAProblem(
        state=state,
        obs=obs,
        pt_obs_idx=_t(d["pt_obs_idx"], torch.int32),
        pt_obs_count=_t(d["pt_obs_count"], torch.int32),
        cam_obs_idx=_t(d["cam_obs_idx"], torch.int32),
        inlier_threshold=float(d["inlier_threshold"]),
        avg_focal_length=float(d["avg_focal_length"]),
        pairs=pairs,
        cam_obs_pt=_t(d["cam_obs_pt"], torch.int32) if "cam_obs_pt" in d else None,
        **banded,
    )
    return prob.to(device)


def state_from_numpy(d: dict, device=None) -> pm.BAState:
    """{name: array} (as from state_to_numpy) -> the port's BAState, on
    ``device`` (CUDA unless the caller names one)."""
    device = resolve_device(device)
    return pm.BAState(**{k: _t(d[k]) for k in _STATE}).to(device)
