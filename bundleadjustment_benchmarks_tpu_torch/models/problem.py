"""BA problem model: dataclasses of tensors for cameras, points, observations.

Reference model conventions applied at load (bundle_adjustment_large.cpp:
57-108): measurements divided by avg_focal_length; K = diag(-f, -f, 1);
distortion pre-scaled to (k1 f^2, k2 f^4); R = exp([omega]_x) in float64.
Observations are stably sorted by point so each point's observations are a
contiguous segment.

The gather tables (pair tables, degree-banded segment tables) are built once
with numpy and kept as int32 tensors; the TPU tile maps of the reference
package are left out (the CUDA kernels gather by cam_idx/pt_idx themselves).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from bundleadjustment_benchmarks_tpu_torch import resolve_device
from bundleadjustment_benchmarks_tpu_torch.io import bal
from bundleadjustment_benchmarks_tpu_torch.models import camera
from bundleadjustment_benchmarks_tpu_torch.ops import rodrigues
from bundleadjustment_benchmarks_tpu_torch.ops import twofloat as tf

def _to(x, device):
    """Move a tensor, or a tuple/dataclass of tensors, to ``device``."""
    if x is None or isinstance(x, (int, float, str)):
        return x
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_to(v, device) for v in x)
    if isinstance(x, tf.DF):
        return tf.DF(x.hi.to(device), x.lo.to(device))
    return dataclasses.replace(
        x, **{f.name: _to(getattr(x, f.name), device)
              for f in dataclasses.fields(x)}
    )


class _Movable:
    def to(self, device):
        return _to(self, device)


@dataclasses.dataclass
class BAState(_Movable):
    """K (N,3,3), R (N,3,3), T (N,3), k1/k2 (N,) pre-scaled, points (M,3)."""

    K: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    points: torch.Tensor

    @property
    def n_cameras(self) -> int:
        return self.T.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def focal(self) -> torch.Tensor:
        """K(0,0) per camera (reference getFocalLength, CameraMatrix.cpp:207)."""
        return camera.focal_length(self.K)


@dataclasses.dataclass
class BAObservations(_Movable):
    """cam_idx/pt_idx (K,) int32 (pt_idx non-decreasing), measurements (K, 2),
    weights (K,) (carried for parity, unused), measurements_pl (2, K) float32
    planar copy for the df32 chain."""

    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    measurements: torch.Tensor
    weights: torch.Tensor
    measurements_pl: Optional[torch.Tensor] = None

    @property
    def n_observations(self) -> int:
        return self.cam_idx.shape[0]


@dataclasses.dataclass
class PairTables(_Movable):
    """Gather tables of the observation-pair Schur gram.

    row_a/row_b (R, l_row): observation indices of pair members, each row
    holding pairs of one (ca < cb) camera key, sentinel K; key_table
    (KO, rmax): row ids per observed key, sentinel R; key_to_obs (N*N,):
    dense key -> observed-key index, sentinel KO; row_pt (R, l_row): point
    of each pair slot, sentinel M."""

    row_a: torch.Tensor
    row_b: torch.Tensor
    key_table: torch.Tensor
    key_to_obs: torch.Tensor
    row_pt: torch.Tensor


@dataclasses.dataclass
class BandedTable(_Movable):
    """Degree-banded segment gather tables: per band an (S_i, w_i) table
    (sentinel = number of values), optional per-band aux tables (point of
    each slot), and unperm (S,) from band order back to natural order."""

    tables: tuple
    unperm: torch.Tensor
    aux: Optional[tuple] = None


@dataclasses.dataclass
class BAProblem(_Movable):
    """State, observations, robust threshold and the load-time tables."""

    state: BAState
    obs: BAObservations
    pt_obs_idx: torch.Tensor  # (M, Lmax) int32, sentinel K
    pt_obs_count: torch.Tensor  # (M,) int32
    cam_obs_idx: torch.Tensor  # (N, Lcam) int32, sentinel K
    inlier_threshold: float
    avg_focal_length: float
    pairs: Optional[PairTables] = None
    cam_obs_pt: Optional[torch.Tensor] = None  # (N, Lcam) int32, sentinel M
    pt_banded: Optional[BandedTable] = None
    cam_banded: Optional[BandedTable] = None

    @property
    def tau2(self) -> float:
        return self.inlier_threshold * self.inlier_threshold

    @property
    def n_cameras(self) -> int:
        return self.state.n_cameras

    @property
    def n_points(self) -> int:
        return self.state.n_points

    @property
    def n_observations(self) -> int:
        return self.obs.n_observations


# -- numpy table builders (load time) --------------------------------------------


def _pair_tables_np(pt_idx: np.ndarray, cam_idx: np.ndarray, n_cameras: int,
                    l_row: int = 16) -> Optional[dict]:
    """Numpy PairTables fields from sorted pt_idx (O(#pairs))."""
    k = pt_idx.shape[0]
    n_points = int(pt_idx.max()) + 1 if k else 0
    counts = np.bincount(pt_idx, minlength=n_points)
    starts = np.zeros(n_points, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])

    a_parts, b_parts = [], []
    for L in np.unique(counts):
        if L < 2:
            continue
        pts = np.nonzero(counts == L)[0]
        ia, ib = np.triu_indices(int(L), k=1)
        base = starts[pts][:, None]
        a_parts.append((base + ia[None, :]).ravel())
        b_parts.append((base + ib[None, :]).ravel())
    if not a_parts:
        return None
    a = np.concatenate(a_parts)
    b = np.concatenate(b_parts)
    ca = cam_idx[a].astype(np.int64)
    cb = cam_idx[b].astype(np.int64)
    swap = ca > cb
    a2 = np.where(swap, b, a)
    b2 = np.where(swap, a, b)
    key = np.minimum(ca, cb) * n_cameras + np.maximum(ca, cb)

    order = np.argsort(key, kind="stable")
    a2, b2, key = a2[order], b2[order], key[order]
    q = key.shape[0]

    ukeys, key_counts = np.unique(key, return_counts=True)
    ko = ukeys.shape[0]
    rows_per_key = -(-key_counts // l_row)
    row_off = np.zeros(ko + 1, dtype=np.int64)
    np.cumsum(rows_per_key, out=row_off[1:])
    r = int(row_off[-1])

    key_start = np.zeros(ko, dtype=np.int64)
    np.cumsum(key_counts[:-1], out=key_start[1:])
    key_id = np.repeat(np.arange(ko), key_counts)
    pos = np.arange(q) - key_start[key_id]
    row_id = row_off[key_id] + pos // l_row
    slot = pos % l_row

    row_a = np.full((r, l_row), k, dtype=np.int32)
    row_b = np.full((r, l_row), k, dtype=np.int32)
    row_pt = np.full((r, l_row), n_points, dtype=np.int32)
    row_a[row_id, slot] = a2.astype(np.int32)
    row_b[row_id, slot] = b2.astype(np.int32)
    row_pt[row_id, slot] = pt_idx[a2].astype(np.int32)

    rmax = int(rows_per_key.max())
    key_table = np.full((ko, rmax), r, dtype=np.int32)
    kk = np.repeat(np.arange(ko), rows_per_key)
    rpos = np.arange(r) - row_off[kk]
    key_table[kk, rpos] = np.arange(r, dtype=np.int32)

    key_to_obs = np.full(n_cameras * n_cameras, ko, dtype=np.int32)
    key_to_obs[ukeys] = np.arange(ko, dtype=np.int32)
    return dict(row_a=row_a, row_b=row_b, key_table=key_table,
                key_to_obs=key_to_obs, row_pt=row_pt)


def _banded_table_np(idx: np.ndarray, n_segments: int,
                     aux_values: Optional[np.ndarray] = None,
                     aux_sentinel: int = 0, max_bands: int = 4):
    """Degree-banded gather tables from (unsorted) segment indices.

    Band widths are the distinct power-of-two roundings of the segment
    degrees, at most ``max_bands`` classes (the largest classes merge).
    Returns (tables, unperm, aux_tables) as numpy."""
    k = idx.shape[0]
    counts = np.bincount(idx, minlength=n_segments)
    widths = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(counts, 1))).astype(int))
    cls = np.unique(widths)[::-1]  # descending
    if len(cls) > max_bands:
        merged = cls[max_bands - 1:]
        widths = np.where(np.isin(widths, merged[1:]), merged[0], widths)
        cls = np.unique(widths)[::-1]
    order = np.argsort(-widths, kind="stable")

    starts = np.zeros(n_segments, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    sorted_vals = np.argsort(idx, kind="stable")
    sorted_seg = idx[sorted_vals]
    pos = np.arange(k, dtype=np.int64) - starts[sorted_seg]
    aux_ext = (np.append(aux_values, aux_sentinel).astype(np.int32)
               if aux_values is not None else None)

    tables, aux_tables = [], []
    unperm = np.empty(n_segments, dtype=np.int32)
    lo = 0
    for w in cls:
        segs = order[lo: lo + int((widths == w).sum())]
        lo += len(segs)
        row_of = np.full(n_segments, -1, dtype=np.int64)
        row_of[segs] = np.arange(len(segs))
        unperm[segs] = (lo - len(segs)) + np.arange(len(segs), dtype=np.int32)
        tbl = np.full((len(segs), int(w)), k, dtype=np.int32)
        member = row_of[sorted_seg] >= 0
        tbl[row_of[sorted_seg[member]], pos[member]] = \
            sorted_vals[member].astype(np.int32)
        tables.append(tbl)
        if aux_ext is not None:
            aux_tables.append(aux_ext[np.minimum(tbl, k)])
    return tables, unperm, aux_tables


def _index_table(idx: np.ndarray, n_segments: int) -> np.ndarray:
    """(n_segments, Lmax) gather table for unsorted indices, sentinel len(idx)."""
    k = idx.shape[0]
    counts = np.bincount(idx, minlength=n_segments)
    lmax = int(counts.max()) if counts.size else 0
    table = np.full((n_segments, max(lmax, 1)), k, dtype=np.int32)
    order = np.argsort(idx, kind="stable")
    sorted_idx = idx[order]
    starts = np.zeros(n_segments, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(k) - starts[sorted_idx]
    table[sorted_idx, pos] = order.astype(np.int32)
    return table


def _point_segment_table(pt_idx: np.ndarray, n_points: int):
    """(M, Lmax) observation gather table from sorted pt_idx, and counts."""
    counts = np.bincount(pt_idx, minlength=n_points).astype(np.int32)
    lmax = int(counts.max()) if counts.size else 0
    starts = np.zeros(n_points, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    k = pt_idx.shape[0]
    table = np.full((n_points, max(lmax, 1)), k, dtype=np.int32)
    ar = np.arange(k, dtype=np.int64)
    table[pt_idx, ar - starts[pt_idx]] = ar.astype(np.int32)
    return table, counts


def cam_obs_pt(cam_table: np.ndarray, pt_idx: np.ndarray, n_points: int):
    """Point index of each camera-table slot, sentinel n_points."""
    pt_ext = np.append(pt_idx, n_points).astype(np.int32)
    return pt_ext[np.minimum(cam_table, pt_idx.shape[0])]


def _banded(idx, n_segments, pt_idx, n_points) -> BandedTable:
    tables, unperm, aux = _banded_table_np(
        idx, n_segments, aux_values=pt_idx, aux_sentinel=n_points)
    return BandedTable(
        tables=tuple(torch.from_numpy(t) for t in tables),
        unperm=torch.from_numpy(unperm),
        aux=tuple(torch.from_numpy(a) for a in aux),
    )


def empty_pair_tables(n_cameras: int, n_obs: int, n_points: int) -> PairTables:
    """Pair tables with no pair: one row of sentinels (obs ``n_obs``, point
    ``n_points``) that no camera key references. A shard whose points are
    all seen once carries them where other shards have pairs, so that every
    shard takes the same path."""
    row = torch.full((1, 16), n_obs, dtype=torch.int32)
    return PairTables(row_a=row, row_b=row.clone(),
                      key_table=torch.zeros((1, 1), dtype=torch.int32),
                      key_to_obs=torch.ones(n_cameras * n_cameras, dtype=torch.int32),
                      row_pt=torch.full((1, 16), n_points, dtype=torch.int32))


def load_time_tables(cam_idx: np.ndarray, pt_idx: np.ndarray, n_cameras: int,
                     n_points: int) -> dict:
    """The BAProblem table fields (pt_obs_idx, pt_obs_count, cam_obs_idx,
    pairs, cam_obs_pt, pt_banded, cam_banded) of observations sorted by
    point, as CPU tensors."""
    table, counts = _point_segment_table(pt_idx, n_points)
    cam_table = _index_table(cam_idx, n_cameras)
    pairs = _pair_tables_np(pt_idx, cam_idx, n_cameras)
    return dict(
        pt_obs_idx=torch.from_numpy(table),
        pt_obs_count=torch.from_numpy(counts),
        cam_obs_idx=torch.from_numpy(cam_table),
        pairs=None if pairs is None else PairTables(
            **{k_: torch.from_numpy(v) for k_, v in pairs.items()}),
        cam_obs_pt=torch.from_numpy(cam_obs_pt(cam_table, pt_idx, n_points)),
        pt_banded=_banded(pt_idx, n_points, pt_idx, n_points),
        cam_banded=_banded(cam_idx, n_cameras, pt_idx, n_points),
    )


def from_bal_dataset(ds: bal.BalDataset, dtype=torch.float64,
                     inlier_threshold: float = 0.5,
                     avg_focal_length: float = 1.0,
                     device=None) -> BAProblem:
    """Build a BAProblem from raw BAL data with the reference conventions,
    on ``device`` (CUDA unless the caller names one, see resolve_device)."""
    device = resolve_device(device)
    order = np.argsort(ds.pt_idx, kind="stable")
    cam_idx = ds.cam_idx[order]
    pt_idx = ds.pt_idx[order]
    meas = ds.measurements[order] / avg_focal_length

    f = ds.focal / avg_focal_length
    n, m = ds.n_cameras, ds.n_points
    K = np.zeros((n, 3, 3))
    K[:, 0, 0] = -f
    K[:, 1, 1] = -f
    K[:, 2, 2] = 1.0
    k1 = ds.k1 * ds.focal**2
    k2 = ds.k2 * ds.focal**4
    R = rodrigues.exp_rodrigues(torch.from_numpy(np.asarray(ds.omega, np.float64)))

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    state = BAState(K=t(K), R=R.to(dtype), T=t(ds.translation), k1=t(k1),
                    k2=t(k2), points=t(ds.points))
    obs = BAObservations(
        cam_idx=torch.from_numpy(cam_idx.astype(np.int32)),
        pt_idx=torch.from_numpy(pt_idx.astype(np.int32)),
        measurements=t(meas),
        weights=torch.ones(cam_idx.shape[0], dtype=dtype),
        measurements_pl=torch.from_numpy(
            np.ascontiguousarray(meas.T).astype(np.float32)),
    )
    prob = BAProblem(
        state=state,
        obs=obs,
        inlier_threshold=float(inlier_threshold),
        avg_focal_length=float(avg_focal_length),
        **load_time_tables(cam_idx, pt_idx, n, m),
    )
    return prob.to(device)


def load_bal_problem(path: str, dtype=torch.float64,
                     inlier_threshold: float = 0.5,
                     avg_focal_length: float = 1.0,
                     device=None) -> BAProblem:
    """Read a BAL file and build the problem (reference main():50-108).

    Loading is host work; ``device`` only says where the tensors go (CUDA
    unless the caller names one, e.g. ``device="cpu"``)."""
    device = resolve_device(device)
    return from_bal_dataset(bal.read_bal(path), dtype=dtype,
                            inlier_threshold=inlier_threshold,
                            avg_focal_length=avg_focal_length, device=device)


# -- df32 loop state and manifold updates ------------------------------------------


@dataclasses.dataclass
class FastBAState(_Movable):
    """LM state of the df32 drive: camera parameters in float64 (N-sized),
    points as a DF pair of planar (3, M) float32 rows."""

    K: torch.Tensor
    R: torch.Tensor
    T: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    points: tf.DF

    @property
    def focal(self) -> torch.Tensor:
        return camera.focal_length(self.K)


def to_fast(state: BAState) -> FastBAState:
    return FastBAState(
        K=state.K, R=state.R, T=state.T, k1=state.k1, k2=state.k2,
        points=tf.DF(*(p.contiguous() for p in tf.from_array(state.points.T))),
    )


def from_fast(fast: FastBAState, dtype=None) -> BAState:
    dtype = dtype or fast.T.dtype
    pts = tf.to_f64(fast.points) if dtype == torch.float64 else tf.to_f32(fast.points)
    return BAState(K=fast.K, R=fast.R, T=fast.T, k1=fast.k1, k2=fast.k2,
                   points=pts.T.to(dtype))


def _camera_step(K, R, T, k1, k2, dx_cams):
    """Camera manifold update (reference update_params, BAFunctor.h:299-342):
    T += dT; R <- exp([domega]_x) R (left-multiplied); K00, K11 += df;
    k1, k2 += d. ``dx_cams`` is (N, 9) [dT, domega, df, dk1, dk2]."""
    dx = dx_cams.to(T.dtype)
    df_ = dx[:, 6]
    eye_delta = torch.zeros_like(K)
    eye_delta[:, 0, 0] = df_
    eye_delta[:, 1, 1] = df_
    dR = rodrigues.exp_rodrigues(dx[:, 3:6])
    return K + eye_delta, dR @ R, T + dx[:, 0:3], k1 + dx[:, 7], k2 + dx[:, 8]


def apply_step_fast(fast: FastBAState, dx_points, dx_cams) -> FastBAState:
    """df32 manifold update: cameras in float64, points by DF += float32."""
    K, R, T, k1, k2 = _camera_step(fast.K, fast.R, fast.T, fast.k1, fast.k2,
                                   dx_cams)
    pts = tf.add_f(fast.points, dx_points.to(torch.float32).T.contiguous())
    return FastBAState(K=K, R=R, T=T, k1=k1, k2=k2, points=pts)


def apply_step(state: BAState, dx_points, dx_cams) -> BAState:
    """Manifold update in the state dtype; points += dX."""
    K, R, T, k1, k2 = _camera_step(state.K, state.R, state.T, state.k1,
                                   state.k2, dx_cams)
    return BAState(K=K, R=R, T=T, k1=k1, k2=k2,
                   points=state.points + dx_points.to(state.points.dtype))
