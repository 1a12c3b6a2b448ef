"""BAL (Bundle Adjustment in the Large) dataset ingestion.

File format (reference src/bundle_adjustment_large.cpp:59-108)::

    N M K                    # cameras, points, observations
    camIdx ptIdx x y         # K observation lines
    <9 values per camera>    # Rodrigues omega(3), T(3), f, k1, k2
    <3 values per point>     # X Y Z

Only the raw values are tokenized here; the reference's model conventions
are applied in ``models/problem.py``. ``.gz`` files are decompressed on the
fly and split by numpy (the repository ships its large stand-ins gzipped).
A plain-text file goes through the C++ tokenizer ``native/libbalio.so``
(``make -C native``) when that library is built and loads, and through
numpy otherwise; both give the same float64 token stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import gzip
import os

import numpy as np

#: The repository root, where ``native/libbalio.so`` is built.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@functools.lru_cache(maxsize=None)
def _native_lib():
    """``native/libbalio.so`` loaded with ctypes, or None where it is not
    built or does not load on this machine."""
    path = os.path.join(_ROOT, "native", "libbalio.so")
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.balio_tokenize.restype = ctypes.c_longlong
    lib.balio_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
    return lib


def tokenize(path: str):
    """Whitespace-tokenize a BAL file into a flat float64 array."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return np.array(f.read().split(), dtype=np.float64)
    lib = _native_lib()
    if lib is not None:
        # A token takes at least two bytes (a digit and a separator).
        cap = os.path.getsize(path) // 2 + 16
        out = np.empty(cap, dtype=np.float64)
        n = lib.balio_tokenize(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap)
        if n >= 0:
            return out[:n]
    with open(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.float64)


@dataclasses.dataclass
class BalDataset:
    """Raw BAL file contents (positive focal, raw k1/k2).

    cam_idx/pt_idx: (K,) int32; measurements: (K, 2) float64; omega and
    translation: (N, 3); focal, k1, k2: (N,); points: (M, 3) float64.
    """

    cam_idx: np.ndarray
    pt_idx: np.ndarray
    measurements: np.ndarray
    omega: np.ndarray
    translation: np.ndarray
    focal: np.ndarray
    k1: np.ndarray
    k2: np.ndarray
    points: np.ndarray

    @property
    def n_cameras(self) -> int:
        return self.focal.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_observations(self) -> int:
        return self.cam_idx.shape[0]


def read_bal(path: str) -> BalDataset:
    """Parse a BAL problem file."""
    tok = tokenize(path)
    if tok.size < 3:
        raise ValueError(f"{path}: not a BAL file (fewer than 3 header tokens)")
    n, m, k = int(tok[0]), int(tok[1]), int(tok[2])
    expect = 3 + 4 * k + 9 * n + 3 * m
    if tok.size != expect:
        raise ValueError(
            f"{path}: expected {expect} tokens for N={n} M={m} K={k}, got {tok.size}"
        )
    obs = tok[3 : 3 + 4 * k].reshape(k, 4)
    cams = tok[3 + 4 * k : 3 + 4 * k + 9 * n].reshape(n, 9)
    pts = tok[3 + 4 * k + 9 * n :].reshape(m, 3)
    cam_idx = obs[:, 0].astype(np.int32)
    pt_idx = obs[:, 1].astype(np.int32)
    if cam_idx.size and (cam_idx.min() < 0 or cam_idx.max() >= n):
        raise ValueError(f"{path}: camera index out of range")
    if pt_idx.size and (pt_idx.min() < 0 or pt_idx.max() >= m):
        raise ValueError(f"{path}: point index out of range")
    return BalDataset(
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        measurements=np.ascontiguousarray(obs[:, 2:4]),
        omega=np.ascontiguousarray(cams[:, 0:3]),
        translation=np.ascontiguousarray(cams[:, 3:6]),
        focal=np.ascontiguousarray(cams[:, 6]),
        k1=np.ascontiguousarray(cams[:, 7]),
        k2=np.ascontiguousarray(cams[:, 8]),
        points=pts,
    )


def write_bal(path: str, ds: BalDataset) -> None:
    """Write a BalDataset as BAL text (the inverse of read_bal)."""
    with open(path, "w") as f:
        f.write(f"{ds.n_cameras} {ds.n_points} {ds.n_observations}\n")
        for c, p, (x, y) in zip(ds.cam_idx, ds.pt_idx, ds.measurements):
            f.write(f"{c} {p} {x:.12e} {y:.12e}\n")
        cams = np.concatenate(
            [ds.omega, ds.translation, ds.focal[:, None], ds.k1[:, None],
             ds.k2[:, None]], axis=1)
        for v in cams.reshape(-1):
            f.write(f"{v:.16e}\n")
        for v in ds.points.reshape(-1):
            f.write(f"{v:.16e}\n")
