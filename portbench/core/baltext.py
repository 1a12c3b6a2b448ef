"""BAL text reader, frozen for the benchmark.

Copied from ``bundleadjustment_benchmarks_tpu_torch/io/bal.py`` at commit
306ffbcb20dbd48e32330260e2650eb0bfef3067 (``tokenize`` for ``.gz`` files
and ``read_bal``), returning plain numpy arrays. File format::

    N M K                    # cameras, points, observations
    camIdx ptIdx x y         # K observation lines
    <9 values per camera>    # Rodrigues omega(3), T(3), f, k1, k2
    <3 values per point>     # X Y Z
"""

from __future__ import annotations

import gzip
import hashlib

import numpy as np

#: The raw arrays of a BAL problem, as read from its file: positive focal,
#: raw k1 and k2.
FIELDS = ("cam_idx", "pt_idx", "measurements", "omega", "translation",
          "focal", "k1", "k2", "points")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def tokenize(path: str) -> np.ndarray:
    """Whitespace-tokenize a BAL file (plain or ``.gz``) into float64."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return np.array(f.read().split(), dtype=np.float64)


def read_bal(path: str) -> dict:
    """The raw arrays of a BAL problem file, keyed by ``FIELDS``."""
    tok = tokenize(path)
    if tok.size < 3:
        raise ValueError(f"{path}: not a BAL file (fewer than 3 header tokens)")
    n, m, k = int(tok[0]), int(tok[1]), int(tok[2])
    expect = 3 + 4 * k + 9 * n + 3 * m
    if tok.size != expect:
        raise ValueError(
            f"{path}: expected {expect} tokens for N={n} M={m} K={k}, got {tok.size}")
    obs = tok[3:3 + 4 * k].reshape(k, 4)
    cams = tok[3 + 4 * k:3 + 4 * k + 9 * n].reshape(n, 9)
    pts = tok[3 + 4 * k + 9 * n:].reshape(m, 3)
    cam_idx = obs[:, 0].astype(np.int32)
    pt_idx = obs[:, 1].astype(np.int32)
    if cam_idx.size and (cam_idx.min() < 0 or cam_idx.max() >= n):
        raise ValueError(f"{path}: camera index out of range")
    if pt_idx.size and (pt_idx.min() < 0 or pt_idx.max() >= m):
        raise ValueError(f"{path}: point index out of range")
    return {
        "cam_idx": cam_idx,
        "pt_idx": pt_idx,
        "measurements": np.ascontiguousarray(obs[:, 2:4]),
        "omega": np.ascontiguousarray(cams[:, 0:3]),
        "translation": np.ascontiguousarray(cams[:, 3:6]),
        "focal": np.ascontiguousarray(cams[:, 6]),
        "k1": np.ascontiguousarray(cams[:, 7]),
        "k2": np.ascontiguousarray(cams[:, 8]),
        "points": np.ascontiguousarray(pts),
    }
