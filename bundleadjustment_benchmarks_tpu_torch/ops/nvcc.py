"""Build one CUDA source of the port with nvcc into a shared library.

The libraries have a plain C interface and are loaded with ctypes. Each is
built at first use into ``_build/`` beside the package, once per content of
its sources and flags (the file name carries their hash), so a checkout
that has built it once loads it at once.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (CUDA_HOME or /usr/local/cuda/bin)")


def build(stem: str, main: str, sources, flags) -> dict:
    """Compile ``csrc/<main>`` (which includes the rest of ``sources``)
    with ``flags`` into ``_build/lib<stem>_<hash>.so`` unless it exists.
    Returns {"library": path, "seconds": build time, "ptxas": nvcc's output}."""
    h = hashlib.sha256()
    for name in sources:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not so.exists():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC / main)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    return {"library": str(so), "seconds": time.perf_counter() - t0,
            "ptxas": log}
