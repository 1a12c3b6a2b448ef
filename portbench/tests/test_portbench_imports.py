"""Importing the harness and the reference loads neither JAX nor the JAX
package, and the reference loads nothing of the port: top-level module
names, compared whole, in a fresh interpreter."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def top_level(mods):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, mods=mods)],
                         capture_output=True, text=True, timeout=300, check=True,
                         env={**os.environ, "PYTHONPATH": ""})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_no_jax_and_no_port():
    found = top_level(["portbench.reference.ba", "portbench.core.check"])
    assert not found & {"jax", "jaxlib", "flax", "bundleadjustment_benchmarks_tpu",
                        "bundleadjustment_benchmarks_tpu_torch"}


def test_harness_imports_no_jax():
    found = top_level(["portbench.run", "portbench.core.session",
                       "portbench.core.registry", "portbench.core.trace",
                       "bundleadjustment_benchmarks_tpu_torch.solvers.lm"])
    assert "bundleadjustment_benchmarks_tpu_torch" in found
    assert not found & {"jax", "jaxlib", "flax", "bundleadjustment_benchmarks_tpu"}


def test_run_refuses_without_a_card():
    """Without a CUDA device: exit 2, no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "portbench", "run.py"),
                          "--workload", "trafalgar257-df32-cholesky", "--seed", "2147483649",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
