"""The port's ellipse-fitting example (``examples/ellipse_fitting_torch.py``)
on the CPU: the assertions of tests/test_examples.py, and the fit against
the JAX example's (``examples/ellipse_fitting.py``, float64) on the same
samples.

Measured on the CPU: both take the same iterations, evaluations and status
on every seed below, and the parameters differ by at most 1.1e-16.
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "examples"))

import ellipse_fitting as jax_example  # noqa: E402
import ellipse_fitting_torch as example  # noqa: E402

from bundleadjustment_benchmarks_tpu_torch.solvers import lm  # noqa: E402

#: The fitted parameters against JAX's, absolute.
PARAM_ATOL = 1e-12


def test_ellipse_fit_recovers_parameters():
    samples = example.sample_ellipse(center=(1.0, -2.0), axes=(3.0, 1.5), phi=0.6)
    result = example.fit_ellipse(samples, device="cpu")
    cx, cy, a, b, phi = result.state.tolist()
    assert result.state.dtype == torch.float64
    assert result.status in (lm.LMStatus.Success, lm.LMStatus.MaxItersReached)
    np.testing.assert_allclose([cx, cy], [1.0, -2.0], atol=0.02)
    np.testing.assert_allclose(sorted([a, b]), [1.5, 3.0], atol=0.05)
    assert result.energy < 0.05


def test_samples_equal_jax_example():
    np.testing.assert_array_equal(example.sample_ellipse(seed=3),
                                  jax_example.sample_ellipse(seed=3))


@pytest.mark.parametrize("seed,noise", [(0, 0.02), (1, 0.05), (2, 0.05), (3, 0.1)])
def test_fit_matches_jax(seed, noise):
    """Same status, iterations and evaluations as JAX's fit; parameters and
    energy to PARAM_ATOL."""
    samples = example.sample_ellipse(seed=seed, noise=noise)
    ref = jax_example.fit_ellipse(samples)
    res = example.fit_ellipse(samples, device="cpu")
    assert (res.status, res.iterations, res.fun_evals) == (
        ref.status, ref.iterations, ref.fun_evals)
    np.testing.assert_allclose(res.state.numpy(), np.asarray(ref.state),
                               rtol=0, atol=PARAM_ATOL)
    assert abs(res.energy - float(ref.energy)) <= PARAM_ATOL


def test_given_start_and_config():
    """An explicit x0 and config run as given: 3 iterations, then the limit."""
    samples = example.sample_ellipse()
    res = example.fit_ellipse(samples, x0=[0.5, -1.5, 2.0, 1.0, 0.3],
                              config=lm.LMConfig(drive="host", max_iter=3),
                              device="cpu")
    ref = jax_example.fit_ellipse(
        samples, x0=np.array([0.5, -1.5, 2.0, 1.0, 0.3]),
        config=jax_example.lm.LMConfig(drive="host", max_iter=3))
    assert res.status == lm.LMStatus.MaxItersReached
    assert res.iterations == ref.iterations == 4
    np.testing.assert_allclose(res.state.numpy(), np.asarray(ref.state),
                               rtol=0, atol=PARAM_ATOL)


def test_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.fit_ellipse(example.sample_ellipse())


def test_main_prints_the_fit(capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "status: Success (Energy Flatlined)"
    assert out[1] == "iterations: 13  funEvals: 34"
    assert out[2].startswith("center=(0.9998, -2.0027) axes=(2.9979, 1.4961)")
