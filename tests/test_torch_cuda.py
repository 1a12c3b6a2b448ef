"""The CUDA chain kernels against their plain versions, on the card.

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test here needs a CUDA device and skips without one. The file imports
nothing of JAX, so it runs where only the port is installed.
"""

import os

import numpy as np
import pytest
import torch

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain
from bundleadjustment_benchmarks_tpu_torch.solvers import lm

pytestmark = pytest.mark.cuda

P16 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "data", "problem-16-22106-pre.txt.gz")


@pytest.fixture(scope="module")
def p16_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prob = pm.load_bal_problem(P16, device="cuda")
    rng = np.random.default_rng(7)
    step = (torch.from_numpy(rng.normal(scale=1e-2, size=(prob.n_points, 3))),
            torch.from_numpy(rng.normal(scale=1e-3, size=(prob.n_cameras, 9))))
    fast = pm.apply_step_fast(pm.to_fast(prob.state),
                              *(s.to("cuda") for s in step))
    return prob, fast


def test_blocks_kernel_matches_plain(p16_cuda):
    prob, fast = p16_cuda
    before = cuda_chain.LAUNCHES["chain_blocks"]
    rows_k, e_k = cuda_chain.launch(
        "chain_blocks", cuda_chain.chain_operands(fast, prob.obs), prob.tau2)
    rows_p, e_p = cuda_chain.chain_blocks_plain(fast, prob.obs, prob.tau2)
    assert cuda_chain.LAUNCHES["chain_blocks"] == before + 1
    # Both round every operation alike (no contraction): the rows are equal.
    assert torch.equal(rows_k, rows_p)
    assert abs(e_k.item() - e_p.item()) <= 1e-12 * abs(e_p.item())


def test_energy_kernel_matches_plain_and_repeats(p16_cuda):
    prob, fast = p16_cuda
    e = [cuda_chain.fused_energy(fast, prob.obs, prob.tau2).item()
         for _ in range(3)]
    e_p = cuda_chain.fused_energy_plain(fast, prob.obs, prob.tau2).item()
    assert len(set(e)) == 1
    assert abs(e[0] - e_p) <= 1e-12 * abs(e_p)


@pytest.mark.parametrize("valid", [1, 1000, 77392])
def test_valid_count(p16_cuda, valid):
    prob, fast = p16_cuda
    e_k = cuda_chain.fused_energy(fast, prob.obs, prob.tau2, valid_count=valid)
    e_p = cuda_chain.fused_energy_plain(fast, prob.obs, prob.tau2,
                                        valid_count=valid)
    assert abs(e_k.item() - e_p.item()) <= 1e-12 * abs(e_p.item())


def test_wrong_operands_raise(p16_cuda):
    prob, fast = p16_cuda
    ops = list(cuda_chain.chain_operands(fast, prob.obs))
    ops[4] = ops[4].long()
    with pytest.raises(TypeError, match="cam_idx"):
        cuda_chain.launch("chain_blocks", ops, prob.tau2)


def test_minimize_goes_through_the_kernels(p16_cuda):
    prob, _ = p16_cuda
    cuda_chain.reset_launches()
    res = lm.minimize(prob, config=lm.LMConfig(
        max_iter=3, matmul_dtype="float32", geometry="df32"))
    prepares = res.iterations - 1  # the last iteration found the limit
    assert cuda_chain.LAUNCHES["chain_blocks"] == prepares
    assert cuda_chain.LAUNCHES["chain_energy"] == res.fun_evals - prepares
