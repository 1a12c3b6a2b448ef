"""The CUDA chain kernels against their plain versions, and each solver
realization against the CPU, on the card.

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test here needs a CUDA device and skips without one. The file imports
nothing of JAX, so it runs where only the port is installed.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bundleadjustment_benchmarks_tpu_torch import cli
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, jacobian
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

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
    ops[8] = ops[8].long()
    with pytest.raises(TypeError, match="cam_idx"):
        cuda_chain.launch("chain_blocks", ops, prob.tau2)


@pytest.mark.parametrize("k", [1, 255, 257, 77391])
def test_prefixes_match_plain(p16_cuda, k):
    """Ragged grids: one observation, one short of a block, one past it,
    all but one of p16."""
    prob, fast = p16_cuda
    obs = cuda_chain._prefix(prob.obs, k)
    ops = cuda_chain.chain_operands(fast, obs)
    rows_k, eb_k = cuda_chain.launch("chain_blocks", ops, prob.tau2)
    _, ee_k = cuda_chain.launch("chain_energy", ops, prob.tau2)
    rows_p, eb_p = cuda_chain.chain_blocks_plain(fast, obs, prob.tau2)
    ee_p = cuda_chain.fused_energy_plain(fast, obs, prob.tau2)
    assert rows_k.shape == (26, k)
    assert torch.equal(rows_k, rows_p)
    assert abs(eb_k.item() - eb_p.item()) <= 1e-12 * abs(eb_p.item())
    assert abs(ee_k.item() - ee_p.item()) <= 1e-12 * abs(ee_p.item())


def test_valid_count_zero_gives_zero(p16_cuda):
    prob, fast = p16_cuda
    ops = cuda_chain.chain_operands(fast, prob.obs)
    rows, eb = cuda_chain.launch("chain_blocks", ops, prob.tau2, valid_count=0)
    _, ee = cuda_chain.launch("chain_energy", ops, prob.tau2, valid_count=0)
    assert eb.item() == 0.0 and ee.item() == 0.0
    assert torch.equal(rows, cuda_chain.chain_blocks_plain(fast, prob.obs,
                                                           prob.tau2)[0])


@pytest.mark.parametrize("which", ["chain_blocks", "chain_energy"])
def test_repeat_launches_identical(p16_cuda, which):
    """Five launches, the first two back to back on one stream (the second
    finds the ticket that the first reset), then three more, each after a
    synchronize."""
    prob, fast = p16_cuda
    ops = cuda_chain.chain_operands(fast, prob.obs)
    energies = [cuda_chain.launch(which, ops, prob.tau2)[1] for _ in range(2)]
    for _ in range(3):
        torch.cuda.synchronize()
        energies.append(cuda_chain.launch(which, ops, prob.tau2)[1])
    values = [e.item() for e in energies]
    assert len(set(values)) == 1, values


@pytest.mark.parametrize("n", [1500, 2500])
def test_cameras_past_shared_memory_match_plain(p16_cuda, n):
    """With more cameras than a block can stage without losing resident
    blocks (1,500 x 27 floats fit in the 227 KB a block may take, but then
    one block of 512 threads fits per SM) or than it can stage at all
    (2,500), each observation fetches and splits its own camera, at the
    residency registers allow; the results are the same. The extra cameras
    repeat camera 0 and are not observed."""
    prob, fast = p16_cuda
    assert cuda_chain.launch_shape("chain_blocks", prob.n_cameras,
                                   prob.n_observations)["staged_cameras"]
    pad = n - prob.n_cameras

    def grow(t):
        return torch.cat([t, t[:1].expand(pad, *t.shape[1:])]).contiguous()

    wide = dataclasses.replace(fast, R=grow(fast.R), T=grow(fast.T),
                               K=grow(fast.K), k1=grow(fast.k1),
                               k2=grow(fast.k2))
    for which in ("chain_blocks", "chain_energy"):
        shape = cuda_chain.launch_shape(which, n, prob.n_observations)
        assert not shape["staged_cameras"]
        assert shape["blocks_per_sm"] >= cuda_chain.launch_shape(
            which, prob.n_cameras, prob.n_observations)["blocks_per_sm"]
    ops = cuda_chain.chain_operands(wide, prob.obs)
    rows_k, eb_k = cuda_chain.launch("chain_blocks", ops, prob.tau2)
    _, ee_k = cuda_chain.launch("chain_energy", ops, prob.tau2)
    rows_p, eb_p = cuda_chain.chain_blocks_plain(fast, prob.obs, prob.tau2)
    ee_p = cuda_chain.fused_energy_plain(fast, prob.obs, prob.tau2)
    assert torch.equal(rows_k, rows_p)
    assert abs(eb_k.item() - eb_p.item()) <= 1e-12 * abs(eb_p.item())
    assert abs(ee_k.item() - ee_p.item()) <= 1e-12 * abs(ee_p.item())


@pytest.mark.parametrize("bad", ["float32", "noncontiguous"])
def test_cameras_must_be_contiguous_float64(p16_cuda, bad):
    prob, fast = p16_cuda
    ops = list(cuda_chain.chain_operands(fast, prob.obs))
    if bad == "float32":
        ops[0] = ops[0].float()
        err, match = TypeError, "R has dtype"
    else:
        ops[0] = ops[0].transpose(1, 2)
        err, match = ValueError, "R must be contiguous"
    for which in ("chain_blocks", "chain_energy"):
        with pytest.raises(err, match=match):
            cuda_chain.launch(which, ops, prob.tau2)


REALIZATIONS = [("cholesky", None), ("qrchol", None), ("moreqr", None),
                ("qrkit", "rows"), ("qrkit", "gram"), ("qrkit", "pair"),
                ("spqr", "tsqr"), ("spqr", "gram")]
#: moreqr's point step comes from the closed-form eigenbasis of V. On p16
#: it lies 1.44e-8 from the exact per-point solve, in the port and in JAX
#: alike on the same blocks (tests/test_torch_modes.py::
#: test_moreqr_point_step_on_p16), so the card's and the CPU's can differ
#: by twice that.
MOREQR_DXP_RTOL = 3e-8


@pytest.fixture(scope="module")
def p16_both(p16_cuda):
    """p16 on the card and on the CPU with the same float64 Jacobian blocks
    (computed on the CPU), and the damping lambda = 1e4 x cholesky's
    initial lambda."""
    prob, _ = p16_cuda
    cpu = prob.to("cpu")
    blocks = jacobian.residuals_and_jacobian(cpu.state, cpu.obs, cpu.tau2)
    ctx = schur.build_context(blocks, cpu, "cholesky")
    lam = 1e4 * float(schur.initial_lambda(ctx, "cholesky"))
    return {"cpu": (cpu, blocks),
            "cuda": (prob, type(blocks)(*(b.to("cuda") for b in blocks)))}, lam


def _step(p16_both, dev, mode, form):
    """One realization's step: qrkit's dense cache on a copy of the problem
    without pair tables, qrkit "gram" and spqr "tsqr" by the reference."""
    (probs, lam) = p16_both
    prob, blocks = probs[dev]
    if mode == "qrkit" and form in ("rows", "gram"):
        prob = dataclasses.replace(prob, pairs=None)
    ctx = schur.build_context(blocks, prob, mode)
    if (mode, form) in (("qrkit", "gram"), ("spqr", "tsqr")):
        step = schur._reference_step(ctx, lam, prob, mode)
    else:
        step = schur.solve_damped(ctx, lam, prob, mode)
    return [s.cpu() for s in step]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("mode,form", REALIZATIONS,
                         ids=[m if f is None else f"{m}-{f}"
                              for m, f in REALIZATIONS])
def test_solve_damped_on_card_matches_cpu(p16_both, mode, form):
    """One float64 damped solve per realization on the card and on the
    CPU, on the same Jacobian blocks: 1e-9 relative for the chol camera
    solver, 1e-7 for the QR realizations; moreqr's point step to
    MOREQR_DXP_RTOL."""
    dxp_g, dxc_g = _step(p16_both, "cuda", mode, form)
    dxp_c, dxc_c = _step(p16_both, "cpu", mode, form)
    tol = 1e-9 if schur.MODE_STRATEGY[mode][1] == "chol" else 1e-7
    tol_p = MOREQR_DXP_RTOL if mode == "moreqr" else tol
    print(f"gap card-CPU {mode} {form} lam={p16_both[1]:.6g}: dxc "
          f"{_rel(dxc_g, dxc_c):.3g}, dxp {_rel(dxp_g, dxp_c):.3g} "
          f"(tolerances {tol:g}, {tol_p:g})")
    assert bool(torch.isfinite(dxp_g).all() and torch.isfinite(dxc_g).all())
    assert _rel(dxc_g, dxc_c) <= tol
    assert _rel(dxp_g, dxp_c) <= tol_p


def test_minimize_goes_through_the_kernels(p16_cuda):
    prob, _ = p16_cuda
    cuda_chain.reset_launches()
    res = lm.minimize(prob, config=lm.LMConfig(
        max_iter=3, matmul_dtype="float32", geometry="df32"))
    prepares = res.iterations - 1  # the last iteration found the limit
    assert cuda_chain.LAUNCHES["chain_blocks"] == prepares
    assert cuda_chain.LAUNCHES["chain_energy"] == res.fun_evals - prepares


def test_sharded_nccl_world_size_1_matches_single(p16_cuda):
    """The sharded path in a process group of one over NCCL, on p16 df32
    with the kernels: lm.minimize's iterations, evaluations and status,
    energies within 1e-12, one blocks launch per prepare."""
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded

    prob, _ = p16_cuda
    cfg = lm.LMConfig(max_iter=4, matmul_dtype="float32", geometry="df32")
    ref = lm.minimize(prob, config=cfg)

    def run(rank, device):
        sp = sharded.shard_problem(prob, 1, rank, device=device)
        return sharded.minimize_sharded(sp, config=cfg)

    assert multihost.backend_for(["cuda:0"]) == "nccl"
    cuda_chain.reset_launches()
    res = multihost.run_ranks(run, ["cuda:0"])[0]
    assert (res.iterations, res.fun_evals, res.status) == (
        ref.iterations, ref.fun_evals, ref.status)
    assert abs(res.energy - ref.energy) <= 1e-12 * ref.energy
    assert cuda_chain.LAUNCHES["chain_blocks"] == res.iterations - 1
    assert res.state.points.shape == (prob.n_points, 3)


def test_cli_mixed_launches_both_kernels(p16_cuda, tmp_path, capsys):
    """The command line on p16 with --precision mixed runs the df32 drive
    through both chain kernels: one blocks launch per prepare, one energy
    launch per trial (one JSONL record each)."""
    cuda_chain.reset_launches()
    metrics = tmp_path / "m.jsonl"
    rc = cli.main([P16, "--precision", "mixed", "--max-iters", "2", "--quiet",
                   "--metrics", str(metrics),
                   "--log-file", str(tmp_path / "run.log")])
    assert rc == cli.RETURN_SUCCESS
    assert "N(cameras) = 16, M(points) = 22106" in capsys.readouterr().out
    records = metrics.read_text().splitlines()
    assert cuda_chain.LAUNCHES["chain_blocks"] == 2
    assert cuda_chain.LAUNCHES["chain_energy"] == len(records) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_cholesky_on_card_matches_cpu(dtype):
    """The blocked Cholesky pair on the card against the same functions on
    the CPU (n = 1,000, padded panels), and an indefinite input's ``info``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bundleadjustment_benchmarks_tpu_torch.ops import linalg

    g = np.random.default_rng(0).normal(size=(1000, 1000))
    S = torch.from_numpy(g @ g.T / 1000 + np.eye(1000)).to(dtype)
    L, info = linalg.blocked_cholesky(S.cuda())
    L_cpu, _ = linalg.blocked_cholesky(S)
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert info.is_cuda and info.item() == 0
    assert (L.cpu() - L_cpu).abs().max().item() <= tol * L_cpu.abs().max().item()
    X = linalg.blocked_tril_inv(L)
    eye = torch.eye(1000, dtype=dtype, device="cuda")
    assert (X @ L - eye).abs().max().item() <= 10 * tol
    S[700, 700] = -10.0
    assert linalg.blocked_cholesky(S.cuda())[1].item() == 701


def test_ellipse_example_on_card():
    """examples/ellipse_fitting_torch.py on the card takes the CPU's path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import ellipse_fitting_torch as example

    samples = example.sample_ellipse()
    res = example.fit_ellipse(samples)
    cpu = example.fit_ellipse(samples, device="cpu")
    assert res.state.is_cuda
    assert (res.status, res.iterations) == (cpu.status, cpu.iterations)
    assert (res.state.cpu() - cpu.state).abs().max().item() <= 1e-10


# -- the device-resident LM drive ----------------------------------------------


@pytest.mark.parametrize("mode", ["cholesky", "qrkit"])
def test_jit_drive_matches_host_on_card(p16_cuda, mode):
    """drive="jit" on p16 df32: the host drive's LM path and energy, both
    chain kernels counted as the graph ran them, a cached capture on the
    second call, and one host read for 5 iterations."""
    prob, _ = p16_cuda
    cfg = lm.LMConfig(max_iter=5, matmul_dtype="float32", geometry="df32")
    host = lm.minimize(prob, mode, cfg)
    cfg = dataclasses.replace(cfg, drive="jit")
    lm.minimize(prob, mode, dataclasses.replace(cfg, max_iter=1))
    assert lm.LAST_JIT_RUN["captured"]
    cuda_chain.reset_launches()
    jit = lm.minimize(prob, mode, cfg)
    assert not lm.LAST_JIT_RUN["captured"] and lm.LAST_JIT_RUN["reads"] == 1
    assert lm.LAST_JIT_RUN["replays"] == 1
    assert (jit.iterations, jit.fun_evals, jit.status) == (
        host.iterations, host.fun_evals, host.status)
    assert abs(jit.energy - host.energy) <= 1e-9 * host.energy
    prepares = jit.iterations - 1
    assert cuda_chain.LAUNCHES["chain_blocks"] == prepares
    assert cuda_chain.LAUNCHES["chain_energy"] == jit.fun_evals - prepares
    lm.clear_graphs()


def test_device_conditionals_on_card():
    """device_if and device_cond inside a DeviceGraph follow their
    predicates at each replay; outside a capture a CUDA predicate raises."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros((), dtype=torch.float64, device="cuda")
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    out = torch.zeros((), dtype=torch.float64, device="cuda")
    graph = cuda_graph.DeviceGraph("cuda")

    def body():
        x.add_(1.0)
        cuda_graph.device_cond(pred, lambda: x * 10.0, lambda: x * -1.0, out)

    graph.capture(lambda: cuda_graph.device_if(pred, body))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert (x.item(), out.item()) == (2.0, 20.0)
    pred.fill_(False)
    graph.replay()
    assert x.item() == 2.0
    graph.close()
    with pytest.raises(RuntimeError, match="outside a DeviceGraph"):
        cuda_graph.device_if(pred, body)


def test_device_while_on_card():
    """device_while inside a DeviceGraph runs its body until its condition,
    recomputed on the device after each pass, is false (a nested device_if
    inside), with the bound read from the device at each replay."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros((), dtype=torch.float64, device="cuda")
    odd = torch.zeros((), dtype=torch.float64, device="cuda")
    bound = torch.full((), 5.0, dtype=torch.float64, device="cuda")
    graph = cuda_graph.DeviceGraph("cuda")

    def body():
        x.add_(1.0)
        cuda_graph.device_if(torch.remainder(x, 2.0) == 1.0,
                             lambda: odd.add_(1.0))

    graph.capture(lambda: cuda_graph.device_while(lambda: x < bound, body))
    graph.replay()
    torch.cuda.synchronize()
    assert (x.item(), odd.item()) == (5.0, 3.0)
    bound.fill_(8.0)
    graph.replay()
    graph.replay()  # the condition is false at once: no pass
    torch.cuda.synchronize()
    assert (x.item(), odd.item()) == (8.0, 4.0)
    graph.close()
    with pytest.raises(RuntimeError, match="outside a DeviceGraph"):
        cuda_graph.device_while(lambda: x < bound, body)
