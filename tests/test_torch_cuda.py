"""The CUDA chain kernels against their plain versions, and each solver
realization against the CPU, on the card.

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test here needs a CUDA device and skips without one. The file imports
nothing of JAX, so it runs where only the port is installed.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu_torch import cli
from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, cuda_graph, jacobian, projection
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P16 = os.path.join(ROOT, "data", "problem-16-22106-pre.txt.gz")
P257 = os.path.join(ROOT, "data", "problem-257-65132-pre.txt.gz")


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


# -- the float64 pair -------------------------------------------------------------

#: The float64 kernels against the plain float64 chain: the rows bit for
#: bit (both round every operation alike: projection.ordered_bmm sums the
#: products in the kernel's order), the energies, summed in other orders,
#: within F64_ENERGY_RTOL.
F64_ENERGY_RTOL = 1e-13


def _stepped_f64(prob, seed):
    """``prob``'s float64 state moved by a seeded step (points 1e-2,
    cameras 1e-3), so that residuals are large and many are outliers."""
    rng = np.random.default_rng(seed)
    step = (torch.from_numpy(rng.normal(scale=1e-2, size=(prob.n_points, 3))),
            torch.from_numpy(rng.normal(scale=1e-3, size=(prob.n_cameras, 9))))
    return pm.apply_step(prob.state, *(t.to(prob.state.T.device) for t in step))


@pytest.fixture(scope="module")
def f64_states(p16_cuda):
    """{"p16": (problem, stepped state), "p257": ...} on the card."""
    prob, _ = p16_cuda
    p257 = pm.load_bal_problem(P257, device="cuda")
    return {"p16": (prob, _stepped_f64(prob, 7)),
            "p257": (p257, _stepped_f64(p257, 8))}


def _f64_launches(state, obs, tau2):
    ops = cuda_chain.f64_operands(state, obs)
    rows, e_blocks = cuda_chain.launch_f64("chain_blocks_f64", ops, tau2)
    _, e_energy = cuda_chain.launch_f64("chain_energy_f64", ops, tau2)
    return rows, e_blocks, e_energy


@pytest.mark.parametrize("name", ["p16", "p257"])
def test_f64_kernels_match_plain(f64_states, name):
    """Both float64 kernels at a stepped state against
    residuals_and_jacobian's rows (bit for bit) and energy and
    projection.energy, one launch counted each."""
    prob, state = f64_states[name]
    before = dict(cuda_chain.LAUNCHES)
    rows, e_blocks, e_energy = _f64_launches(state, prob.obs, prob.tau2)
    assert {k: cuda_chain.LAUNCHES[k] - before[k] for k in before} == {
        "chain_blocks": 0, "chain_energy": 0, "chain_blocks_f64": 1,
        "chain_energy_f64": 1}
    want, e_want = cuda_chain.chain_blocks_f64_plain(state, prob.obs, prob.tau2)
    e_trial = projection.energy(state, prob.obs, prob.tau2).item()
    gap = ((rows - want).abs() / want.abs().amax(1, keepdim=True)).max().item()
    print(f"{name}: rows {gap:.3g} of each row's largest, blocks energy "
          f"{abs(e_blocks.item() / e_want.item() - 1):.3g}, trial energy "
          f"{abs(e_energy.item() / e_trial - 1):.3g}")
    assert rows.shape == want.shape and rows.dtype == torch.float64
    assert torch.equal(rows, want)
    assert abs(e_blocks.item() - e_want.item()) <= F64_ENERGY_RTOL * e_want.item()
    assert abs(e_energy.item() - e_trial) <= F64_ENERGY_RTOL * e_trial


@pytest.mark.parametrize("k", [1, 255, 256, 257, 77391])
def test_f64_prefixes(f64_states, k):
    """Ragged grids (one observation, one short of a block, a block, one
    past it, all but one of p16): each observation's rows are those of the
    whole problem's launch and the plain chain's bit for bit, the energies
    the plain chain's."""
    prob, state = f64_states["p16"]
    rows_all = _f64_launches(state, prob.obs, prob.tau2)[0]
    obs = cuda_chain._prefix(prob.obs, k)
    rows, e_blocks, e_energy = _f64_launches(state, obs, prob.tau2)
    assert rows.shape == (26, k) and torch.equal(rows, rows_all[:, :k])
    assert torch.equal(rows, cuda_chain.chain_blocks_f64_plain(state, obs, prob.tau2)[0])
    e_want = projection.energy(state, obs, prob.tau2).item()
    for e in (e_blocks.item(), e_energy.item()):
        assert abs(e - e_want) <= F64_ENERGY_RTOL * e_want


def test_f64_no_observations(f64_states):
    prob, state = f64_states["p16"]
    rows, e_blocks, e_energy = _f64_launches(state, cuda_chain._prefix(prob.obs, 0),
                                             prob.tau2)
    assert rows.shape == (26, 0)
    assert e_blocks.item() == 0.0 and e_energy.item() == 0.0


@pytest.mark.parametrize("name", ["p16", "p257"])
def test_f64_repeat_launches_identical(f64_states, name):
    """Five launches of each kernel, two back to back and three after a
    synchronize each: the same rows and energies bit for bit."""
    prob, state = f64_states[name]
    runs = [_f64_launches(state, prob.obs, prob.tau2) for _ in range(2)]
    for _ in range(3):
        torch.cuda.synchronize()
        runs.append(_f64_launches(state, prob.obs, prob.tau2))
    for rows, e_blocks, e_energy in runs[1:]:
        assert torch.equal(rows, runs[0][0])
        assert e_blocks.item() == runs[0][1].item()
        assert e_energy.item() == runs[0][2].item()


def test_f64_cameras_past_shared_memory(f64_states):
    """With 2,500 cameras (2,500 x 120 B exceed a block's shared memory)
    each observation reads its own camera: the same rows and energies as
    the staged launch, bit for bit. The extra cameras repeat camera 0 and
    are not observed."""
    prob, state = f64_states["p16"]
    assert cuda_chain.launch_shape("chain_blocks_f64", prob.n_cameras,
                                   prob.n_observations)["staged_cameras"]
    pad = 2500 - prob.n_cameras

    def grow(t):
        return torch.cat([t, t[:1].expand(pad, *t.shape[1:])]).contiguous()

    wide = dataclasses.replace(state, R=grow(state.R), T=grow(state.T),
                               K=grow(state.K), k1=grow(state.k1),
                               k2=grow(state.k2))
    for which in cuda_chain.DRIVE_KERNELS["f64"]:
        assert not cuda_chain.launch_shape(which, 2500,
                                           prob.n_observations)["staged_cameras"]
    got = _f64_launches(wide, prob.obs, prob.tau2)
    want = _f64_launches(state, prob.obs, prob.tau2)
    assert torch.equal(got[0], want[0])
    assert got[1].item() == want[1].item() and got[2].item() == want[2].item()


def test_f64_replay_equals_eager(f64_states):
    """Both float64 kernels captured into a DeviceGraph: each replay gives
    the eager rows and energies bit for bit, and counts one launch of each
    in the device's record."""
    prob, state = f64_states["p257"]
    dev = state.T.device
    graph = cuda_graph.DeviceGraph(dev)
    with torch.cuda.stream(graph.stream):
        cuda_chain.prepare_capture(dev)
        eager = _f64_launches(state, prob.obs, prob.tau2)
    torch.cuda.synchronize()
    cuda_chain.reset_launches()
    out = graph.capture(lambda: _f64_launches(state, prob.obs, prob.tau2))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0])
        assert out[1].item() == eager[1].item() and out[2].item() == eager[2].item()
    cuda_chain.collect_graph_launches()
    assert cuda_chain.LAUNCHES == {"chain_blocks": 0, "chain_energy": 0,
                                   "chain_blocks_f64": 3, "chain_energy_f64": 3}
    graph.close()


def test_jit_f64_one_launch_a_prepare_and_a_trial(p16_cuda):
    """The float64 jit drive on p16 (LMConfig()'s defaults): one blocks
    launch a prepare and one energy launch a trial, counted in the graph
    and brought back by the run's one read, no df32 launch; the LM path of
    the host drive through the same kernels, energies within 1e-9. (Whole
    runs on the kernels and on the plain chain part by the chain's
    rounding, ~6e-7 in the energy after 6 iterations, as lambda follows
    rho; gate (b) of ``bench_torch.py`` holds them iteration by
    iteration.)"""
    prob, _ = p16_cuda
    cfg = lm.LMConfig(max_iter=6)
    host = lm.minimize(prob, config=dataclasses.replace(cfg, drive="host"))
    lm.minimize(prob, config=cfg)  # captures
    cuda_chain.reset_launches()
    res = lm.minimize(prob, config=cfg)
    jit = lm.LAST_JIT_RUN
    assert not jit["captured"] and jit["reads"] == jit["replays"] == 1
    assert cuda_chain.LAUNCHES == {"chain_blocks": 0, "chain_energy": 0,
                                   "chain_blocks_f64": jit["prepares"],
                                   "chain_energy_f64": jit["slots"]}
    assert jit["prepares"] > 0 and jit["slots"] >= jit["prepares"]
    assert (res.iterations, res.fun_evals, res.status) == (
        host.iterations, host.fun_evals, host.status)
    assert abs(res.energy - host.energy) <= 1e-9 * host.energy
    lm.clear_graphs()


def test_polish_runs_the_f64_kernels(p16_cuda):
    """The two-phase drive on p16: the df32 phase launches the df32 pair,
    the float64 polish, from ``from_fast``'s state, the float64 pair; the
    energy descends."""
    prob, _ = p16_cuda
    e0 = lm._prepare(prob.state, prob, "cholesky")[1].item()
    cuda_chain.reset_launches()
    res = lm.minimize(prob, config=lm.LMConfig(
        drive="host", max_iter=3, geometry="df32", matmul_dtype="float32",
        polish_iters=2))
    assert all(n > 0 for n in cuda_chain.LAUNCHES.values()), cuda_chain.LAUNCHES
    assert res.energy < e0


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
        drive="host", max_iter=3, matmul_dtype="float32", geometry="df32"))
    prepares = res.iterations - 1  # the last iteration found the limit
    assert cuda_chain.LAUNCHES["chain_blocks"] == prepares
    assert cuda_chain.LAUNCHES["chain_energy"] == res.fun_evals - prepares


def test_sharded_nccl_world_size_1_matches_single(p16_cuda):
    """The sharded path in a process group of one over NCCL, on p16 df32
    with the kernels: lm.minimize's iterations, evaluations and status,
    energies within 1e-12, one blocks launch per prepare."""
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded

    prob, _ = p16_cuda
    cfg = lm.LMConfig(drive="host", max_iter=4, matmul_dtype="float32",
                      geometry="df32")
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
    cfg = lm.LMConfig(drive="host", max_iter=5, matmul_dtype="float32",
                      geometry="df32")
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


def _camera_solve_replay_equals_eager(n, dtype):
    """The camera solve of ``dtype`` captured in a DeviceGraph and replayed
    on a positive definite and on an indefinite S gives the eager solve's
    x bit for bit, and its fallback counter reads 0 and 1."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    f64 = torch.float64
    gen = torch.Generator().manual_seed(n)
    A = torch.randn((n, n), generator=gen, dtype=f64)
    cases = {"definite": (A @ A.T + n * torch.eye(n, dtype=f64)).to(dev, dtype),
             "indefinite": (A + A.T).to(dev, dtype)}
    b = torch.randn(n, generator=gen, dtype=f64).to(dev, dtype)
    graph = cuda_graph.DeviceGraph(dev)
    # Eagerly on the capture stream first: both branches' cuSOLVER
    # handles and workspaces exist before the capture.
    with torch.cuda.stream(graph.stream):
        eager = {k: schur._camera_solve_chol(S, b) for k, S in cases.items()}
    torch.cuda.synchronize()
    S = cases["definite"].clone()
    x = graph.capture(lambda: schur._camera_solve_chol(S, b))
    for name in ("definite", "indefinite", "definite"):
        S.copy_(cases[name])
        cuda_graph.zero_marks(dev)
        graph.replay()
        torch.cuda.synchronize()
        got = cuda_graph.unpack(cuda_graph.readable(dev).tolist())
        assert got["camera_fallback"] == (name == "indefinite"), name
        assert got["span_counts"]["camera_solve"] == 1, name
        assert x.dtype == dtype and torch.equal(x, eager[name]), name
    graph.close()


@pytest.mark.parametrize("n", [144, 2313])
def test_f64_camera_solve_replay_equals_eager(n):
    """The float64 camera solve (Cholesky, QR on breakdown) replayed
    equals the eager solve (``_camera_solve_replay_equals_eager``)."""
    _camera_solve_replay_equals_eager(n, torch.float64)


@pytest.mark.parametrize("n", [144, 2313])
def test_f32_camera_solve_replay_equals_eager(n):
    """The float32 camera solve (Cholesky, pivoted LU on breakdown, each
    refined twice) replayed equals the eager solve
    (``_camera_solve_replay_equals_eager``)."""
    _camera_solve_replay_equals_eager(n, torch.float32)


# -- the capturable eigensolver and the sharded jit drive ------------------------


@pytest.mark.parametrize("n", [145, 2314])
def test_jacobi_eigh_matches_plain(n):
    """The block Jacobi eigensolver on a float64 SPD matrix of qrkit's
    gram sizes (p16, p257) against torch.linalg.eigh: eigenvalues within
    1e-12 of max|w|, V^T V = I and V diag(w) V^T = S within 1e-12; the
    float32 form within 1e-5; converged (info 0)."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(n)
    G = torch.randn((n, 2 * n), dtype=torch.float64, device="cuda", generator=gen)
    S = G @ G.T / (2 * n)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        w, V, info = cuda_eigh.eigh(S.to(dtype))
        ref = torch.linalg.eigh(S)[0]
        w, V = w.double(), V.double()
        assert int(info) == 0
        assert ((w - ref).abs().max() / ref.abs().max()).item() <= tol
        assert ((V * w) @ V.T - S).norm().item() <= tol * S.norm().item()
        assert (V.T @ V - torch.eye(n, dtype=torch.float64, device="cuda")
                ).abs().max().item() <= 10 * tol


def gram_like(case: str, n: int) -> torch.Tensor:
    """chip_smoke.py's PSD matrix shaped like qrkit's camera grams: "null7"
    (a 7-dimensional null space under 1e-16 noise) or "cluster" (a quarter
    of the eigenvalues within 1e-10 of 1), from numpy's seed n."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke.gram_like(case, n)


@pytest.mark.parametrize("n", [10, 145, 1000, 2314])
@pytest.mark.parametrize("case", ["null7", "cluster"])
def test_jacobi_eigh_gram_like(case, n):
    """The block Jacobi eigensolver on rank-deficient and clustered PSD
    matrices of sizes that are no multiple of its padding (n = 10 is below
    one block pair): the gates of test_jacobi_eigh_matches_plain, and the
    clamped gram square root of schur._gram_sqrt_factor (Jacobi-scaled,
    eigenvalues clamped at 0) gives C^T C within 1e-12 ||S|| of the same
    clamped factor by torch.linalg.eigh."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S = gram_like(case, n)
    eye = torch.eye(n, dtype=torch.float64, device="cuda")
    ref = torch.linalg.eigh(S)[0]
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        w, V, info = cuda_eigh.eigh(S.to(dtype))
        w, V = w.double(), V.double()
        assert int(info) == 0
        assert ((w - ref).abs().max() / ref.abs().max()).item() <= tol
        assert ((V * w) @ V.T - S).norm().item() <= tol * S.norm().item()
        assert (V.T @ V - eye).abs().max().item() <= 10 * tol
    C = schur._gram_sqrt_factor(S)
    d = torch.diagonal(S)
    dinv = torch.where(d > 0, torch.rsqrt(d.abs() + torch.finfo(S.dtype).tiny),
                       torch.ones_like(d))
    Ss = S * dinv[:, None] * dinv[None, :]
    wr, Vr = torch.linalg.eigh((Ss + Ss.T) / 2)
    Cr = torch.sqrt(torch.clamp(wr, min=0.0))[:, None] * Vr.T / dinv[None, :]
    assert (C.T @ C - Cr.T @ Cr).norm().item() <= 1e-12 * S.norm().item()


@pytest.mark.parametrize("n", [145, 1000])
def test_jacobi_eigh_replay_equals_eager(n):
    """jacobi_eigh captured in a DeviceGraph (inside a conditional body, as
    the jit drive holds it) and replayed gives the eager call's w, V and
    info bit for bit. An eager call counts one launch; a captured call
    counts one each time a replay runs it, none where the body is not
    taken."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh, cuda_graph

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S = gram_like("null7", n)
    cuda_eigh.reset_launches()
    w, V, info, _ = cuda_eigh.jacobi_eigh(S)
    assert cuda_eigh.LAUNCHES["jacobi_eigh"] == 1
    graph = cuda_graph.DeviceGraph("cuda")
    with torch.cuda.stream(graph.stream):
        cuda_eigh.prepare_capture(torch.device("cuda"))
        cuda_eigh.jacobi_eigh(S)
    pred = torch.ones((), dtype=torch.bool, device="cuda")
    out = {}

    def body():
        out["w"], out["V"], out["info"], _ = cuda_eigh.jacobi_eigh(S)

    graph.capture(lambda: cuda_graph.device_if(pred, body))
    cuda_eigh.reset_launches()
    graph.replay()
    graph.replay()
    pred.fill_(False)
    graph.replay()
    torch.cuda.synchronize()
    cuda_eigh.collect_graph_launches()
    assert cuda_eigh.LAUNCHES["jacobi_eigh"] == 2
    assert torch.equal(out["w"], w) and torch.equal(out["V"], V)
    assert int(out["info"]) == int(info) == 0
    graph.close()


def test_jacobi_eigh_counters():
    """The kernels' counters on a p16-sized matrix: every pair solve runs
    one inner sweep (eigh.cu's INNER_SWEEPS), pairs rotate in every sweep
    but the last, which rotates none and ends the solve."""
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_eigh

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    S = gram_like("cluster", 145)
    solves = (160 // 32) * (160 // 16 - 1)  # pairs x rounds a sweep, n_pad = 160
    stats = torch.zeros((cuda_eigh.MAX_SWEEPS, 3), dtype=torch.int32, device="cuda")
    w, V, info, sweeps = cuda_eigh.jacobi_eigh(S, stats=stats)
    rows = stats[:int(sweeps)].tolist()
    assert int(info) == 0 and 2 <= len(rows) < cuda_eigh.MAX_SWEEPS
    assert rows[-1][0] == rows[-1][2] == 0
    assert all(r[0] > 0 and r[2] > 0 for r in rows[:-1])
    assert all(r[1] == solves for r in rows)
    assert not stats[int(sweeps):].any()


def test_sharded_jit_nccl_world_size_1_matches_single(p16_cuda):
    """The sharded jit drive in an NCCL group of one on p16 df32: the
    single-device jit drive's iterations, evaluations and status, energy
    within 1e-12, one read per chunk, its collectives counted per prepare
    and per trial; a second run replays the cached capture."""
    from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded

    prob, _ = p16_cuda
    cfg = lm.LMConfig(max_iter=6, matmul_dtype="float32", geometry="df32",
                      drive="jit")
    ref = lm.minimize(prob, config=cfg)

    def run(rank, device):
        sp = sharded.shard_problem(prob, 1, rank, device=device)
        sharded.minimize_sharded(sp, config=cfg)
        res = sharded.minimize_sharded(sp, config=cfg)
        return res, dict(lm.LAST_JIT_RUN)

    res, counts = multihost.run_ranks(run, ["cuda:0"])[0]
    assert (res.iterations, res.fun_evals, res.status) == (
        ref.iterations, ref.fun_evals, ref.status)
    assert abs(res.energy - ref.energy) <= 1e-12 * ref.energy
    assert not counts["captured"] and counts["reads"] == counts["replays"] == 1
    assert counts["allreduce_per_prepare"]["calls"] > 0
    assert counts["allreduce_per_trial"]["calls"] > 0
    assert not [k for k in lm._GRAPHS if k[-1] is not None]  # freed with the group
    lm.clear_graphs()


def test_bench_workload_p16_df32(p16_cuda):
    """``bench_torch.py``'s workload on p16 df32 (cholesky, 20 iterations,
    3 timed runs) on the jit drive: every gate holds, no timed run
    captures, and each launches both chain kernels; gate (d3)'s observed
    run replays the timed graph one iteration a chunk, and gate (e)
    passes."""
    sys.path.insert(0, ROOT)
    try:
        import bench_torch
    finally:
        sys.path.remove(ROOT)
    prob, _ = p16_cuda
    (rec,) = bench_torch.run_workloads(
        prob, "p16", ("cholesky",), bench_torch.campaign.drive_config("df32", 20), 3,
        "cuda", out=lambda _: None)
    lm.clear_graphs()
    assert rec["correct"], rec["gates"]
    assert rec["gates"]["kernels_vs_plain"]["ok"]
    assert rec["gates"]["kernels_vs_plain"]["kernels_captured"] is False
    assert all(r["captured"] is False and r["replays"] > 0 for r in rec["runs"])
    assert all(min(r["launches"][k] for k in cuda_chain.DRIVE_KERNELS["df32"]) > 0
               for r in rec["runs"])
    assert rec["peak_bytes"] > 0 and rec["reserved_bytes"] >= rec["peak_bytes"]
    control = rec["control"]
    assert control["ok"] and control["captured"] is False and control["chunked"]
    # Gate (e) observes every iteration's state: one replay and read each.
    assert control["replays"] == control["reads"] == control["iterations"]
    assert rec["numerics"]["ok"] and rec["numerics"]["checked"] > 0


def test_bench_workload_p16_f64(p16_cuda):
    """``bench_torch.py``'s workload on p16 float64 (cholesky, 20
    iterations, 3 timed runs): every gate holds, gate (b) runs the float64
    kernels against the plain chain, each timed run launches the float64
    pair and no df32 kernel, and gate (e) passes."""
    sys.path.insert(0, ROOT)
    try:
        import bench_torch
    finally:
        sys.path.remove(ROOT)
    prob, _ = p16_cuda
    (rec,) = bench_torch.run_workloads(
        prob, "p16", ("cholesky",), bench_torch.campaign.drive_config("f64", 20), 3,
        "cuda", out=lambda _: None)
    lm.clear_graphs()
    assert rec["correct"], rec["gates"]
    assert rec["gates"]["kernels_vs_plain"]["ok"]
    for r in rec["runs"]:
        assert min(r["launches"][k] for k in cuda_chain.DRIVE_KERNELS["f64"]) > 0
        assert max(r["launches"][k] for k in cuda_chain.DRIVE_KERNELS["df32"]) == 0
    assert rec["numerics"]["ok"] and rec["numerics"]["checked"] > 0


@pytest.mark.parametrize("name,mode", [("p257", "cholesky"), ("p257", "qrchol"),
                                       ("ladybug", "cholesky")],
                         ids=["p257-cholesky", "p257-qrchol", "ladybug-cholesky"])
def test_broken_damping_update_fails_only_gate_d(monkeypatch, name, mode):
    """``bench_torch.py``'s full-width workloads (df32, 100 iterations, one
    timed run) with lambda's factor on an accept inverted (1 / the Nielsen
    factor) in the one function both LM drives use: gates (a)-(c) pass,
    and gate (d) fails, on the damping factor of its float64 prefix (8x
    off the reference's where 1e-2 is allowed), and so does gate (d3), on
    the timed graph's first iteration. The endpoint gate (d1), the
    prefix's gaps and the rule (d3) names are printed (``pytest -rP``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, ROOT)
    try:
        import bench_torch
    finally:
        sys.path.remove(ROOT)
    nielsen = lm._nielsen
    monkeypatch.setattr(lm, "_nielsen", lambda rho: 1.0 / nielsen(rho))
    lm.clear_graphs()
    problem, _ = bench_torch.campaign.load_problem(name, torch.device("cuda"))
    cfg = bench_torch.campaign.drive_config("df32", bench_torch.MAX_ITER)
    try:
        (rec,) = bench_torch.run_workloads(problem, name, (mode,), cfg, 1, "cuda",
                                           out=lambda _: None)
    finally:
        lm.clear_graphs()
    ref = rec["reference"]
    print(f"broken damping, {name} {mode}: {rec['status']} after "
          f"{rec['iterations']} iterations, energy {rec['energy']}, gates {rec['gates']}, "
          f"endpoint {ref['endpoint'] and ref['endpoint']['gaps']} "
          f"{ref.get('endpoint_none', '')}, prefix {ref['prefix']['gaps']}, "
          f"control {rec['control']['broken']}")
    gates = rec["gates"]
    assert gates["replay"] and gates["no_capture_in_window"] and gates["descent"]
    assert gates["kernels_vs_plain"]["ok"]
    assert gates["reference"] is False and not rec["correct"]
    assert gates["control"] is False
    assert rec["control"]["broken"]["rule"] == "accept"
    assert rec["control"]["broken"]["iteration"] == 1
    assert ref["prefix"]["gaps"]["lam_factor_rel"] > bench_torch.oracle_prefix.LAM_FACTOR_REL
