"""The port's sharded path (``parallel/sharded.py``) against the JAX
package's on the CPU, at D = 2.

JAX runs ``sharded.make_sharded_kernels`` / ``minimize_sharded`` on the
virtual 8-device mesh of tests/conftest.py; the port runs D gloo ranks that
``multihost.run_ranks`` spawns once for the whole file (the module fixture
``ranks``). Both get the same problems, made by the JAX package's
synthetic generator and carried across by ``convert.py``. Tolerances are
the JAX package's own, sharded against its single-device path
(tests/test_sharded.py): prepare energy 1e-12, lambda0 1e-10, U and g_cams
1e-9; a float64 trial's energy and rho 1e-9, its points and cameras 1e-7;
a df32 trial 2e-3 (float32 sums in another order, amplified by the reduced
system's conditioning).

Gaps print with ``pytest -rP``.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.io.bal import BalDataset as JBalDataset
from bundleadjustment_benchmarks_tpu.models import problem as jpm
from bundleadjustment_benchmarks_tpu.models.problem import from_bal_dataset as jfrom_bal
from bundleadjustment_benchmarks_tpu.ops import projection as jproj
from bundleadjustment_benchmarks_tpu.parallel import sharded as jsharded
from bundleadjustment_benchmarks_tpu.solvers import lm as jlm
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.parallel import multihost, sharded
from bundleadjustment_benchmarks_tpu_torch.solvers import lm
from bundleadjustment_benchmarks_tpu_torch.utils import checkpoint

import torch_sharded_worker as worker
from conftest import make_synthetic_problem

MODES = worker.MODES
D = 2
#: A spawned group's run, and any single process group, fails after this.
TIMEOUT = 240.0


def skewed_problem():
    """tests/test_sharded.py's skewed problem: camera 0 observes every one
    of 40 points, the other observations stay, so per-shard tables are
    uneven."""
    problem = make_synthetic_problem(n_cameras=5, n_points=40, obs_per_point=2,
                                     seed=11)
    obs, st = problem.obs, problem.state
    cam_idx, pt_idx = np.asarray(obs.cam_idx), np.asarray(obs.pt_idx)
    meas = np.asarray(obs.measurements)
    extra = np.arange(40, dtype=np.int32)
    keep = cam_idx != 0
    cam_idx = np.concatenate([cam_idx[keep], np.zeros(40, np.int32)])
    pt_idx = np.concatenate([pt_idx[keep], extra])
    z = np.zeros(40, int)
    p0 = jproj.project_affine(st.K[z], st.R[z], st.T[z], st.k1[z], st.k2[z],
                              st.points[extra])
    meas = np.concatenate([meas[keep], np.asarray(p0) + 0.01])
    order = np.argsort(pt_idx, kind="stable")
    ds = JBalDataset(cam_idx=cam_idx[order], pt_idx=pt_idx[order],
                     measurements=meas[order], omega=np.zeros((5, 3)),
                     translation=np.asarray(st.T), focal=-np.asarray(st.K[:, 0, 0]),
                     k1=np.zeros(5), k2=np.zeros(5), points=np.asarray(st.points))
    skew = jfrom_bal(ds, dtype=jnp.float64)
    return dataclasses.replace(skew, state=dataclasses.replace(
        skew.state, R=st.R, K=st.K, k1=st.k1, k2=st.k2))


def mixed_problem():
    """Points 0-29 seen once, points 30-34 three times: split by
    observation count, the first shards hold only points seen once (no
    pair tables of their own) while the last has pairs."""
    problem = make_synthetic_problem(n_cameras=4, n_points=35, obs_per_point=3,
                                     seed=5)
    obs, st = problem.obs, problem.state
    pt_idx = np.asarray(obs.pt_idx)
    first = np.r_[True, pt_idx[1:] != pt_idx[:-1]]
    keep = (pt_idx >= 30) | first
    ds = JBalDataset(cam_idx=np.asarray(obs.cam_idx)[keep], pt_idx=pt_idx[keep],
                     measurements=np.asarray(obs.measurements)[keep],
                     omega=np.zeros((4, 3)), translation=np.asarray(st.T),
                     focal=-np.asarray(st.K[:, 0, 0]), k1=np.zeros(4),
                     k2=np.zeros(4), points=np.asarray(st.points))
    mixed = jfrom_bal(ds, dtype=jnp.float64)
    return dataclasses.replace(mixed, state=dataclasses.replace(
        mixed.state, R=st.R, K=st.K, k1=st.k1, k2=st.k2))


@functools.lru_cache(maxsize=None)
def jax_problem(name: str):
    """The problems of both files: test_sharded.py's, its LM problem
    ("syn3t") at tau = 2 px. At 0.5 px the energy is a ladder of
    truncation plateaus and rounding picks the rung: JAX's own sharded and
    single-device runs of that problem end 2.0e-6 apart after 8 iterations
    (its test holds 1e-5); at 2 px the port's and JAX's sharded runs agree
    to 7.5e-14 (D = 2) and 2.9e-12 (D = 4)."""
    if name in ("skew", "mixed"):
        return {"skew": skewed_problem, "mixed": mixed_problem}[name]()
    kw = {"syn2": dict(seed=2), "syn2t": dict(seed=2, inlier_threshold=2.0),
          "syn3t": dict(n_points=24, seed=3, inlier_threshold=2.0),
          "syn7": dict(n_points=20, seed=7, inlier_threshold=2.0)}[name]
    return make_synthetic_problem(**{"n_cameras": 4, "n_points": 30,
                                     "obs_per_point": 3, **kw})


def problem_arrays(names) -> dict:
    return {k: convert.problem_to_numpy(jax_problem(k)) for k in names}


STEP_PROBLEMS = ("syn2", "skew", "mixed")


def step_cases(problems=STEP_PROBLEMS) -> list:
    """float64 prepares and trials at lambda 0.05, every mode, on
    ``problems``: the cases both files run, each at its own D."""
    return [dict(name=f"trial-{mode}-{prob}", kind="step", problem=prob,
                 mode=mode, lam=0.05)
            for mode in MODES for prob in problems]


@functools.lru_cache(maxsize=None)
def jax_step(name: str, d: int, mode: str, lam: float, df32: bool = False) -> dict:
    """JAX's sharded prepare and one trial at ``lam`` on a d-device mesh."""
    jp = jax_problem(name)
    mesh = jsharded.make_mesh(d)
    sp = jsharded.shard_problem(jp, mesh)
    kw = dict(matmul_dtype="float32", geometry="df32") if df32 else {}
    prepare, trial = jsharded.make_sharded_kernels(sp, mesh, mode, **kw)
    x0 = jpm.to_fast(sp.state) if df32 else sp.state
    ctx, energy, lam0 = jax.jit(prepare)(x0)
    x, e, rho = jax.jit(trial)(ctx, x0, lam)
    if df32:
        x = jpm.BAState(K=x.K, R=x.R, T=x.T, k1=x.k1, k2=x.k2,
                        points=(x.points.hi.astype(jnp.float64)
                                + x.points.lo.astype(jnp.float64)).T)
    return {"energy": float(energy), "lam0": float(lam0), "U": np.asarray(ctx.U),
            "g_cams": np.asarray(ctx.g_cams), "e": float(e), "rho": float(rho),
            "T": np.asarray(x.T),
            "points": np.asarray(jsharded.unshard_points(sp, x))}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def assert_prepare(port, ref, label):
    print(f"gap sharded prepare {label}: energy {_rel(port['energy'], ref['energy']):.3g}, "
          f"lam0 {_rel(port['lam0'], ref['lam0']):.3g}")
    np.testing.assert_allclose(port["energy"], ref["energy"], rtol=1e-12)
    np.testing.assert_allclose(port["lam0"], ref["lam0"], rtol=1e-10)
    np.testing.assert_allclose(port["U"], ref["U"], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(port["g_cams"], ref["g_cams"], rtol=1e-9, atol=1e-12)


def assert_trial(port, ref, label):
    print(f"gap sharded trial {label}: e {_rel(port['e'], ref['e']):.3g}, "
          f"rho {_rel(port['rho'], ref['rho']):.3g}")
    np.testing.assert_allclose(port["energy"], ref["energy"], rtol=1e-12)
    np.testing.assert_allclose(port["e"], ref["e"], rtol=1e-9)
    np.testing.assert_allclose(port["rho"], ref["rho"], rtol=1e-9)
    np.testing.assert_allclose(port["points"], ref["points"], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(port["T"], ref["T"], rtol=1e-7, atol=1e-12)


def assert_ranks_identical(outs):
    """Every rank's results equal rank 0's bit for bit, but the seconds of
    ``LAST_JIT_RUN``'s spans (``device_s``), which each rank's own clock
    reads; their counts (``span_counts``) are held."""
    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a
                                                 if k != "device_s")
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    for out in outs[1:]:
        for name in outs[0]:
            if name != "_rank":
                assert same(out[name], outs[0][name]), (name, out["_rank"])
    assert [o["_rank"] for o in outs] == list(range(len(outs)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    return {"checkpoint": str(d / "d2.ckpt.npz"), "metrics": str(d / "d2.jsonl"),
            "jit_checkpoint": str(d / "d2.jit.ckpt.npz"),
            "jit_metrics": str(d / "d2.jit.jsonl")}


@pytest.fixture(scope="module")
def ranks(files):
    """Every case of this file, once, on D gloo ranks on the CPU."""
    case_list = step_cases()
    for mode in MODES:
        case_list.append(dict(name=f"df32-{mode}", kind="step", problem="syn2t",
                              mode=mode, lam=1.0, config=worker.DF32))
    case_list += [
        dict(name="minimize", kind="minimize", problem="syn3t", mode="cholesky",
             config=dict(max_iter=8, drive="host")),
        dict(name="checkpoint", kind="checkpoint", problem="syn3t", max_iter=5,
             every=2, **files),
        dict(name="polish", kind="minimize", problem="syn7", mode="cholesky",
             config=dict(max_iter=10, polish_iters=4, drive="host", **worker.DF32)),
        dict(name="no-polish", kind="minimize", problem="syn7", mode="cholesky",
             config=dict(max_iter=10, drive="host", **worker.DF32)),
        dict(name="refine", kind="refine", problem="syn3t"),
        # The jit drive (lm.DeviceLoop, eager over gloo on the CPU).
        dict(name="jit-df32", kind="minimize", problem="syn2t", mode="cholesky",
             config=dict(max_iter=8, drive="jit", **worker.DF32)),
        dict(name="host-df32", kind="minimize", problem="syn2t", mode="cholesky",
             config=dict(max_iter=8, drive="host", **worker.DF32)),
        dict(name="jit-first-trial-df32", kind="jit_first_trial", problem="syn2t",
             mode="cholesky", lam=1.0, config=worker.DF32),
        dict(name="jit-polish", kind="minimize", problem="syn7", mode="cholesky",
             config=dict(max_iter=10, polish_iters=4, drive="jit", **worker.DF32)),
        dict(name="jit-checkpoint", kind="checkpoint", problem="syn3t",
             max_iter=5, every=2, drive="jit", checkpoint=files["jit_checkpoint"],
             metrics=files["jit_metrics"]),
        dict(name="jit-counts", kind="jit_counts", problem="syn3t", mode="qrkit",
             config=dict(max_iter=4)),
    ]
    for mode in MODES:
        for drive in ("jit", "host"):
            case_list.append(dict(name=f"{drive}-{mode}", kind="minimize",
                                  problem="syn3t", mode=mode,
                                  config=dict(max_iter=8, drive=drive)))
    arrays = problem_arrays({c["problem"] for c in case_list})
    return multihost.run_ranks(worker.cases, ["cpu"] * D,
                               args=(case_list, arrays), timeout=TIMEOUT)


def port_problem(name: str):
    return convert.problem_from_numpy(convert.problem_to_numpy(jax_problem(name)),
                                      device="cpu")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_layout_matches_jax(d):
    """Every rank's observations and points are JAX's real (unpadded) rows
    of that shard, and the meta agrees."""
    for name in ("syn2", "skew"):
        jp, tp = jax_problem(name), port_problem(name)
        jsp = jsharded.shard_problem(jp, jsharded.make_mesh(d))
        ks, ms = jsp.obs_per_shard, jsp.points_per_shard
        counts = np.asarray(jsp.obs_counts)
        for r in range(d):
            sp = sharded.shard_problem(tp, d, r, device="cpu")
            assert sp.pt_starts == jsp.pt_starts
            assert sp.n_points_global == jsp.n_points_global
            lo, hi = sp.pt_range
            nloc = int(counts[r])
            assert sp.problem.n_observations == nloc
            for field in ("cam_idx", "pt_idx", "measurements"):
                want = np.asarray(getattr(jsp.obs, field)).reshape(
                    (d, ks) + getattr(tp.obs, field).shape[1:])[r, :nloc]
                np.testing.assert_array_equal(
                    getattr(sp.problem.obs, field).numpy(), want)
            want_pts = np.asarray(jsp.state.points).reshape(d, ms, 3)[r, :hi - lo]
            np.testing.assert_array_equal(sp.problem.state.points.numpy(), want_pts)
            np.testing.assert_array_equal(sp.problem.state.T.numpy(),
                                          np.asarray(jp.state.T))


def test_shards_without_pairs_carry_empty_pair_tables():
    """Where other shards have pair tables, a shard of points seen once
    carries tables without a pair, so that every rank takes one path."""
    tp = port_problem("mixed")
    assert tp.pairs is not None
    sp = sharded.shard_problem(tp, 2, 0, device="cpu")
    assert int(sp.problem.pt_obs_count.max()) == 1
    pairs = sp.problem.pairs
    assert pairs is not None and pairs.row_a.shape == (1, 16)
    assert bool((pairs.row_a == sp.problem.n_observations).all())
    assert bool((pairs.key_to_obs == pairs.key_table.shape[0]).all())
    assert sharded.shard_problem(tp, 2, 1, device="cpu").problem.pairs.row_a.shape[0] > 1


def test_shard_problem_refuses_empty_shards():
    tp = port_problem("syn2")
    with pytest.raises(ValueError, match="without observations"):
        sharded.shard_problem(tp, 31, 0, device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        sharded.shard_problem(tp, 2, 2, device="cpu")


@pytest.mark.parametrize("mode", MODES)
def test_prepare_matches_jax(ranks, mode):
    assert_prepare(ranks[0][f"trial-{mode}-syn2"],
                   jax_step("syn2", D, mode, 0.05), f"D={D} {mode}")


@pytest.mark.parametrize("prob", STEP_PROBLEMS)
@pytest.mark.parametrize("mode", MODES)
def test_trial_matches_jax(ranks, mode, prob):
    assert_trial(ranks[0][f"trial-{mode}-{prob}"],
                 jax_step(prob, D, mode, 0.05), f"D={D} {mode} {prob}")


@pytest.mark.parametrize("mode", MODES)
def test_df32_trial_matches_jax(ranks, mode):
    """The df32 drive on the plain chain against JAX's df32 sharded trial
    (its Pallas chain interpreted): 2e-3, and the step descends. The
    prepare energy to 1e-5: the two packages' DF chains differ by ~1e-6
    relative on the CPU (ROADMAP Queue 3)."""
    port = ranks[0][f"df32-{mode}"]
    ref = jax_step("syn2t", D, mode, 1.0, df32=True)
    print(f"gap sharded df32 {mode}: energy {_rel(port['energy'], ref['energy']):.3g}, "
          f"e {_rel(port['e'], ref['e']):.3g}, rho {_rel(port['rho'], ref['rho']):.3g}")
    np.testing.assert_allclose(port["energy"], ref["energy"], rtol=1e-5)
    np.testing.assert_allclose(port["e"], ref["e"], rtol=2e-3)
    np.testing.assert_allclose(port["rho"], ref["rho"], rtol=2e-3)
    assert port["e"] < port["energy"]
    np.testing.assert_allclose(port["points"], ref["points"], rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(port["T"], ref["T"], rtol=5e-3, atol=1e-6)


def jax_minimize(name, d, max_iter, **kw):
    mesh = jsharded.make_mesh(d)
    return jsharded.minimize_sharded(
        jsharded.shard_problem(jax_problem(name), mesh), mesh, mode="cholesky",
        config=jlm.LMConfig(drive="host", max_iter=max_iter), **kw)


def test_minimize_matches_jax(ranks):
    """float64 cholesky, up to 8 iterations, at D = 2 in both packages: the
    same iterations, evaluations and status; energy within 1e-9."""
    ref = jax_minimize("syn3t", D, 8)
    port = ranks[0]["minimize"]
    gap = _rel(port["energy"], ref.energy)
    print(f"gap sharded minimize D={D}: iterations {port['iterations']}, "
          f"fun_evals {port['fun_evals']}, energy {gap:.3g}")
    assert (port["iterations"], port["fun_evals"], port["status"]) == (
        ref.iterations, ref.fun_evals, int(ref.status))
    assert gap <= 1e-9
    assert port["points"].shape == (jax_problem("syn3t").n_points, 3)


def test_checkpoint_metrics_resume_at_other_shard_counts(ranks, files):
    """A run at D = 2 stopped at 5 iterations that checkpoints every 2 and
    writes metrics (rank 0 alone: one record per trial), against JAX's; its
    checkpoint holds all points and resumes at D = 1 (a process group of
    one) and on one device with no group. Both resumes take JAX's resumed
    run's iterations, evaluations and status, and end within 1e-9 of its
    energy and of the uninterrupted run's."""
    tp = port_problem("syn3t")
    port = ranks[0]["checkpoint"]
    records = [json.loads(ln) for ln in open(files["metrics"])]
    state, meta = checkpoint.load_checkpoint(files["checkpoint"], device="cpu")

    from bundleadjustment_benchmarks_tpu.utils import checkpoint as jckpt

    jck = files["checkpoint"].replace(".npz", ".jax.npz")
    jres = jax_minimize("syn3t", D, 5, checkpoint_path=jck, checkpoint_every=2)
    jstate, jmeta = jckpt.load_checkpoint(jck)
    assert port["iterations"] == jres.iterations == 6
    assert len(records) == port["fun_evals"] - 5
    assert {"iter", "status", "f", "lambda"} <= set(records[0])
    assert meta["iteration"] == jmeta["iteration"] == 4
    assert meta["fun_evals"] == jmeta["fun_evals"]
    assert state.points.shape == (tp.n_points, 3)

    case = dict(name="resume", kind="resume", problem="syn3t", max_iter=8,
                checkpoint=files["checkpoint"])
    d1 = multihost.run_ranks(worker.run_case, ["cpu"], args=(case, {"syn3t": tp}),
                             timeout=TIMEOUT)[0]
    one = lm.minimize(tp, config=lm.LMConfig(drive="host", max_iter=8), state=state,
                      resume=meta, device="cpu")
    mesh = jsharded.make_mesh(D)
    jres2 = jsharded.minimize_sharded(
        jsharded.shard_problem(dataclasses.replace(jax_problem("syn3t"),
                                                   state=jstate), mesh),
        mesh, mode="cholesky", config=jlm.LMConfig(drive="host", max_iter=8),
        resume=jmeta)
    whole = ranks[0]["minimize"]
    print(f"gap sharded resume: D=1 {_rel(d1['energy'], jres2.energy):.3g}, "
          f"one device {_rel(one.energy, jres2.energy):.3g}, D=1 against the "
          f"uninterrupted run {_rel(d1['energy'], whole['energy']):.3g}")
    for res in (d1, dict(iterations=one.iterations, fun_evals=one.fun_evals,
                         status=int(one.status), energy=one.energy)):
        assert (res["iterations"], res["fun_evals"], res["status"]) == (
            jres2.iterations, jres2.fun_evals, int(jres2.status))
        assert _rel(res["energy"], jres2.energy) <= 1e-9
        assert _rel(res["energy"], whole["energy"]) <= 1e-9


def test_polish_two_phase(ranks):
    """The two-phase drive on the shards: the float64 polish runs (more
    iterations than the df32 run alone), ends no higher than 1% above it,
    and returns a float64 state."""
    both, fast = ranks[0]["polish"], ranks[0]["no-polish"]
    print(f"sharded polish: {fast['iterations']} -> {both['iterations']} "
          f"iterations, energy {fast['energy']:.6g} -> {both['energy']:.6g}")
    assert both["iterations"] > fast["iterations"]
    assert both["energy"] <= fast["energy"] * 1.01
    assert both["dtype"] == "torch.float64"


def test_refine_steps_raises(ranks):
    assert "not supported on the sharded path" in ranks[0]["refine"]


def test_every_rank_identical(ranks):
    """Each rank solves the replicated camera system itself and takes the
    accept decisions on the reduced scalars: all ranks end with the same
    bytes (cameras, points, lambda, counts) in every case."""
    assert_ranks_identical(ranks)
    assert {o["_backend"] for o in ranks} == {"gloo"}


def test_dryrun_multichip_cpu():
    """The dry run at 2 ranks on the CPU: one prepare and one trial per
    configuration, finite and equal on both ranks (it raises otherwise),
    eager (gloo: no capture); no kernel launches off CUDA."""
    out = sharded.dryrun_multichip(2, devices=["cpu", "cpu"], timeout=TIMEOUT)
    assert out["backend"] == "gloo" and out["captured"] is False
    assert set(out) == {name for name, _, _ in sharded.DRYRUN_CONFIGS} | {
        "launches", "backend", "captured"}
    for name, _, _ in sharded.DRYRUN_CONFIGS:
        assert np.isfinite(out[name]).all()
    assert out["launches"] == {"chain_blocks": 0, "chain_energy": 0,
                               "chain_blocks_f64": 0, "chain_energy_f64": 0}


def test_sharded_needs_a_group():
    sp = sharded.shard_problem(port_problem("syn2"), 1, 0, device="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        sharded.minimize_sharded(sp)
    assert not torch.distributed.is_initialized()


# -- the sharded jit drive --------------------------------------------------------


def jax_minimize_jit(name, d, mode, max_iter):
    mesh = jsharded.make_mesh(d)
    return jsharded.minimize_sharded(
        jsharded.shard_problem(jax_problem(name), mesh), mesh, mode=mode,
        config=jlm.LMConfig(drive="jit", max_iter=max_iter))


def _same_run(a, b):
    """Two runs' results equal bit for bit (counts, energy, lambda, state)."""
    assert (a["iterations"], a["fun_evals"], a["status"]) == (
        b["iterations"], b["fun_evals"], b["status"])
    assert repr(a["energy"]) == repr(b["energy"]) and repr(a["lam"]) == repr(b["lam"])
    assert np.array_equal(a["points"], b["points"]) and np.array_equal(a["T"], b["T"])


@pytest.mark.parametrize("mode", MODES)
def test_jit_matches_host_and_jax(ranks, mode):
    """float64, up to 8 iterations at D = 2: the port's sharded jit drive
    equals its sharded host drive bit for bit, and takes JAX's sharded jit
    drive's iterations, evaluations and status, energy within 1e-9. One
    host read for the run (the CPU form: eager, predicates read)."""
    jit, host = ranks[0][f"jit-{mode}"], ranks[0][f"host-{mode}"]
    ref = jax_minimize_jit("syn3t", D, mode, 8)
    gap = _rel(jit["energy"], ref.energy)
    print(f"gap sharded jit {mode} D={D}: counts {jit['iterations']}, "
          f"{jit['fun_evals']}, energy vs JAX jit {gap:.3g}, vs host "
          f"{_rel(jit['energy'], host['energy']):.3g}")
    _same_run(jit, host)
    assert (jit["iterations"], jit["fun_evals"], jit["status"]) == (
        ref.iterations, ref.fun_evals, int(ref.status))
    assert gap <= 1e-9
    assert jit["jit"]["reads"] == 1 and jit["jit"]["slots"] == \
        jit["fun_evals"] - jit["jit"]["prepares"]
    assert host["jit"] == {}


def test_jit_df32_first_trial_and_descent(ranks):
    """df32 cholesky at D = 2: one slot of the sharded device loop at
    lambda 1 equals the eager sharded trial bit for bit and JAX's df32
    sharded trial within 2e-3; the jit run descends and equals the host
    drive's run bit for bit."""
    e = ranks[0]["jit-first-trial-df32"]["e"]
    ref = jax_step("syn2t", D, "cholesky", 1.0, df32=True)
    print(f"gap sharded jit df32 first trial: vs JAX {_rel(e, ref['e']):.3g}")
    assert e == ranks[0]["df32-cholesky"]["e"]
    assert _rel(e, ref["e"]) <= 2e-3
    jit = ranks[0]["jit-df32"]
    assert jit["energy"] < ranks[0]["df32-cholesky"]["energy"]
    _same_run(jit, ranks[0]["host-df32"])


def test_jit_polish_composes(ranks):
    """The two-phase drive with drive="jit" on the shards runs both phases
    on the device loop, as JAX's recursion does: the host drive's result
    bit for bit."""
    _same_run(ranks[0]["jit-polish"], ranks[0]["polish"])
    assert ranks[0]["jit-polish"]["dtype"] == "torch.float64"


def test_jit_observed_run_takes_the_host_drive(ranks, files):
    """A sharded jit run with a checkpoint and metrics goes through the
    host drive, as JAX's minimize_sharded routes it: the host run's result,
    checkpoint and JSONL records (one per trial, no compile_s record), and
    no device loop ran."""
    jit, host = ranks[0]["jit-checkpoint"], ranks[0]["checkpoint"]
    _same_run(jit, host)
    assert jit["jit"] == {}
    recs = {k: [json.loads(ln) for ln in open(files[k])]
            for k in ("metrics", "jit_metrics")}
    key = ("iter", "status", "f", "rho", "lambda")
    assert [[r[k] for k in key] for r in recs["jit_metrics"]] == \
        [[r[k] for k in key] for r in recs["metrics"]]
    assert not any("compile_s" in r for r in recs["jit_metrics"])
    (_, meta), (_, jmeta) = (checkpoint.load_checkpoint(files[k], device="cpu")
                             for k in ("checkpoint", "jit_checkpoint"))
    assert (jmeta["iteration"], jmeta["fun_evals"]) == (
        meta["iteration"], meta["fun_evals"])


def test_jit_collective_counts(ranks):
    """The jit drive's collective totals, from the calls and bytes of one
    prepare and one trial times the prepares and trials the device counted,
    equal the reduce's own count of the collectives the eager loop issued."""
    out = ranks[0]["jit-counts"]
    jit = out["jit"]
    print(f"sharded jit qrkit collectives: per prepare "
          f"{jit['allreduce_per_prepare']}, per trial {jit['allreduce_per_trial']}")
    assert jit["allreduce_per_prepare"]["calls"] > 0
    assert jit["allreduce_per_trial"]["calls"] > 0
    assert (jit["allreduce_calls"], jit["allreduce_bytes"]) == (
        out["calls"], out["bytes"])
    assert jit["prepares"] + jit["slots"] == out["fun_evals"]


def test_jit_on_cuda_needs_nccl():
    """A gloo group cannot have its CUDA collectives captured: the check
    raises naming NCCL, from a stub reduce too, before any capture; NCCL on
    CUDA and gloo on the CPU pass."""
    with pytest.raises(ValueError, match="NCCL"):
        sharded.check_graph_backend("gloo", "cuda:0")
    sharded.check_graph_backend("nccl", "cuda:0")
    sharded.check_graph_backend("gloo", "cpu")

    class GlooGroup(sharded.AllReduce):
        def __init__(self):  # a stub of a gloo group's reduce: no process group
            self.backend, self.calls, self.bytes = "gloo", 0, 0

    tp = port_problem("syn2")
    cfg = lm.LMConfig(drive="jit")
    prepare, trial, to_loop, _ = lm.step_functions(tp, "cholesky", cfg, "cpu")
    with pytest.raises(ValueError, match="NCCL"):
        lm._device_loop(tp, "cholesky", cfg, to_loop(tp.state),
                        torch.device("cuda", 0), prepare, trial, GlooGroup())
