"""The port's utilities (stats, logger, checkpoint, synthetic, balgen, BAL
writer and tokenizers) against the JAX package's on the same inputs (CPU).

Tolerances: stats on p16, mean errors 1e-13 relative and the true
objective 1e-12 (the same float64 expressions summed in another order),
inlier counts equal; generated arrays equal, rotations 4.4e-16 (sin and cos
of torch and XLA); files and printed lines identical. Gaps print with
``pytest -rP``."""

import gzip
import os
import re

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu.io import bal as jbal
from bundleadjustment_benchmarks_tpu.models.problem import load_bal_problem as jload
from bundleadjustment_benchmarks_tpu.utils import balgen as jbalgen
from bundleadjustment_benchmarks_tpu.utils import checkpoint as jckpt
from bundleadjustment_benchmarks_tpu.utils import logger as jlogger
from bundleadjustment_benchmarks_tpu.utils import stats as jstats
from bundleadjustment_benchmarks_tpu.utils import synthetic as jsynth
from bundleadjustment_benchmarks_tpu_torch import convert
from bundleadjustment_benchmarks_tpu_torch.io import bal
from bundleadjustment_benchmarks_tpu_torch.models.problem import load_bal_problem
from bundleadjustment_benchmarks_tpu_torch.utils import (
    balgen, checkpoint, logger, stats, synthetic)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P16 = os.path.join(ROOT, "data", "problem-16-22106-pre.txt.gz")


@pytest.fixture(scope="module")
def p16_both():
    return jload(P16), load_bal_problem(P16, device="cpu")


@pytest.mark.parametrize("threshold", [0.5, 2.0])
def test_stats_p16_match_jax(p16_both, threshold):
    jp, tp = p16_both
    s_j = jstats.error_statistics(jp.state, jp.obs, 1.0, threshold)
    s_t = stats.error_statistics(tp.state, tp.obs, 1.0, threshold)
    gaps = [abs(t.item() - float(j)) / float(j) for t, j in
            zip(s_t[:2], s_j[:2])]
    o_j = float(jstats.true_objective(jp.state, jp.obs, 1.0, threshold))
    o_t = stats.true_objective(tp.state, tp.obs, 1.0, threshold).item()
    print(f"gap stats p16 tau {threshold}: mean {gaps[0]:.3g}, inlier mean "
          f"{gaps[1]:.3g}, objective {abs(o_t - o_j) / o_j:.3g}")
    assert max(gaps) <= 1e-13
    assert int(s_t.n_inliers) == int(s_j.n_inliers)
    assert s_t.n_observations == s_j.n_observations == 77392
    assert abs(o_t - o_j) <= 1e-12 * o_j


def test_zero_inlier_guard(p16_both):
    """With a threshold no observation meets, the inlier mean is 0, not
    NaN, in both packages."""
    jp, tp = p16_both
    s_t = stats.error_statistics(tp.state, tp.obs, 1.0, 1e-30)
    s_j = jstats.error_statistics(jp.state, jp.obs, 1.0, 1e-30)
    assert int(s_t.n_inliers) == int(s_j.n_inliers) == 0
    assert s_t.inlier_mean_reprojection_error.item() == 0.0
    assert float(s_j.inlier_mean_reprojection_error) == 0.0
    assert np.isfinite(stats.true_objective(tp.state, tp.obs, 1.0, 1e-30).item())


@pytest.mark.parametrize("threshold", [0.5, 1e-30])
def test_show_lines_identical(p16_both, threshold, capsys):
    jp, tp = p16_both
    r_j = jstats.show_error_statistics(jp.state, jp.obs, 1.0, threshold)
    o_j = jstats.show_objective(jp.state, jp.obs, 1.0, threshold)
    out_j = capsys.readouterr().out
    r_t = stats.show_error_statistics(tp.state, tp.obs, 1.0, threshold)
    o_t = stats.show_objective(tp.state, tp.obs, 1.0, threshold)
    out_t = capsys.readouterr().out
    print(out_t)
    assert out_t == out_j
    assert len(out_t.splitlines()) == 3
    assert r_t == r_j and abs(o_t - o_j) <= 1e-12 * o_j


def test_logger_lines(tmp_path):
    """The same ``[HH:MM:SS] Level: message`` lines as the JAX logger."""
    lines = {}
    for name, mod in (("jax", jlogger), ("port", logger)):
        path = str(tmp_path / f"{name}.log")
        log = mod.create_logger(path)
        for level in (mod.INFO, mod.WARNING, mod.ERROR, mod.DEBUG):
            log.log(level, f"message at {level}")
        log.log_matrix("A", np.eye(2))
        log.log_sparse_matrix("S", [0, 1], [1, 0], [0.5, -2.0])
        assert mod.instance() is log
        with open(path) as f:
            lines[name] = f.read().splitlines()
    logger.instance().close()
    stamp = re.compile(r"^\[\d\d:\d\d:\d\d\] ")
    assert stamp.match(lines["port"][0])
    assert lines["port"][0].endswith("Info: message at Info")
    assert [stamp.sub("", ln) for ln in lines["port"]] == \
        [stamp.sub("", ln) for ln in lines["jax"]]


def test_logger_replaces_and_closes(tmp_path):
    first = logger.create_logger(str(tmp_path / "a.log"))
    second = logger.create_logger(str(tmp_path / "b.log"))
    first.log(logger.INFO, "after replacement")
    second.log(logger.INFO, "kept")
    second.close()
    assert open(tmp_path / "a.log").read() == ""
    assert open(tmp_path / "b.log").read().endswith("Info: kept\n")


def _state_arrays(state):
    return {k: np.asarray(v) for k, v in convert.state_to_numpy(state).items()}


def test_checkpoint_round_trip(tmp_path):
    prob = synthetic.make_synthetic_problem(seed=4, device="cpu")
    path = str(tmp_path / "ck")  # any name: written where it is asked
    checkpoint.save_checkpoint(path, prob.state, lam=0.25, iteration=7,
                               fun_evals=15, energy_history=[3.5, 2.5],
                               extra={"note": np.arange(3)})
    assert os.listdir(tmp_path) == ["ck"]
    state, meta = checkpoint.load_checkpoint(path, device="cpu")
    for k, v in _state_arrays(prob.state).items():
        assert np.array_equal(_state_arrays(state)[k], v), k
    assert {k: meta[k] for k in ("lam", "iteration", "fun_evals",
                                 "energy_history")} == {
        "lam": 0.25, "iteration": 7, "fun_evals": 15,
        "energy_history": [3.5, 2.5]}
    assert np.array_equal(meta["extra"]["note"], np.arange(3))
    s32, _ = checkpoint.load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert s32.points.dtype == torch.float32 and s32.points.device.type == "cpu"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package loads in the other: arrays
    and meta equal."""
    jp = jsynth.make_synthetic_problem(seed=5)
    tp = convert.problem_from_numpy(convert.problem_to_numpy(jp), device="cpu")
    path = str(tmp_path / "ck.npz")
    meta_in = dict(lam=1.5e-3, iteration=4, fun_evals=9,
                   energy_history=[10.25, 9.5])
    if writer == "jax":
        jckpt.save_checkpoint(path, jp.state, **meta_in)
        state, meta = checkpoint.load_checkpoint(path, device="cpu")
        other_state, other_meta = jckpt.load_checkpoint(path)
    else:
        checkpoint.save_checkpoint(path, tp.state, **meta_in)
        state, meta = jckpt.load_checkpoint(path)
        other_state, other_meta = checkpoint.load_checkpoint(path, device="cpu")
    for k, v in _state_arrays(jp.state).items():
        assert np.array_equal(_state_arrays(state)[k], v), k
        assert np.array_equal(_state_arrays(other_state)[k], v), k
    assert meta == other_meta
    assert {k: meta[k] for k in meta_in} == meta_in


@pytest.mark.parametrize("mixed_degree", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_matches_jax(seed, mixed_degree):
    kw = dict(n_cameras=5, n_points=23, obs_per_point=3, seed=seed,
              mixed_degree=mixed_degree)
    d_j = convert.problem_to_numpy(jsynth.make_synthetic_problem(**kw))
    d_t = convert.problem_to_numpy(
        synthetic.make_synthetic_problem(device="cpu", **kw))
    assert sorted(d_t) == sorted(d_j)
    gap_R = float(np.max(np.abs(d_t["state.R"] - d_j["state.R"])))
    print(f"gap synthetic seed {seed} mixed {mixed_degree}: R {gap_R:.3g}")
    for k in d_j:
        if k != "state.R":
            assert np.array_equal(np.asarray(d_t[k]), np.asarray(d_j[k])), k
    assert gap_R <= 4.4e-16
    if mixed_degree:
        assert d_t["pt_obs_count"].min() == 1 and d_t["pt_obs_count"].max() == 3


@pytest.mark.parametrize("seed", [3, 11])
def test_balgen_matches_jax(tmp_path, seed):
    """The same arrays for the same seed, and the same gzipped text."""
    kw = dict(seed=seed, mean_degree=4.3)
    ds_t = balgen.generate_bal_like(40, 900, **kw)
    ds_j = jbalgen.generate_bal_like(40, 900, **kw)
    for f in ("cam_idx", "pt_idx", "measurements", "omega", "translation",
              "focal", "k1", "k2", "points"):
        assert np.array_equal(getattr(ds_t, f), getattr(ds_j, f)), f
    balgen.write_bal_gz(str(tmp_path / "t.txt.gz"), ds_t)
    jbalgen.write_bal_gz(str(tmp_path / "j.txt.gz"), ds_j)
    with gzip.open(tmp_path / "t.txt.gz", "rt") as a, \
            gzip.open(tmp_path / "j.txt.gz", "rt") as b:
        assert a.read() == b.read()
    back = bal.read_bal(str(tmp_path / "t.txt.gz"))
    assert np.array_equal(back.cam_idx, ds_t.cam_idx)
    assert back.n_observations == ds_t.n_observations


def test_balgen_main_writes_missing_standins(tmp_path, monkeypatch, capsys):
    """``main`` writes each configured stand-in that is not there yet."""
    monkeypatch.setattr(balgen, "STRIPPED_CONFIGS",
                        {"tiny.txt.gz": (6, 120, 3.0, 1)})
    balgen.main(str(tmp_path))
    balgen.main(str(tmp_path))
    out = capsys.readouterr().out
    assert "wrote" in out and "exists" in out
    assert bal.read_bal(str(tmp_path / "tiny.txt.gz")).n_cameras == 6


def test_write_bal_round_trip_and_matches_jax(tmp_path):
    ds = balgen.generate_bal_like(9, 150, seed=2)
    bal.write_bal(str(tmp_path / "t.txt"), ds)
    jbal.write_bal(str(tmp_path / "j.txt"), ds)
    assert open(tmp_path / "t.txt").read() == open(tmp_path / "j.txt").read()
    back = bal.read_bal(str(tmp_path / "t.txt"))
    for f in ("cam_idx", "pt_idx", "omega", "translation", "focal", "k1",
              "k2", "points"):
        assert np.array_equal(getattr(back, f), getattr(ds, f)), f
    # Measurements are written with 13 significant digits.
    assert np.allclose(back.measurements, ds.measurements, rtol=1e-12, atol=0)


def test_native_and_numpy_tokens_equal(tmp_path):
    """Where native/libbalio.so loads, it gives numpy's token stream."""
    if bal._native_lib() is None:
        pytest.skip("native/libbalio.so is not built or does not load here")
    path = str(tmp_path / "p16.txt")
    with gzip.open(P16, "rb") as src, open(path, "wb") as dst:
        dst.write(src.read())
    native = bal.tokenize(path)
    with open(path, "rb") as f:
        plain = np.array(f.read().split(), dtype=np.float64)
    assert np.array_equal(native, plain)
    assert np.array_equal(native, jbal._tokenize(path))
