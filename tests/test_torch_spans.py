"""The spans and the counter of the port's in-graph record
(``ops/cuda_graph.py``): the LM drive's prepares and trials and the reduced
camera solve, timed between marks, and the camera solve's fallbacks,
brought back by the drive's one host read into ``lm.LAST_JIT_RUN``.

On the CPU the same marks record the host's clock, so the layout of the
spans is checked here: one prepare span per iteration started, one trial
and one camera solve per trial, the camera solve inside its trial, still
one read for an unchunked run. The tests marked ``cuda`` run on the card:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest

where the device's totals are held against the same spans in a
``torch.profiler`` trace, and the captured graph is read for its mark
kernels. This file imports nothing of JAX.
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_threads  # noqa: F401  (sizes torch's thread pool to the xdist worker)

from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_graph, linalg
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur
from bundleadjustment_benchmarks_tpu_torch.utils.synthetic import make_synthetic_problem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P257 = os.path.join(ROOT, "data", "problem-257-65132-pre.txt.gz")
DF32 = dict(geometry="df32", matmul_dtype="float32")
#: (mode, LMConfig keywords) of the drives the spans are checked on.
DRIVES = {"cholesky": ("cholesky", DF32), "qrchol": ("qrchol", DF32),
          "f64": ("cholesky", {})}
#: Substrings by which the benchmark's trace readers find other layers'
#: kernels (``portbench/metrics/camera_solve_roofline_pct.py``'s patterns
#: and the chain kernels' prefix).
HARNESS_PATTERNS = ("chain_", "geqr2", "larft", "trsv", "potrf", "getrf",
                    "syrk", "trsm")


@pytest.fixture(scope="module")
def small():
    return make_synthetic_problem(n_cameras=6, n_points=60, obs_per_point=4,
                                  seed=1, device="cpu")


def _held_to_counts(jit):
    assert jit["span_counts"] == {"prepare": jit["prepares"], "trial": jit["slots"],
                                  "camera_solve": jit["slots"]}


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_span_counts_and_layout(small, drive):
    mode, kw = DRIVES[drive]
    res = lm.minimize(small, mode, lm.LMConfig(max_iter=6, **kw), device="cpu")
    jit = lm.LAST_JIT_RUN
    _held_to_counts(jit)
    assert jit["slots"] >= jit["prepares"] > 0
    assert jit["prepares"] + jit["slots"] == res.fun_evals
    assert jit["reads"] == 1 and not jit["chunked"]
    secs = jit["device_s"]
    assert all(secs[s] > 0 for s in cuda_graph.SPANS)
    # The camera solve runs inside its trial.
    assert secs["camera_solve"] <= secs["trial"]
    assert jit["camera_fallbacks"] <= jit["slots"]
    if drive == "f64":
        assert jit["camera_fallbacks"] == 0
    assert jit["capture_s"] == jit["warmup_s"] == 0.0


def test_chunked_run_reads_once_a_chunk(small):
    """A chunked run reads once a chunk, and its last read holds the whole
    run's spans (the record is zeroed once, at the run's start)."""
    mode, kw = DRIVES["cholesky"]
    one = lm.minimize(small, mode, lm.LMConfig(max_iter=7, **kw), device="cpu")
    counts = dict(lm.LAST_JIT_RUN["span_counts"])
    chunked = lm.minimize(small, mode, lm.LMConfig(max_iter=7, chunked=True,
                                                   chunk_size=2, **kw), device="cpu")
    jit = lm.LAST_JIT_RUN
    assert (chunked.iterations, chunked.fun_evals) == (one.iterations, one.fun_evals)
    chunks = -(-(chunked.iterations - 1) // 2)
    assert jit["reads"] == jit["replays"] == chunks > 1
    assert jit["span_counts"] == counts
    _held_to_counts(jit)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_indefinite_system_takes_the_counted_fallback(dtype):
    """An indefinite reduced system, float32 or float64: one camera solve
    span, one fallback, and the fallback branch's answer (float32: the
    refined LU solve; float64: the R-only QR of [D S D | D b])."""
    rng = np.random.default_rng(3)
    n = 18
    A = rng.normal(size=(n, n))
    S = torch.from_numpy(A + A.T).to(dtype)
    b = torch.from_numpy(rng.normal(size=n)).to(dtype)
    cuda_graph.zero_marks("cpu")
    x = schur._camera_solve_chol(S, b)
    got = cuda_graph.unpack(cuda_graph.readable("cpu").tolist())
    assert got["camera_fallback"] == 1
    assert got["span_counts"] == {"prepare": 0, "trial": 0, "camera_solve": 1}
    # The fallback branch, eagerly.
    f64 = torch.float64
    S64, b64 = S.to(f64), b.to(f64)
    d = torch.diagonal(S64)
    dinv = torch.where(d > 0, torch.rsqrt(d.abs() + torch.finfo(f64).tiny),
                       torch.ones_like(d))
    Ss = (S64 * dinv[:, None] * dinv[None, :]).to(dtype)
    assert int(torch.linalg.cholesky_ex(Ss)[1]) != 0
    if dtype == f64:
        R = torch.linalg.qr(torch.cat([Ss, (b64 * dinv)[:, None]], dim=1),
                            mode="r")[1]
        ref = linalg.solve_upper_triangular(R[:, :n], R[:, n]) * dinv
        assert torch.equal(x, ref)
        return
    LU, piv, _ = torch.linalg.lu_factor_ex(Ss)

    def solve(r64):
        return torch.linalg.lu_solve(
            LU, piv, r64.to(torch.float32)[:, None])[:, 0].to(f64)

    ref = solve(b64 * dinv) * dinv
    for _ in range(2):
        ref = ref + solve((b64 - S64 @ ref) * dinv) * dinv
    assert torch.equal(x, ref.to(torch.float32))


def test_mark_kernel_names():
    """Each mark is its own kernel name; none holds a substring the
    benchmark's readers match, and the benchmark's own table of them is
    the port's."""
    assert len(set(cuda_graph.MARK_KERNELS)) == len(cuda_graph.MARKS) == 7
    assert not [n for n in cuda_graph.MARK_KERNELS
                if any(p in n for p in HARNESS_PATTERNS)]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.core import marks

    assert marks.NAMES == frozenset(cuda_graph.MARK_KERNELS)
    assert set(marks.SPANS) == set(cuda_graph.SPANS)
    with pytest.raises(ValueError):
        cuda_graph.mark("cpu", "solve_begin")


def test_host_steps_are_profiler_ranges(small):
    """A run's host steps show as ``ba.*`` ranges in a profiler trace."""
    mode, kw = DRIVES["f64"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.minimize(small, mode, lm.LMConfig(max_iter=2, **kw), device="cpu")
    names = {e.name for e in prof.events()}
    assert {"ba.enter", "ba.replay", "ba.read"} <= names


# -- on the card -------------------------------------------------------------------


@pytest.fixture(scope="module")
def p257_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # The profiler records a graph's kernels in full only where the graph
    # was captured after the process's first profiler session.
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    lm.clear_graphs()
    yield pm.load_bal_problem(P257, device="cuda")
    lm.clear_graphs()


def _trace_spans(prof) -> dict:
    """{span: [ns, ...]} of the mark pairs in a profiler trace: from a
    begin mark's start to the next end mark's end."""
    ops = sorted(((e.name(), e.start_ns(), e.end_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("ba_mark_")), key=lambda op: op[1])
    out = {}
    for span in cuda_graph.SPANS:
        begin, end, at = f"ba_mark_{span}_begin", f"ba_mark_{span}_end", None
        out[span] = []
        for name, a, b in ops:
            if name == begin:
                at = a
            elif name == end and at is not None:
                out[span].append(b - at)
                at = None
    out["camera_fallback"] = sum(op[0] == "ba_mark_camera_fallback" for op in ops)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("drive", ["cholesky", "f64"])
def test_device_totals_match_the_trace(p257_cuda, drive):
    """The record's totals, by the device's clock, against the same spans in
    a profiler trace of the replay: equal counts, totals within 2%."""
    mode, kw = DRIVES[drive]
    cfg = lm.LMConfig(max_iter=5, **kw)
    lm.minimize(p257_cuda, mode, cfg)
    assert lm.LAST_JIT_RUN["captured"] and lm.LAST_JIT_RUN["warmup_s"] > 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lm.minimize(p257_cuda, mode, cfg)
        torch.cuda.synchronize()
    jit = lm.LAST_JIT_RUN
    assert not jit["captured"] and jit["reads"] == 1
    _held_to_counts(jit)
    traced = _trace_spans(prof)
    for span in cuda_graph.SPANS:
        assert len(traced[span]) == jit["span_counts"][span], span
        assert jit["device_s"][span] == pytest.approx(sum(traced[span]) / 1e9,
                                                      rel=0.02), span
    assert traced["camera_fallback"] == jit["camera_fallbacks"]
    names = {e.name for e in prof.events()}
    assert {"ba.enter", "ba.replay", "ba.read"} <= names


@pytest.mark.cuda
def test_p257_graph_holds_the_marks(p257_cuda):
    """The captured p257 df32 cholesky graph holds each mark kernel once:
    the prepare's in its iteration-start branch, the trial's and the
    camera solve's in the loop body, the fallback's in the QR branch."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    mode, kw = DRIVES["cholesky"]
    lm.clear_graphs()
    lm.minimize(p257_cuda, mode, lm.LMConfig(max_iter=2, **kw))
    _held_to_counts(lm.LAST_JIT_RUN)
    (_, loop), = lm._GRAPHS.values()
    raws = [g.raw_cuda_graph() for g in loop.graph._segments]
    names = [n for raw in raws if cuda_graph.node_types(raw)[0]
             for n in chip_smoke.graph_kernel_names(raw)]
    assert {m: names.count(m) for m in cuda_graph.MARK_KERNELS} == {
        m: 1 for m in cuda_graph.MARK_KERNELS}
