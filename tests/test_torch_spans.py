"""The spans and the counter of the port's in-graph record
(``ops/cuda_graph.py``): the LM drive's prepares and trials, the reduced
camera solve and the trial's pair gram, timed between marks, and the
camera solve's fallbacks, brought back by the drive's one host read into
``lm.LAST_JIT_RUN``.

On the CPU the same marks record the host's clock, so the layout of the
spans is checked here: one prepare span per iteration started, one trial
and one camera solve per trial, the camera solve inside its trial, one
pair gram inside each trial where the problem has pair tables and none
where it has not, still one read for an unchunked run. The benchmark's
two readers of the pair gram's span (``portbench/metrics/pair_gram_ms.py``,
``pair_gram_roofline_pct.py``) are held on hand-made traces. The tests
marked ``cuda`` run on the card:

    python -m pytest tests/test_torch_spans.py -m cuda --noconftest

where the device's totals are held against the same spans in a
``torch.profiler`` trace, and the captured graph is read for its mark
kernels. This file imports nothing of JAX.
"""

import dataclasses
import os
import sys
import types

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
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core import marks, registry, roofline, session  # noqa: E402
from portbench.core.trace import Trace  # noqa: E402

P257 = os.path.join(ROOT, "data", "problem-257-65132-pre.txt.gz")
DF32 = dict(geometry="df32", matmul_dtype="float32")
#: (mode, LMConfig keywords) of the drives the spans are checked on.
DRIVES = {"cholesky": ("cholesky", DF32), "qrchol": ("qrchol", DF32),
          "f64": ("cholesky", {}), "qrkit": ("qrkit", DF32)}
#: Substrings by which the benchmark's trace readers find other layers'
#: kernels (``portbench/metrics/camera_solve_roofline_pct.py``'s patterns
#: and the chain kernels' prefix).
HARNESS_PATTERNS = ("chain_", "geqr2", "larft", "trsv", "potrf", "getrf",
                    "syrk", "trsm")


@pytest.fixture(scope="module")
def small():
    return make_synthetic_problem(n_cameras=6, n_points=60, obs_per_point=4,
                                  seed=1, device="cpu")


def _held_to_counts(jit, pairs=True):
    """One prepare span an iteration started, one trial, camera solve and,
    where the problem has pair tables, pair gram a trial."""
    assert jit["span_counts"] == {"prepare": jit["prepares"], "trial": jit["slots"],
                                  "camera_solve": jit["slots"],
                                  "pair_gram": jit["slots"] if pairs else 0}


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
    # The camera solve and the pair gram run inside their trial.
    assert secs["camera_solve"] + secs["pair_gram"] <= secs["trial"]
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
    assert got["span_counts"] == {"prepare": 0, "trial": 0, "camera_solve": 1,
                                  "pair_gram": 0}
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
    benchmark's readers match, and the benchmark's own tables of them
    (``core/marks.py``'s first three spans and the fallback, the pair
    gram's reader's span) are the port's."""
    assert len(set(cuda_graph.MARK_KERNELS)) == len(cuda_graph.MARKS) == 9
    assert not [n for n in cuda_graph.MARK_KERNELS
                if any(p in n for p in HARNESS_PATTERNS)]
    gram = registry.reader("pair_gram_ms")
    assert marks.NAMES | {gram.BEGIN, gram.END} == frozenset(cuda_graph.MARK_KERNELS)
    assert set(marks.SPANS) | {"pair_gram"} == set(cuda_graph.SPANS)
    assert (gram.BEGIN, gram.END) == tuple(
        f"ba_mark_pair_gram_{end}" for end in ("begin", "end"))
    with pytest.raises(ValueError):
        cuda_graph.mark("cpu", "solve_begin")


def test_host_steps_are_profiler_ranges(small):
    """A run's host steps show as ``ba.*`` ranges in a profiler trace."""
    mode, kw = DRIVES["f64"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lm.minimize(small, mode, lm.LMConfig(max_iter=2, **kw), device="cpu")
    names = {e.name for e in prof.events()}
    assert {"ba.enter", "ba.replay", "ba.read"} <= names


@pytest.mark.parametrize("drive", ["cholesky", "qrchol", "qrkit"])
def test_one_pair_gram_inside_each_trial(small, drive, monkeypatch):
    """Every trial holds one pair gram span, after the trial's begin and
    before its camera solve; none runs outside a trial (qrkit's lambda-free
    S0 of the prepare is not a span)."""
    mode, kw = DRIVES[drive]
    names = []
    real = cuda_graph.mark

    def mark(device, name):
        names.append(name)
        real(device, name)

    monkeypatch.setattr(cuda_graph, "mark", mark)
    lm.minimize(small, mode, lm.LMConfig(max_iter=4, **kw), device="cpu")
    jit = lm.LAST_JIT_RUN
    _held_to_counts(jit)
    trial = ["trial_begin", "pair_gram_begin", "pair_gram_end",
             "camera_solve_begin", "camera_solve_end", "trial_end"]
    assert [n for n in names if n in trial] == trial * jit["slots"]
    assert 0 < jit["device_s"]["pair_gram"] < jit["device_s"]["trial"]


@pytest.mark.parametrize("drive", ["cholesky", "qrkit"])
def test_no_pair_gram_without_pair_tables(small, drive):
    """Without pair tables cholesky sums the reduced system by chunks and
    qrkit re-damps its dense rows: no pair gram span."""
    mode, kw = DRIVES[drive]
    lm.minimize(dataclasses.replace(small, pairs=None), mode,
                lm.LMConfig(max_iter=3, **kw), device="cpu")
    jit = lm.LAST_JIT_RUN
    counts = jit["span_counts"]
    assert counts["trial"] == jit["slots"] > 0
    assert counts["pair_gram"] == 0 and jit["device_s"]["pair_gram"] == 0


#: A tiny configuration of the frozen generator, for the roofline's counts.
TINY_CONFIG = {"name": "tiny-long-tracks", "n_cameras": 12, "n_points": 300,
               "data": {"kind": "balgen", "seed": 3, "mean_degree": 6.0}}
CARD = "NVIDIA H100 80GB HBM3"


@dataclasses.dataclass
class _Run:
    """What the pair gram's readers read of a run."""

    trace: object
    traced: list
    cell: object
    trace_complete: bool = True
    card: str = CARD


def _gram_run(trials=(3, 2), drop=(), **kw):
    """Solves of one prepare and ``trials`` trials each, laid out in ns: in
    a trial, the pair gram i (its marks and 20 + 10 i ns of kernels), then
    the camera solve. Ops named in ``drop`` are left out (by index of the
    pair gram's end marks, or "marks": every pair gram mark)."""
    t, ops, ends = 0, [], 0

    def op(name, ns):
        nonlocal t
        ops.append((name, t, t + ns))
        t += ns

    i = 0
    for n in trials:
        t += 100
        op("ba_mark_prepare_begin", 2)
        op("chain_blocks_kernel", 40)
        op("ba_mark_prepare_end", 2)
        for _ in range(n):
            op("ba_mark_trial_begin", 2)
            op("ba_mark_pair_gram_begin", 2)
            op("gemmSN_NN_kernel", 20 + 10 * i)
            if "marks" not in drop and ends not in drop:
                op("ba_mark_pair_gram_end", 2)
            ends += 1
            op("ba_mark_camera_solve_begin", 2)
            op("getrf_wo_pivot", 30)
            op("ba_mark_camera_solve_end", 2)
            op("ba_mark_trial_end", 2)
            i += 1
    if "marks" in drop:
        ops = [o for o in ops if "pair_gram" not in o[0]]
    cell = types.SimpleNamespace(config=TINY_CONFIG, traffic={"geometry": "df32"})
    traced = [{"prepares": 1, "slots": n} for n in trials]
    return _Run(trace=Trace(ops=ops, spans=[], window=(0, t + 50)),
                traced=traced, cell=cell, **kw)


def test_pair_count_of_a_tiny_configuration():
    """The roofline's sizes: the configuration's cameras, points and
    observations, and its pairs, as many as the port's pair tables hold."""
    roof = registry.reader("pair_gram_roofline_pct")
    raw = session.raw_arrays(TINY_CONFIG)
    n, m, k, p = roof.sizes(TINY_CONFIG)
    assert (n, m, k) == (12, 300, len(raw["cam_idx"]))
    order = np.argsort(raw["pt_idx"], kind="stable")
    tables = pm._pair_tables_np(raw["pt_idx"][order], raw["cam_idx"][order], n)
    assert p == int((tables["row_a"] < k).sum()) > k


def test_pair_gram_readers_on_a_hand_made_trace():
    """Five pair grams over two solves: the mean span, and the least time of
    one pair gram (float32 stacks on the df32 drive) times five over the
    spans' time."""
    run = _gram_run()
    spans_ns = [2 + 20 + 10 * i + 2 for i in range(5)]
    assert registry.reader("pair_gram_ms").read(run) == pytest.approx(
        sum(spans_ns) / 5 / 1e6, rel=1e-12)
    roof = registry.reader("pair_gram_roofline_pct")
    n, m, k, p = roof.sizes(TINY_CONFIG)
    bw, fp32 = roofline.card_rates(CARD)
    least = max(4 * (54 * p + 27 * k + 6 * m + 81 * n * n + 9 * n) / bw,
                486 * p / fp32)
    assert roof.read(run) == pytest.approx(100 * 5 * least / (sum(spans_ns) / 1e9),
                                           rel=1e-12)
    run.cell.traffic = {"geometry": "f64"}
    least64 = max(8 * (54 * p + 27 * k + 6 * m + 81 * n * n + 9 * n) / bw,
                  486 * p / fp32)
    assert roof.read(run) == pytest.approx(100 * 5 * least64 / (sum(spans_ns) / 1e9),
                                           rel=1e-12)


@pytest.mark.parametrize("case", ["no_marks", "count_differs", "lost_end",
                                  "incomplete"])
def test_pair_gram_readers_read_nothing(case):
    """No number from a program without the marks (the parent's), from a
    trace with another count of pair grams than the port's trials, from one
    that lost a mark, or from an incomplete trace."""
    run = {"no_marks": lambda: _gram_run(drop=("marks",)),
           "count_differs": lambda: _gram_run(),
           "lost_end": lambda: _gram_run(drop=(3,)),
           "incomplete": lambda: _gram_run(trace_complete=False)}[case]()
    if case == "count_differs":
        run.traced[1]["slots"] += 1
    for name in ("pair_gram_ms", "pair_gram_roofline_pct"):
        assert registry.reader(name).read(run) is None, name


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
@pytest.mark.parametrize("drive", ["cholesky", "f64", "qrkit"])
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
    the prepare's in its iteration-start branch, the trial's, the pair
    gram's and the camera solve's in the loop body, the fallback's in the
    fallback branch."""
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
