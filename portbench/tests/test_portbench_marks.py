"""The readers of the port's in-graph marks (``core/marks.py`` and the six
metrics that read it) on a hand-made trace of two solves: each value, the
pairing of begin and end marks across the solves, and no number where the
trace is incomplete, where a span's count is not the port's, or where the
program puts no marks at all."""

import dataclasses

import pytest

from portbench.core import marks, registry, roofline
from portbench.core.trace import Trace

CARD = "NVIDIA H100 80GB HBM3"
SIZES = (257, 65132, 238476)
MARK_NS = 2  # a mark kernel's length


class Builder:
    """Device operations laid out one after another, in ns."""

    def __init__(self):
        self.t, self.ops = 0, []

    def op(self, name, ns):
        self.ops.append((name, self.t, self.t + ns))
        self.t += ns

    def gap(self, ns):
        self.t += ns

    def mark(self, name):
        self.op("ba_mark_" + name, MARK_NS)

    def prepare(self):
        self.mark("prepare_begin")
        self.op("chain_blocks_kernel", 40)
        self.gap(10)
        self.op("gemm", 20)
        self.mark("prepare_end")

    def trial(self, fallback=False):
        self.mark("trial_begin")
        self.op("gemm", 20)
        self.mark("camera_solve_begin")
        self.op("getrf_wo_pivot", 30)
        if fallback:
            self.mark("camera_fallback")
            self.op("geqr2", 50)
        self.mark("camera_solve_end")
        self.op("chain_energy_kernel", 10)
        self.mark("trial_end")
        self.gap(5)  # the LM decision


def two_solves():
    """Solve 1: prepare, trial, trial (QR fallback), prepare, trial. Solve
    2: prepare, trial. Host gaps of 100 ns before each solve."""
    b = Builder()
    b.gap(100)
    b.prepare()
    b.trial()
    b.trial(fallback=True)
    b.prepare()
    b.trial()
    b.gap(100)
    b.prepare()
    b.trial()
    return b


@dataclasses.dataclass
class Run:
    trace: Trace
    traced: list
    trace_complete: bool = True
    card: str = CARD
    sizes: tuple = SIZES


def make_run(ops=None, traced=None, **kw):
    b = two_solves()
    return Run(trace=Trace(ops=b.ops if ops is None else ops, spans=[],
                           window=(0, b.t + 50)),
               traced=traced or [{"prepares": 2, "slots": 3},
                                 {"prepares": 1, "slots": 1}], **kw)


PREPARE_NS = MARK_NS + 40 + 10 + 20 + MARK_NS
TRIAL_NS = MARK_NS + 20 + MARK_NS + 30 + MARK_NS + 10 + MARK_NS
FALLBACK_NS = MARK_NS + 50
CAMERA_NS = MARK_NS + 30 + MARK_NS


def read(name, run):
    return registry.reader(name).read(run)


def test_spans_pair_across_two_solves():
    got = marks.spans(make_run())
    assert [len(got[s]) for s in ("prepare", "trial", "camera_solve")] == [3, 4, 4]
    # Every span runs from its begin mark's start to its end mark's end.
    assert {b - a for a, b in got["prepare"]} == {PREPARE_NS}
    assert sorted(b - a for a, b in got["trial"]) == [TRIAL_NS] * 3 + [TRIAL_NS + FALLBACK_NS]
    assert sorted(b - a for a, b in got["camera_solve"]) == [CAMERA_NS] * 3 + [
        CAMERA_NS + FALLBACK_NS]
    # The second solve's spans come last, after its host gap.
    assert got["prepare"][2][0] - got["trial"][2][1] == 5 + 100


def test_span_means():
    run = make_run()
    assert read("prepare_ms", run) == pytest.approx(PREPARE_NS / 1e6)
    assert read("trial_ms", run) == pytest.approx((4 * TRIAL_NS + FALLBACK_NS) / 4 / 1e6)


def test_trial_kernels_leave_the_marks_out():
    # gemm, getrf, chain_energy a trial, and geqr2 in one.
    assert read("trial_kernels", make_run()) == pytest.approx((4 * 3 + 1) / 4)


def test_graph_idle_is_the_gaps_inside_each_solves_graph():
    run = make_run()
    got = marks.spans(run)
    extents = marks.solve_extents(run, got)
    assert len(extents) == 2
    first = 2 * PREPARE_NS + 3 * TRIAL_NS + FALLBACK_NS + 2 * 5
    second = PREPARE_NS + TRIAL_NS
    assert [b - a for a, b in extents] == [first, second]
    # Idle: 10 ns in each prepare, 5 after each trial but the solves' last.
    idle = 3 * 10 + 2 * 5
    assert read("graph_idle_pct", run) == pytest.approx(100.0 * idle / (first + second))


def test_camera_span_roofline():
    run = make_run()
    spent = (4 * CAMERA_NS + FALLBACK_NS) / 1e9
    want = 100.0 * 4 * roofline.camera_solve_flops(SIZES[0]) \
        / roofline.camera_solve_peak(CARD) / spent
    assert read("camera_span_roofline_pct", run) == pytest.approx(want)


def test_fallbacks_per_trial():
    assert read("camera_fallbacks_per_trial", make_run()) == pytest.approx(1 / 4)


NEW = ("prepare_ms", "trial_ms", "trial_kernels", "graph_idle_pct",
       "camera_span_roofline_pct", "camera_fallbacks_per_trial")


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_where_the_trace_is_incomplete(name):
    assert read(name, make_run(trace_complete=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_where_a_count_differs(name):
    # One trial more than the trace holds.
    assert read(name, make_run(traced=[{"prepares": 2, "slots": 4},
                                       {"prepares": 1, "slots": 1}])) is None
    # The trace lost a camera solve's end mark.
    ops = two_solves().ops
    lost = next(i for i, op in enumerate(ops) if op[0] == "ba_mark_camera_solve_end")
    assert read(name, make_run(ops=ops[:lost] + ops[lost + 1:])) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_from_a_program_without_marks(name):
    ops = [op for op in two_solves().ops if not op[0].startswith("ba_mark_")]
    assert read(name, make_run(ops=ops)) is None


def test_no_mark_name_is_read_as_another_layers_kernel():
    """The chain-completeness check and the camera solve's by-name share
    match kernels by substring: no mark holds one of theirs."""
    patterns = ("chain_",) + registry.reader("camera_solve_roofline_pct").PATTERNS
    assert not [n for n in marks.NAMES if any(p in n for p in patterns)]
