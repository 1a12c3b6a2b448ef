"""The trace reduction on a hand-made trace: the union of device
intervals, the idle share, the breakdown and kernel times by name."""

import pytest

from portbench.core import trace


def hand_trace():
    # Window 0..100 ns. Kernels a [10, 30) and b [20, 40) overlap on two
    # streams, c [60, 70), a [90, 120) runs past the window's end.
    ops = [("a", 10, 30), ("b", 20, 40), ("c", 60, 70), ("a", 90, 120),
           ("z", 150, 160)]
    spans = [("portbench.solve", 0, 50), ("portbench.solve", 50, 100),
             ("portbench.keep", 40, 50), ("portbench.start", 50, 65)]
    return trace.Trace(ops=ops, spans=spans, window=(0, 100))


def test_union_counts_overlap_once():
    covered, gaps = trace.union([(10, 30), (20, 40), (60, 70), (90, 120)], 0, 100)
    assert covered == 30 + 10 + 10
    assert gaps == [(0, 10), (40, 60), (70, 90)]


def test_busy_and_idle_share():
    tr = hand_trace()
    assert tr.window_s == pytest.approx(100e-9)
    assert trace.busy_s(tr) == pytest.approx(50e-9)


def test_breakdown():
    tr = hand_trace()
    ops = dict(trace.device_ops(tr))
    assert ops["a"] == pytest.approx(30e-9)
    assert ops["b"] == pytest.approx(20e-9)
    assert "z" not in ops
    gaps = dict(trace.idle_gaps(tr))
    # (0, 10) mid 5: solve; (40, 60) mid 50: start (innermost); (70, 90): solve.
    assert gaps["portbench.solve"] == pytest.approx(30e-9)
    assert gaps["portbench.start"] == pytest.approx(20e-9)


def test_kernel_time_by_name():
    secs, n = trace.kernel_time_s(hand_trace(), ("a",))
    assert n == 2 and secs == pytest.approx(30e-9)


def test_traced_window_retries_an_incomplete_group(monkeypatch):
    """A group whose trace misses a chain launch the port counted is traced
    again on the next solves, past the window's length if need be; the
    metrics read the complete group's trace and solves."""
    import time

    from conftest import tiny_cell
    from portbench.core import session

    real = trace.kernel_time_s
    calls = []

    def first_misses(tr, patterns):
        secs, n = real(tr, patterns)
        calls.append(patterns)
        # The first group's check reads one launch short of the count.
        return secs, (n - 1 if patterns == ("chain_",) and len(calls) == 1 else n)

    monkeypatch.setattr(session.trace, "kernel_time_s", first_misses)
    cell = tiny_cell("trafalgar257-f64-cholesky")
    cell.spec = dict(cell.spec, trace_solves=1)
    res = session.run(cell, 2 ** 31 + 17, 0.0, True, "cpu", time.time())
    run = res["run"]
    assert run.trace_tries == 2 and run.trace_complete
    assert len(run.solves) == 2 and run.traced == run.solves[1:2]
    solves = [s for s in run.trace.spans if s[0] == "portbench.solve"]
    assert len(solves) == 1 and run.trace.window == solves[0][1:]
    assert res["verdict"]["correct"]


def test_traced_window_stops_retrying_at_the_record_limit(monkeypatch):
    """No group is traced again where its count of device operations
    would pass what the profiler records in one process."""
    import time

    from conftest import tiny_cell
    from portbench.core import session

    real = trace.kernel_time_s

    def always_misses(tr, patterns):
        secs, n = real(tr, patterns)
        return secs, (n - 1 if patterns == ("chain_",) else n)

    monkeypatch.setattr(session.trace, "kernel_time_s", always_misses)
    monkeypatch.setattr(session, "TRACE_RECORDS", 0)
    cell = tiny_cell("trafalgar257-f64-cholesky")
    cell.spec = dict(cell.spec, trace_solves=1)
    run = session.run(cell, 2 ** 31 + 23, 0.0, True, "cpu", time.time())["run"]
    assert run.trace_tries == 1 and run.trace_complete is False
    assert len(run.solves) == 1
