"""LM iterations per second of the PyTorch/CUDA port on the card: the
port's counterpart of ``bench.py``.

    python3 bench_torch.py [--problem p16|p126|p257|ladybug|PATH]
        [--modes cholesky,qrchol] [--geometry df32|f64] [--max-iter 100]
        [--repeats 5] [--device cpu]

The workload is bench.py's: ``lm.minimize(problem, mode, LMConfig(
drive="jit", max_iter=100, geometry="df32", matmul_dtype="float32"))``
from the loaded float64 state, the warm-up excluded, with every
other cost of ``minimize`` inside the window (bench.py:40-66). The default
run is bench.py's p257 fields (bench.py:81-99): the p257 stand-in
(``data/problem-257-65132-pre.txt.gz``; bench.py's p21 headline problem is
not in the repo), cholesky then qrchol. ``--geometry f64`` gives bench.py's
CPU branch (float64 geometry and matmuls); both are on the jit drive
(``flatline_campaign.drive_config``). The Ladybug stand-in (``--problem
ladybug``, generated in memory) holds an 11.62 GB graph pool: run it
alone.

Each (problem, mode) gets one untimed warm-up run (on CUDA it captures the
CUDA graph, and the first one builds the kernels with nvcc),
whose capture seconds are printed apart. Then come ``--repeats`` rounds of
timed runs, the modes alternated in each (A B A B ...), since the host's
speed varies between calls. A window runs from a synchronize to a
synchronize after the result's points are read (bench.py's
``block_until_ready``, bench.py:62-65).

The drive is JAX's default jit drive: nothing observes a timed run, so it
is one graph replay and one host read (``LMConfig.chunked`` False, as
bench.py's config leaves it); each run's line has its ``reads`` and
``replays``.

Each workload (problem, mode) is gated, and the line says ``correct``:
(a) every timed run equals the warm-up in status, iterations, evaluations
and final energy, bit for bit, and no run captured inside its window;
(b) where the drive runs chain kernels on CUDA (df32, and float64 without
float32 matmuls), the whole workload on the timed graph itself (the
graph cache's key leaves out the limits and the observers, so it replays
without a capture), its states observed, and each of its iterations once
more with the chain kernels' plain versions, from that run's own state
and lambda before it, take the same trials, accept and stop, with the
prepare's and the accepted energies within 1e-9 (untimed;
``kernels_vs_plain``); (c) every run
descends: its energy is
finite and below the initial one, it stopped on a success or on the
iteration budget, and its points are finite, of shape (M, 3); (d) the
workload is held to a reference outside the port (``reference_gate``,
the line's ``reference``), after the timed runs and after (b) freed the
timed graphs:
(d1) the warm-up's endpoint statistics (``flatline_campaign.
post_statistics``, focal 1.0, tau 0.5 px) against a reference row under
``flatline_campaign.BUDGETS[geometry]`` (``budget_gaps``): at p16 the scipy
oracle's flatline (``benchmarks/results/cpu_p16_flatline.json``), at p126
and p257 the JAX package's campaign row of the same mode and geometry
(``benchmarks/parity_campaign.json``); none for the Ladybug stand-in, and
none where the run stopped at ``--max-iter`` before its own stop (the
references are converged endpoints); (d2) a float64 prefix of the
workload's mode (the jit drive, on the same problem object) against an
independent trace: its energies under ``oracle_prefix.budget_for(mode)``
and lambda's damping-update factor from each iteration to the next
within ``oracle_prefix.LAM_FACTOR_REL`` (``oracle_prefix.run_row``; a
short prefix's energies barely move under a wrong update): at p126 and p257 the scipy oracle's logged
prefix and state (``oracle_prefix.CONFIGS``), at p16 the first
``P16_PREFIX_ITERS`` iterations of the oracle's flatline trace, and on
the Ladybug stand-in the JAX package's first iterations
(``torch_results/jax_prefix_ladybug_cpu.json``, written by
``jax_reference.py``). A missing or unreadable reference file, or a
problem without a prefix reference (a BAL path), fails (d) with its
reason in ``reference.error``; (d3) "control" (``control_run``): after
the timed runs and before (b) frees the timed graphs, one more run of
the workload with its iteration records observed, which takes the
chunked route through the same captured graph; it must not capture, must
end where the warm-up ended bit for bit, and every one of its iterations
must keep the reference's LM rules as ``control_gate`` writes them again,
apart from the drives' code: lambda carried, grown and updated, accept,
stop and the evaluation count (the line's ``control``: its seconds, the
first rule broken, the largest gap per rule, and the rejected trials,
mid-range accepts and second growths it checked, or what it did not
reach); (e) "numerics" (``numerics_gate``), on the same observed run,
whose states are observed too (one replay and one read per iteration):
every accepted step, recovered from the states before and after it,
held to the damped normal equations at the state before it (the
Jacobian and residuals the run computes there, summed in float64; on
df32 the float32 chain) by its Jacobi-scaled backward error eta, less
the allowance for the recovery's rounding, and the accepted energy
against the float64 energy of the state after it (the line's
``numerics``: its seconds, the accepted iterations checked and the loose
ones among them, whose steps lie under the states' rounding and are not
held to the bound, the largest of each measure with its iteration,
lambda and rho, and the first iteration over a bound).

Output: one JSON line before the runs (the card, the problem, the config),
one per warm-up, one per timed run and one per workload (it/s median, min
and max, peak and reserved device bytes, the gates), and last one line
with bench.py's keys: ``metric`` (``lm_iter_per_sec_<problem>_<first
mode>``), ``value`` (its median it/s), ``unit``, ``vs_baseline`` 1.0 and
``baseline`` null (``bench_baseline.json`` holds only p21's scipy rate, a
problem this script cannot name), ``<problem>_<mode>_iter_per_sec``
for every mode, ``correct`` and ``device`` (``nvidia-smi``'s name and power
limit). Exit codes: 0 correct, 1 a gate failed (after every line is
printed), 2 a bad argument, or no CUDA device and no ``--device``: it never
falls back to the CPU, nor to the plain chain where the kernels fail.
Imports nothing of JAX.

What ``correct`` does not hold: a df32 endpoint closer to the reference
than the df32 envelope (1e-2 px, 9% objective, 25% inliers). The df32
stop is chaotic: a change that only rounds differently moves where a run
stops on lambda-max within that envelope, so (d1) at df32 catches a gross
fault only. (d2) holds, in float64, the LM loop, the damping update and
the Schur solves that the df32 runs share, over its short prefix only;
the df32 geometry itself is held only by (b), against its plain chain.
(d3) holds the LM's scalar rules on every iteration of the timed graph,
but not the numbers they act on: a step, rho's denominator or an energy
computed wrongly but consistently passes it, and so does lambda's first
value (the rule's, from the Schur context). The step and the energy
are (e)'s; rho's denominator and lambda's first value stay with (b), (d1)
and (d2). (d3) sees a fault only where the run reaches it: a fault in the
factor's middle range only where an accept has rho below RHO_CLAMP, in
the growth only where a trial takes a second growth factor (the line's
``unreached`` names what a run missed). An accepted iteration's lambda
folds in the growth of its rejected trials, so a wrong growth there is
named ``accept``. (e) holds each accepted step and energy on every
iteration, but not a rejected trial's step (it leaves no state), nor a
flatline stop's last step (discarded), nor a loose iteration's step (at
a lambda where the step lies under the states' rounding, the line's
``loose``), and the step only against faults above the float32 solve's
own error at df32: eta is dominated there by the long steps of points
seen at a narrow angle and of BA's weak directions, so a step fault
must reach STEP_FAULT_DF32 (the reduced right-hand side scaled by 1 +
STEP_FAULT_DF32) to fail (e) at p257 df32, where 1 + STEP_FAULT fails it in float64
(PERF.md).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import sys
import time
from typing import NamedTuple

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import flatline_campaign as campaign  # noqa: E402
import oracle_prefix  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch import resolve_device  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.models import problem as problem_mod  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, jacobian, projection  # noqa: E402
from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur  # noqa: E402

PROBLEM = "p257"
MODES = ("cholesky", "qrchol")
MAX_ITER = 100
REPEATS = 5
#: Fewest timed runs of a workload on the card: one call varies 1.4-2x.
CARD_REPEATS = 3
#: Gate (b): the largest relative energy gap of the kernel and plain runs
#: at any iteration (chip_smoke.py's bound at p16).
KERNELS_RTOL = 1e-9
#: Stops of a descending run: the reference's two successes, and the
#: iteration budget, where bench.py's own p21 headline stops (p21
#: flatlines around iteration 175, past its 100).
DESCENT_STOPS = tuple(lm.STATUS_STRINGS[s] for s in (
    lm.LMStatus.Success, lm.LMStatus.ExceededLambdaMax,
    lm.LMStatus.MaxItersReached))
#: Gate (d)'s references, relative to this file's directory: the scipy
#: oracle's p16 flatline (its ``post`` for (d1), its ``trace`` for (d2)),
#: the JAX package's campaign rows (d1 at p126 and p257) and the JAX
#: package's float64 prefix on the Ladybug stand-in (d2).
P16_ORACLE = "benchmarks/results/cpu_p16_flatline.json"
JAX_ROWS = "benchmarks/parity_campaign.json"
LADYBUG_PREFIX = "torch_results/jax_prefix_ladybug_cpu.json"
#: (d2) at p16: iterations of the oracle's trace. Measured on the CPU, the
#: port's float64 energies sit <= 9.9e-6 from them over these five in
#: cholesky and qrchol, <= 5.2e-3 in qrkit, moreqr and spqr (within
#: oracle_prefix.CHOLESKY and JAX_BUDGET); at iterations 7-8 cholesky's
#: lambda parts from the oracle's (3.4e-4, 9.6e-4).
P16_PREFIX_ITERS = 5
#: Gate (d3): lambda after an accept or a final reject against the rule's,
#: relative. The drives and the checker round the factor's cube and the
#: growth's power alike up to an ulp or two.
CONTROL_LAM_RTOL = 1e-12
#: Gate (d3): an iteration's prepare energy against the energy the
#: iteration before it accepted (the same state, summed by the prepare's
#: and the trial's chains), relative. Measured: 0 in float64 on the CPU
#: (p16, 25 iterations) and <= 6.5e-15 with df32's plain chain there (p16
#: and a generated problem, 18-42 iterations); 0 on an H100 in every
#: default workload, df32 with the chain kernels and float64 alike.
CONTROL_F_RTOL = 1e-12
#: Nielsen's factor max(1/3, 1 - (2 rho - 1)^3) is its clamp 1/3 from this
#: rho up, and above it below: an accept with a smaller rho checks the
#: factor's middle range.
RHO_CLAMP = (1.0 + (2.0 / 3.0) ** (1.0 / 3.0)) / 2.0
#: Gate (e), "numerics" (``numerics_gate``), per geometry: the largest
#: backward error eta of an accepted step above the allowance for its
#: recovery from two states (eta's excess), and the largest relative gap
#: between an accepted trial's energy and the float64 energy of the state
#: it left. Read by ``numerics_probe.py`` on an H100 ("NVIDIA H100 80GB
#: HBM3, 700.00 W"). Float64 (p16, five modes): eta's excess <= -7.5e-14
#: (eta <= 4.4e-10 where the iteration is held), energy gap 0;
#: ``step-scaled`` (1 + STEP_FAULT) 1.57e-7 at p16 cholesky's iteration
#: 1, 1.07e-6 at most. df32: eta's excess <= 2.46e-6 on the default
#: workloads (p257 qrchol; cholesky 4.26e-7, Ladybug 9.64e-7) and 1.59e-5
#: in any mode measured (Ladybug qrchol); ``step-scaled`` at p257
#: cholesky 1.36e-5 at 1 + 0.1 (under the bound), 7.48e-4 at 1 +
#: STEP_FAULT_DF32, 9.94e-2 at 1 + 1.0. The df32 energy gap <= 2.68e-5
#: (p257 qrchol) and 5.22e-5 under the planted inverted factor;
#: ``energy-scaled`` reads ENERGY_FAULT.
NUMERICS_BOUNDS = {
    "f64": {"eta": 1e-8, "energy_gap": 1e-13},
    "df32": {"eta": 5e-5, "energy_gap": 1e-3},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def problem_name(key: str) -> str:
    """The problem's name in the metric: its key, or a path's basename
    without its extensions."""
    if key in campaign.PROBLEMS or key == "ladybug":
        return key
    name = os.path.basename(key)
    for ext in (".gz", ".txt"):
        name = name.removesuffix(ext)
    return name


def timed_run(problem, mode: str, cfg: lm.LMConfig, dev: torch.device) -> tuple:
    """One ``lm.minimize``, timed from a synchronize to a synchronize after
    its points are read; the chain kernels' launch counts and the peak
    allocation are reset before the window. Returns (its record, its final
    state)."""
    cuda = dev.type == "cuda"
    cuda_chain.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    campaign._sync(dev)
    t0 = time.perf_counter()
    res = lm.minimize(problem, mode, cfg, device=dev)
    points = res.state.points
    campaign._sync(dev)
    wall = time.perf_counter() - t0
    jit = lm.LAST_JIT_RUN
    return {
        "mode": mode, "iterations": res.iterations, "fun_evals": res.fun_evals,
        "status": lm.STATUS_STRINGS[res.status], "energy": res.energy,
        "lam": res.lam, "wall_s": wall, "it_per_s": res.iterations / wall,
        **{k: jit.get(k) for k in ("captured", "capture_s", "replays", "reads")},
        "launches": dict(cuda_chain.LAUNCHES),
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "points_ok": tuple(points.shape) == (problem.n_points, 3)
        and bool(torch.isfinite(points).all()),
    }, res.state


def records_parting(kern: list, plain: list) -> dict:
    """Two lists of iteration records compared from the first: bitwise_to
    (the last iteration up to which they are equal bit for bit),
    within_to (the last up to which every iteration takes the same trials
    and accept with the prepare's energy f and energy_out within
    KERNELS_RTOL), largest_gap (the largest of those energy gaps up to
    within_to) and parted (the first iteration past within_to with both
    lists' records there, a record None where that list had ended or holds
    None; None where they stay within to the end of both)."""
    bitwise = within = 0
    largest = 0.0
    for k, (a, b) in enumerate(zip(kern, plain), 1):
        if a == b and bitwise == k - 1:
            bitwise = k
        if None in (a, b) or (a.n_trials, a.accepted) != (b.n_trials, b.accepted):
            break
        gap = max(_rel(a.f, b.f), _rel(a.energy_out, b.energy_out))
        if not gap <= KERNELS_RTOL:
            break
        within, largest = k, max(largest, gap)
    parted = None
    if within < max(len(kern), len(plain)):
        parted = {"iteration": within + 1, "records": [
            r[within] if within < len(r) else None for r in (kern, plain)]}
    return {"bitwise_to": bitwise, "within_to": within, "largest_gap": largest,
            "parted": parted}


def resume_at(records: list, k: int, cfg: lm.LMConfig) -> dict:
    """``lm.minimize``'s ``resume`` (a checkpoint's meta) that starts
    iteration ``k`` (from 1) of the run that wrote ``records``: the first
    trial's lambda, the iterations and evaluations before it (a prepare
    and its trials each) and the flatline history they left."""
    size = cfg.energy_history_size
    hist, fun_evals = [0.0] * size, 0
    for j, r in enumerate(records[:k - 1], 1):
        fun_evals += 1 + r.n_trials
        if r.accepted:
            hist[j % size] = r.energy_out
    return {"lam": records[k - 1].lam0, "iteration": k - 1,
            "fun_evals": fun_evals, "energy_history": hist}


def rerun_iterations(problem, mode: str, cfg: lm.LMConfig, dev: torch.device,
                     states: list) -> tuple:
    """Each iteration of an observed run (``states``: ``lm.minimize``'s
    (iteration, float64 state after it, record) of every iteration) run
    again alone under ``cfg``: from the state before it (the problem's own
    before the first) with ``resume_at``'s lambda and counts, to
    ``max_iter`` k. Returns (the records, one an iteration, None where a
    rerun recorded none; the status each rerun stopped with; the last
    rerun's ``LMResult``)."""
    records = [r for _, _, r in states]
    before = [None] + [s for _, s, _ in states[:-1]]
    rerun, stops, res = [], [], None
    for k, state in enumerate(before, 1):
        got = []
        res = lm.minimize(problem, mode, dataclasses.replace(cfg, max_iter=k),
                          state=state, device=dev,
                          resume=resume_at(records, k, cfg), records=got)
        rerun.append(got[0] if len(got) == 1 else None)
        stops.append(res.status)
    return rerun, stops, res


def kernels_vs_plain(problem, modes, cfg: lm.LMConfig, dev: torch.device) -> dict:
    """Gate (b) for each of ``modes`` ({mode: record}; None where ``cfg``
    runs no chain kernel: off CUDA, or the float64 drive with float32
    matmuls): the whole workload run with the chain kernels (the df32
    pair, or the float64 pair), its states
    observed: the graph cache's key leaves out the limits and the
    observers (``lm._graph_key``), so it replays the timed graph itself,
    which it must (``captured`` false) with both chain kernels launched.
    Then those graphs are freed and each mode's iterations are run again
    with the chain's plain versions (``rerun_iterations``: each alone,
    from the kernel run's own state and lambda before it), on a graph of
    their own, freed after it: a Ladybug pool holds 11.62 GB, and no more
    than the timed pools are ever resident. Every iteration of the two
    must take the same trials, accept and stop, with the prepare's and the
    accepted energies within KERNELS_RTOL (``records_parting``). Each
    iteration starts from the same state and lambda in both, so a gap is
    the chain's own on that iteration: two whole runs would each carry
    their own lambda, which parts by ~1e-9 through rho late in a run (the
    chain's energies differ by ~1e-15: summation order) and, where the two
    round to different float32 values, parts the float32 reduced systems
    and with them the energies (PERF.md)."""
    if dev.type != "cuda" or not cfg.use_kernels(dev, problem.state.T.dtype):
        return {mode: None for mode in modes}
    drive_kernels = cuda_chain.DRIVE_KERNELS[cfg.geometry or "f64"]
    kern = {}
    for mode in modes:
        cuda_chain.reset_launches()
        states = []
        res = lm.minimize(problem, mode, cfg, device=dev,
                          states=lambda *s: states.append(s))
        kern[mode] = (res, states, lm.LAST_JIT_RUN["captured"],
                      dict(cuda_chain.LAUNCHES))
    lm.clear_graphs()
    gates = {}
    for mode in modes:
        k, states, captured, launches = kern[mode]
        k_records = [r for _, _, r in states]
        rerun, stops, plain = rerun_iterations(
            problem, mode, dataclasses.replace(cfg, kernels=False), dev, states)
        lm.clear_graphs()
        want = [lm.LMStatus.MaxItersReached] * (len(stops) - 1) + [k.status]
        gap = _rel(k.energy, plain.energy)
        parting = records_parting(k_records, rerun)
        gates[mode] = {
            "iterations": [k.iterations, plain.iterations],
            "fun_evals": [k.fun_evals, plain.fun_evals],
            "energy": [k.energy, plain.energy], "rel_gap": gap, **parting,
            "same_stops": stops == want,
            "kernels_captured": captured, "kernels_launches": launches,
            "ok": (k.iterations, k.fun_evals) == (plain.iterations, plain.fun_evals)
            and gap <= KERNELS_RTOL and parting["parted"] is None
            and stops == want and captured is False
            and min(launches[name] for name in drive_kernels) > 0}
    return gates


def _read_json(rel: str):
    """A reference file (``rel`` to this file's directory); LookupError
    naming it where it is missing or unreadable."""
    path = os.path.join(HERE, rel)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        raise LookupError(f"reference {rel}: {type(e).__name__}: {e}") from e


def endpoint_reference(name: str, mode: str, geometry: str):
    """(d1)'s reference: (source, statistics) or None where none exists
    (the Ladybug stand-in, a BAL path)."""
    if name == "p16":
        return P16_ORACLE, _read_json(P16_ORACLE)["post"]
    if name in ("p126", "p257"):
        key = (os.path.basename(campaign.PROBLEMS[name]), mode, geometry)
        rows = [r for r in _read_json(JAX_ROWS)["rows"]
                if (r["problem"], r["mode"], r["drive"]) == key]
        if not rows:
            raise LookupError(f"reference {JAX_ROWS}: no row {key}")
        return f"{JAX_ROWS} {list(key)}", rows[0]["post"]
    return None


def prefix_reference(name: str, problem, dev):
    """(d2)'s reference: (source, ``oracle_prefix.run_row``'s ``loaded``
    triple on ``problem``)."""
    if name in oracle_prefix.CONFIGS:
        log, npz, _ = oracle_prefix.CONFIGS[name]
        try:
            loaded = oracle_prefix.load(name, dev, problem)
        except (OSError, ValueError) as e:
            raise LookupError(f"reference benchmarks/results/{log} or {npz}: "
                              f"{type(e).__name__}: {e}") from e
        return f"benchmarks/results/{log}, {npz}", loaded
    if name == "p16":
        trace = _read_json(P16_ORACLE)["trace"][:P16_PREFIX_ITERS]
        return (f"{P16_ORACLE} trace[:{P16_PREFIX_ITERS}]",
                (problem, [(r["iter"], r["energy"], r["lam"]) for r in trace], None))
    if name == "ladybug":
        ref = _read_json(LADYBUG_PREFIX)
        try:
            matched = ref["matched"]
            trace = [(r["iter"], r["energy"], r["lam"]) for r in ref["trace"]]
        except (KeyError, TypeError) as e:
            raise LookupError(f"reference {LADYBUG_PREFIX}: no {e}") from e
        return (f"{LADYBUG_PREFIX} (JAX {ref['jax']}, {ref['mode']})",
                (problem, trace, (matched["iter"], matched["stats"])))
    raise LookupError(f"no float64 prefix reference for problem {name!r}")


def reference_gate(problem, name: str, mode: str, geometry: str, warm: dict,
                   warm_state, dev: torch.device) -> dict:
    """Gate (d) of one workload: {endpoint: {source, post, gaps, dominates,
    within} or None, endpoint_none (why there is none), prefix: {source,
    iterations, pairs, matched, gaps, budget, within}, within; error where a
    reference is missing or unreadable, and then within is false}. The
    prefix runs float64 on the jit drive (its graph freed after it)."""
    out = {"endpoint": None, "prefix": None, "within": False}
    try:
        ref = endpoint_reference(name, mode, geometry)
        if ref is None:
            out["endpoint_none"] = f"no endpoint reference for {name}"
        elif warm["status"] == lm.STATUS_STRINGS[lm.LMStatus.MaxItersReached]:
            out["endpoint_none"] = ("the run stopped at its iteration budget, "
                                    "before its own stop")
        else:
            source, ref_post = ref
            post = campaign.post_statistics(warm_state, problem.obs)
            out["endpoint"] = {"source": source, "post": post,
                               **campaign.budget_gaps(post, ref_post,
                                                      campaign.BUDGETS[geometry])}
        source, loaded = prefix_reference(name, problem, dev)
    except LookupError as e:
        out["error"] = str(e)
        return out
    row = oracle_prefix.run_row(name, mode, "jit", dev, loaded)
    out["prefix"] = {"source": source, **{k: row[k] for k in (
        "iterations", "pairs", "matched", "gaps", "budget", "within")}}
    out["within"] = (out["prefix"]["within"] and (
        out["endpoint"] is None or out["endpoint"]["within"]))
    return out


def _rel(a: float, b: float) -> float:
    """|a - b| / |b|: 0 where they are equal, inf where either is not
    finite or b is 0 and they differ."""
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)) or b == 0.0:
        return math.inf
    return abs(a - b) / abs(b)


def _grown(nu: float) -> float:
    """The next growth factor, nu^1.5 (inf once it overflows)."""
    try:
        return nu ** 1.5
    except OverflowError:
        return math.inf


def control_gate(records, cfg: lm.LMConfig, endpoint: dict) -> dict:
    """Gate (d3): every iteration of a run held to the reference's LM rules
    (BacktrackLevMarqCholesky.h:299-353), from its iteration records
    (``lm.IterRecord`` tuples (f, rho, lam0, lam_out, n_trials, accepted,
    energy_out), from the run's first iteration) and its ``endpoint``
    (status string, iterations, fun_evals, energy, lam). The rules are
    written here again, apart from the drives' code:

    - carry: lam0 is the lambda the iteration before ended with, bit for
      bit, and f the energy it accepted within CONTROL_F_RTOL; the
      endpoint's energy and lambda are the last iteration's;
    - growth: trial j runs at lam0 times nu_0 ... nu_(j-2), nu_0 =
      lambda_increase_base, nu <- nu^1.5; an iteration that ends rejected
      ends at its last trial's lambda (CONTROL_LAM_RTOL);
    - accept: accepted exactly where energy_out < f; then rho > 0 and
      lam_out = max(lambda_trial max(1/3, 1 - (2 rho - 1)^3), lambda_min)
      (CONTROL_LAM_RTOL);
    - stop: a trial rejected at lambda > lambda_max (or at a non-finite
      lambda or f, the port's guard) ends the run with ExceededLambdaMax,
      and a smaller one grows lambda; an accept where the flatline test over
      the last ``energy_history_size`` accepted energies holds ends it with
      Success; otherwise the run ends only at max_iter (MaxItersReached) or
      past max_fun_ev (TooManyFunctionEvaluation), and no iteration runs
      after a stop; the endpoint's status and iterations are those;
    - count: fun_evals is the sum of 1 + n_trials.

    Returns {ok, broken: None or {rule, iteration, detail} of the first
    rule broken, iterations, accepts, rejected_trials, mid_accepts
    (accepts with rho below RHO_CLAMP, where the factor exceeds its
    clamp), second_growths (trials whose lambda took two or more growth
    factors), unreached (what the run never exercised), gaps (the largest
    relative gap of carry, growth and accept)}."""
    gaps = {"carry": 0.0, "growth": 0.0, "accept": 0.0}
    first = []

    def fail(rule: str, k: int, detail: str) -> None:
        if not first:
            first.append({"rule": rule, "iteration": k, "detail": detail})

    def gap(rule: str, k: int, got: float, want: float, tol: float,
            what: str) -> None:
        g = _rel(got, want)
        gaps[rule] = max(gaps[rule], g)
        if not g <= tol:
            fail(rule, k, f"{what} {got!r}, the rule's {want!r} ({g:.3g} off)")

    size, status = cfg.energy_history_size, lm.STATUS_STRINGS
    n = len(records)
    accepted_energies = []
    rejected = mid = regrown = evals = 0
    expected = None
    for k, (f, rho, lam0, lam_out, n_trials, accepted, e_out) in enumerate(
            records, 1):
        n_trials, accepted = int(n_trials), bool(accepted)
        evals += 1 + n_trials
        rejected += n_trials - accepted
        regrown += max(0, n_trials - 2)
        if k > 1:
            prev = records[k - 2]
            if lam0 != prev[3]:
                fail("carry", k, f"lam0 {lam0!r}, the lambda iteration {k - 1} "
                     f"ended with {prev[3]!r}")
            gap("carry", k, f, prev[6], CONTROL_F_RTOL,
                f"f, the energy iteration {k - 1} accepted {prev[6]!r}:")
        if n_trials < 1:
            fail("count", k, f"{n_trials} trials")
            continue
        lam, nu = lam0, float(cfg.lambda_increase_base)
        for j in range(1, n_trials):
            if not (lam <= cfg.lambda_max and math.isfinite(lam)
                    and math.isfinite(f)):
                fail("stop", k, f"trial {j} was rejected at lambda {lam!r} "
                     f"(lambda_max {cfg.lambda_max!r}, f {f!r}) and the "
                     "iteration went on")
            lam *= nu
            nu = _grown(nu)
        if accepted != (e_out < f):
            fail("accept", k, f"accepted {accepted} with energy_out {e_out!r} "
                 f"against f {f!r}")
        if not accepted:
            gap("growth", k, lam_out, lam, CONTROL_LAM_RTOL,
                f"rejected after {n_trials} trials from lam0 {lam0!r}, lambda")
            if k < n:
                fail("stop", k, f"the iteration ended rejected and iteration "
                     f"{k + 1} ran")
            elif lam > cfg.lambda_max or not (math.isfinite(lam)
                                              and math.isfinite(f)):
                expected = lm.LMStatus.ExceededLambdaMax
            else:
                fail("stop", k, f"the last trial was rejected at lambda {lam!r}"
                     f" <= lambda_max {cfg.lambda_max!r} and lambda did not grow")
            continue
        if not rho > 0.0:
            fail("accept", k, f"accepted with rho {rho!r}")
        mid += rho < RHO_CLAMP
        factor = max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
        gap("accept", k, lam_out, max(lam * factor, cfg.lambda_min),
            CONTROL_LAM_RTOL, f"rho {rho!r}, trial {n_trials} at lambda "
            f"{lam!r}: lam_out")
        accepted_energies.append(e_out)
        window = accepted_energies[-size:]
        flat = k > size and abs(e_out - max(window)) < cfg.tol_fun * e_out
        if flat and k < n:
            fail("stop", k, f"the flatline test held (energy {e_out!r}, last "
                 f"{size} accepted {window}) and iteration {k + 1} ran")
        elif flat:
            expected = lm.LMStatus.Success
        elif k == n:
            if k + 1 > cfg.max_iter:
                expected = lm.LMStatus.MaxItersReached
            elif evals > cfg.max_fun_ev:
                expected = lm.LMStatus.TooManyFunctionEvaluation
            else:
                fail("stop", k, "the run ended after an accept with no stop "
                     f"rule holding (max_iter {cfg.max_iter}, {evals} of "
                     f"max_fun_ev {cfg.max_fun_ev} evaluations)")
    if n == 0:
        fail("stop", 0, "no iteration recorded")
    elif n > cfg.max_iter:
        fail("stop", n, f"{n} iterations ran, max_iter {cfg.max_iter}")
    if expected is not None:
        iterations = n + (expected in (lm.LMStatus.MaxItersReached,
                                       lm.LMStatus.TooManyFunctionEvaluation))
        if (endpoint["status"], endpoint["iterations"]) != (
                status[expected], iterations):
            fail("stop", n, f"the endpoint says {endpoint['status']!r} after "
                 f"{endpoint['iterations']} iterations, the records "
                 f"{status[expected]!r} after {iterations}")
    if n and (endpoint["energy"], endpoint["lam"]) != (records[-1][6],
                                                        records[-1][3]):
        fail("carry", n, f"the endpoint's energy and lambda {endpoint['energy']!r}, "
             f"{endpoint['lam']!r}, the last iteration's {records[-1][6]!r}, "
             f"{records[-1][3]!r}")
    if endpoint["fun_evals"] != evals:
        fail("count", n, f"fun_evals {endpoint['fun_evals']}, the records' "
             f"iterations and trials {evals}")
    unreached = [what for what, count in (
        ("rejection", rejected), ("mid-range accept", mid),
        ("second growth", regrown)) if not count]
    return {"ok": not first, "broken": first[0] if first else None,
            "iterations": n, "accepts": len(accepted_energies),
            "rejected_trials": rejected, "mid_accepts": mid,
            "second_growths": regrown, "unreached": unreached, "gaps": gaps}


def start_state(problem, cfg: lm.LMConfig):
    """The float64 BAState a run of ``cfg`` starts from: the problem's
    state as the loop holds it (on df32, its points as DF pairs)."""
    if cfg.geometry == "df32":
        return problem_mod.from_fast(problem_mod.to_fast(problem.state),
                                     dtype=torch.float64)
    return lm._float64_state(problem.state)


def control_run(problem, mode: str, cfg: lm.LMConfig, dev: torch.device,
                warm: dict) -> tuple:
    """Gates (d3) and (e) of one workload: one more run of ``cfg`` on the
    timed graph (the graph cache's key leaves out ``chunked``,
    ``lm._graph_key``) with its states observed, each with its iteration
    record, which routes it in chunks of one iteration (a replay and a
    read per iteration). Untimed. Returns (control, ``numerics_gate``'s
    record). Control: seconds, captured (must be false), chunked, replays,
    reads, same_endpoint (status, iterations, evaluations, energy and
    lambda equal the warm-up's ``warm`` bit for bit, tying the records and
    states to the route that was timed), ``control_gate``'s keys with its
    ``ok`` as ``rules``, and ok."""
    states = []
    campaign._sync(dev)
    t0 = time.perf_counter()
    res = lm.minimize(problem, mode, cfg, device=dev,
                      states=lambda *s: states.append(s))
    campaign._sync(dev)
    seconds = time.perf_counter() - t0
    records = [record for _, _, record in states]
    jit = lm.LAST_JIT_RUN
    endpoint = {"status": lm.STATUS_STRINGS[res.status],
                "iterations": res.iterations, "fun_evals": res.fun_evals,
                "energy": res.energy, "lam": res.lam}
    check = control_gate(records, cfg, endpoint)
    same = all(endpoint[k] == warm[k] for k in endpoint)
    out = {"seconds": seconds,
           **{k: jit.get(k) for k in ("captured", "chunked", "replays", "reads")},
           "same_endpoint": same, "rules": check.pop("ok"), **check}
    out["ok"] = out["rules"] and same and out["captured"] is False
    problem = problem.to(dev)
    numerics = numerics_gate(problem, start_state(problem, cfg), states, cfg,
                             endpoint["status"])
    return out, numerics


#: Bounds on the error of a step recovered from two states, relative to
#: the sum of their magnitudes: the update's rounding and the recovery's
#: (float64 cameras: T, K00, k1, k2 added once, subtracted once; float64
#: points; df32 points, DF + float32, to about 2^-48 of the point), and
#: for a rotation (multiplied, multiplied by the transpose, its logarithm
#: taken; entries at most 1) absolute.
RECOVERY_ERR = {"cameras": 4 * 2.0 ** -53, "rotation": 16 * 2.0 ** -53,
                "points": {"f64": 4 * 2.0 ** -53, "df32": 4 * 2.0 ** -48}}


def log_rotation(R: torch.Tensor) -> torch.Tensor:
    """The axis-angle vector of rotations R (..., 3, 3), accurate near the
    identity: sin(t) a = vee(R - R^T) / 2, cos(t) = (tr R - 1) / 2, t by
    atan2. ``rodrigues.log_rodrigues`` goes through the quaternion, whose
    components are square roots of differences of order t^2: near the
    identity it keeps about half of float64's digits of t."""
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1) / 2
    s = torch.linalg.vector_norm(v, dim=-1)
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2
    safe = torch.where(s > 0, s, torch.ones_like(s))
    scale = torch.where(s > 0, torch.atan2(s, c) / safe, torch.ones_like(s))
    return v * scale[..., None]


def recover_step(prev, cur) -> tuple:
    """(dx_points (M, 3), dx_cams (N, 9)) that took float64 BAState ``prev``
    to ``cur``: the camera update of ``models/problem.py`` inverted (T +=
    dT, R <- exp([dw]_x) R, K00 += df, k1, k2 += d), in its column order
    [dT, dw, df, dk1, dk2], and the points' difference."""
    dw = log_rotation(cur.R @ prev.R.transpose(-1, -2))
    dxc = torch.cat([cur.T - prev.T, dw, (cur.K[:, 0, 0] - prev.K[:, 0, 0])[:, None],
                     (cur.k1 - prev.k1)[:, None], (cur.k2 - prev.k2)[:, None]], dim=1)
    return cur.points - prev.points, dxc


def recovery_err(prev, cur, geometry: str) -> tuple:
    """Componentwise bounds (points (M, 3), cameras (N, 9)) on the error of
    ``recover_step``'s step from float64 BAState ``prev`` to ``cur``
    (``RECOVERY_ERR``, relative to |prev| + |cur|; the rotation's
    absolute)."""
    e = RECOVERY_ERR

    def cams(x):
        return torch.cat([x.T.abs(), torch.zeros_like(x.T), x.K[:, 0, 0].abs()[:, None],
                          x.k1.abs()[:, None], x.k2.abs()[:, None]], dim=1)

    scale = cur.T.new_tensor([e["cameras"]] * 3 + [0.0] * 3 + [e["cameras"]] * 3)
    rotation = cur.T.new_tensor([0.0] * 3 + [e["rotation"]] * 3 + [0.0] * 3)
    return ((prev.points.abs() + cur.points.abs()) * e["points"][geometry],
            (cams(prev) + cams(cur)) * scale + rotation)


def _norm(*ts) -> torch.Tensor:
    return torch.sqrt(sum(torch.linalg.vector_norm(t) ** 2 for t in ts))


def block_products(problem, n: int, m: int) -> tuple:
    """(jt, jtj) through ``problem``'s observations, for per-observation
    blocks Bc (K, 2, 9) and Bp (K, 2, 3): jt(Bc, Bp, v) = B^T v, per camera
    (N, 9) and per point (M, 3), of v (K, 2); jtj(Bc, Bp, xc, xp) = B^T B x
    of x = (xc (N, 9), xp (M, 3))."""
    cam, pt = problem.obs.cam_idx.long(), problem.obs.pt_idx.long()

    def jt(Bc, Bp, v):
        return (v.new_zeros((n, 9)).index_add_(0, cam, torch.einsum("kri,kr->ki", Bc, v)),
                v.new_zeros((m, 3)).index_add_(0, pt, torch.einsum("kri,kr->ki", Bp, v)))

    def jtj(Bc, Bp, xc, xp):
        return jt(Bc, Bp, torch.einsum("kri,ki->kr", Bc, xc[cam])
                  + torch.einsum("kri,ki->kr", Bp, xp[pt]))

    return jt, jtj


def step_residual(problem, blocks, dxp, dxc, lam: float, err=None) -> dict:
    """How well the step (dxp, dxc) solves the damped normal equations
    H dx = -g, H = J^T J + lam I, g = J^T f, of ``blocks`` (J's 2 x 9 and
    2 x 3 blocks and f, a ``jacobian.JacobianBlocks``), in float64 through
    the blocks and index sums: no matrix is formed but the diagonal blocks
    U + lam I (9 x 9) and V + lam I (3 x 3). With r = H dx + g, D =
    diag(H), S = D^-1/2 H D^-1/2 and y = D^1/2 dx:

    - eta = ||D^-1/2 r|| / (||S|| ||y|| + ||D^-1/2 g||), the backward
      error of the Jacobi-scaled system; ||S|| is bounded above by its
      largest absolute row sum (S is symmetric, so its 2-norm is at most
      that; an off-diagonal block's entries are summed in absolute value
      per observation, which bounds a sum over repeated pairs too);
    - allowance: the most that an error e of the step, bounded
      componentwise by ``err`` = (points (M, 3), cameras (N, 9)), can add
      to eta: ||D^-1/2 (|J|^T |J| e + lam e)|| over eta's denominator
      (|J|^T |J| e + lam e bounds |H e| row by row); 0 without ``err``.

    One host read."""
    cam, pt = problem.obs.cam_idx.long(), problem.obs.pt_idx.long()
    n, m = dxc.shape[0], dxp.shape[0]
    Jc, Jp, f = (t.to(torch.float64) for t in blocks)
    jt, jtj = block_products(problem, n, m)
    gc, gp = jt(Jc, Jp, f)
    hc, hp = jtj(Jc, Jp, dxc, dxp)
    rc, rp = hc + lam * dxc + gc, hp + lam * dxp + gp
    U = torch.zeros((n, 81), dtype=Jc.dtype, device=Jc.device).index_add_(
        0, cam, torch.einsum("kri,krj->kij", Jc, Jc).reshape(-1, 81)).view(n, 9, 9)
    V = torch.zeros((m, 9), dtype=Jc.dtype, device=Jc.device).index_add_(
        0, pt, torch.einsum("kri,krj->kij", Jp, Jp).reshape(-1, 9)).view(m, 3, 3)
    U = U + lam * torch.eye(9, dtype=U.dtype, device=U.device)
    V = V + lam * torch.eye(3, dtype=V.dtype, device=V.device)
    sc = torch.rsqrt(U.diagonal(dim1=-2, dim2=-1))
    sp = torch.rsqrt(V.diagonal(dim1=-2, dim2=-1))
    Ws = torch.einsum("kri,krj->kij", Jc, Jp).abs() * sc[cam][:, :, None] * sp[pt][:, None, :]
    norm_s = torch.maximum(
        ((U.abs() * sc[:, None, :]).sum(-1) * sc
         + Ws.new_zeros((n, 9)).index_add_(0, cam, Ws.sum(-1))).max(),
        ((V.abs() * sp[:, None, :]).sum(-1) * sp
         + Ws.new_zeros((m, 3)).index_add_(0, pt, Ws.sum(-2))).max())
    den = norm_s * _norm(dxc / sc, dxp / sp) + _norm(gc * sc, gp * sp)
    if err is None:
        allowance = den.new_zeros(())
    else:
        ec, ep = jtj(Jc.abs(), Jp.abs(), err[1], err[0])
        allowance = _norm((ec + lam * err[1]) * sc, (ep + lam * err[0]) * sp) / den
    eta, allowance = torch.stack([_norm(rc * sc, rp * sp) / den, allowance]).tolist()
    return {"eta": eta, "allowance": allowance}


def _trial_lambda(record, cfg: lm.LMConfig) -> float:
    """The lambda an iteration's last trial solved at: lam0 grown by
    lambda_increase_base, nu <- nu^1.5, once per rejected trial before it;
    on df32 rounded to float32, as the df32 trial rounds it."""
    lam, nu = record.lam0, float(cfg.lambda_increase_base)
    for _ in range(int(record.n_trials) - 1):
        lam *= nu
        nu = _grown(nu)
    if cfg.geometry == "df32":
        lam = float(torch.tensor(lam, dtype=torch.float32))
    return lam


def run_blocks(problem, state, geometry: str):
    """The Jacobian blocks and residuals that a run of ``geometry``
    computes at float64 BAState ``state``: the float64 chain, or on df32
    the plain df32 chain (the kernels' plain version, equal to them bit
    for bit) on the state's DF split."""
    if geometry == "df32":
        return jacobian.residuals_and_jacobian_fast(
            problem_mod.to_fast(state), problem.obs, problem.tau2)
    return jacobian.residuals_and_jacobian(state, problem.obs, problem.tau2)


def numerics_gate(problem, x0, states, cfg: lm.LMConfig, status: str) -> dict:
    """Gate (e), "numerics": each accepted iteration of a run, from the
    loop states that ``lm.minimize(..., states=...)`` handed over (a list
    of (iteration, float64 BAState after it, its ``IterRecord``)) and the
    float64 state ``x0`` the run started from (``start_state``):

    - (e1) the step it applied, recovered from the states before and after
      it (``recover_step``), with a bound on the recovery's own rounding
      (``recovery_err``);
    - (e2) that step held to the damped normal equations at the state
      before it, at the lambda its accepted trial solved at
      (``_trial_lambda``), of the Jacobian and residuals the run itself
      computes there (``run_blocks``: on df32 the float32 chain), summed
      in float64: ``step_residual``'s eta less the allowance for the
      recovery's rounding (eta's excess) within NUMERICS_BOUNDS. An
      iteration whose allowance alone exceeds the bound is loose: its step
      lies under the states' rounding, so it is held only to that
      rounding, not to the bound, and counts as unchecked;
    - (e3) the accepted trial's energy (``energy_out``, summed by the
      run's own chain) against the float64 energy of the state after it
      (``projection.energy``), relative, within the bound energy_gap.

    Rejected trials leave no state and are not checked, and neither is a
    run's final accept where the flatline test discards its step
    (``discard_final_step``: the state does not move). The checker runs
    none of the solve's code (no ``schur``, no camera update): only the
    port's chains and energy.

    Returns {seconds, checked (accepted iterations checked), discarded,
    loose (of those checked, the iterations held only to the recovery's
    rounding), eta (eta's excess), allowance and energy_gap (each {max,
    iteration, lam, rho}: the largest over the run; eta's with eta and
    the allowance there), bounds, over (the first iteration over a bound:
    {iteration, what, value, bound}, or None), ok}; with error (and ok
    false) where the check cannot run, or where no iteration was
    checked."""
    t0 = time.perf_counter()
    geometry = cfg.geometry or "f64"
    bounds = NUMERICS_BOUNDS[geometry]
    names = ("eta", "allowance", "energy_gap")
    out = {"checked": 0, "discarded": 0, "loose": 0, "bounds": bounds, "over": None,
           **{k: {"max": 0.0, "iteration": None} for k in names}}
    discard = (status == lm.STATUS_STRINGS[lm.LMStatus.Success]
               and cfg.discard_final_step)
    try:
        prev = x0
        for i, (it, state, record) in enumerate(states):
            if not record.accepted:
                continue
            if discard and i == len(states) - 1:
                out["discarded"] += 1
                continue
            lam = _trial_lambda(record, cfg)
            dxp, dxc = recover_step(prev, state)
            res = step_residual(problem, run_blocks(problem, prev, geometry), dxp, dxc,
                                lam, recovery_err(prev, state, geometry))
            read = {"eta": res["eta"] - res["allowance"], "allowance": res["allowance"],
                    "energy_gap": _rel(record.energy_out, float(
                        projection.energy(state, problem.obs, problem.tau2)))}
            out["checked"] += 1
            out["loose"] += res["allowance"] > bounds["eta"]
            for k in names:
                if not read[k] <= out[k]["max"] or out[k]["iteration"] is None:
                    out[k] = {"max": read[k], "iteration": it, "lam": lam,
                              "rho": record.rho}
                    if k == "eta":
                        out[k].update(res)
            for k, bound in bounds.items():
                if out["over"] is None and not read[k] <= bound:
                    out["over"] = {"iteration": it, "what": k, "value": read[k],
                                   "bound": bound}
            prev = state
        if not out["checked"]:
            out["error"] = "no accepted iteration to check"
    except Exception as e:  # the gate fails, with its reason on the line
        out["error"] = f"{type(e).__name__}: {e}"
    out["seconds"] = time.perf_counter() - t0
    out["ok"] = out["over"] is None and "error" not in out
    return out


#: The planted faults of gate (e): the factor on the reduced camera
#: system's right-hand side (``step-scaled``), in float64 and at df32,
#: where the smallest scaling of those measured at p257 cholesky (1e-3,
#: 3e-3, 1e-2, 0.1, 0.3, 1, 3) that fails (e) is 0.3 (NUMERICS_BOUNDS),
#: and on both chain entry points' energies (``energy-scaled``: 19x the
#: largest clean df32 gap measured, 10x the df32 bound).
STEP_FAULT = 1e-3
STEP_FAULT_DF32 = 0.3
ENERGY_FAULT = 1e-2


class Fault(NamedTuple):
    """A planted fault: the gate that must catch it, the patches that plant
    it ((module, attribute, replacement), ...), and the count in that
    gate's record that says a run reached it."""

    gate: str
    patches: tuple
    reach: str


def planted_faults(step: float = STEP_FAULT) -> dict:
    """Faults that the gates must catch, {name: Fault}. Gate (d3)'s, in the
    LM rules, each a replacement for one function of ``lm`` that both
    drives call: Nielsen's middle range made linear, max(1/3, 1 - (2 rho -
    1)), wrong at rho below 5/6 but 1/2; the growth nu <- nu^2 from a
    second growth on; the factor inverted (lambda x 3 on a good step) at
    every accept. Gate (e)'s move only the numbers, so that (d3) passes:
    the reduced camera system's right-hand side scaled by 1 + ``step`` in
    ``schur.assemble_reduced`` (the camera solver "chol": cholesky,
    qrchol, moreqr), and both chain entry points' energies, kernel and
    plain, scaled by 1 + ENERGY_FAULT (df32). On CUDA the graph that a run
    replays must be captured under the fault (``lm.clear_graphs()``
    first)."""
    nielsen = lm._nielsen

    def linear(rho):
        factor = 2.0 - 2.0 * rho
        if isinstance(factor, torch.Tensor):
            return torch.clamp(factor, min=1.0 / 3.0)
        return max(1.0 / 3.0, factor)

    def squared(base: float) -> list:
        table = [float(base)]
        for _ in range(lm._GROWTH - 1):
            try:
                table.append(table[-1] ** 2)
            except OverflowError:
                table.append(math.inf)
        return table

    assemble = schur.assemble_reduced

    def scaled_rhs(*args):
        S, b = assemble(*args)
        return S, b * (1.0 + step)

    def scaled_energy(fn, blocks: bool):
        def scaled(*args, **kw):
            out = fn(*args, **kw)
            if blocks:
                return out[0], out[1] * (1.0 + ENERGY_FAULT)
            return out * (1.0 + ENERGY_FAULT)
        return scaled

    energies = tuple(
        (cuda_chain, name, scaled_energy(getattr(cuda_chain, name), "blocks" in name))
        for name in ("fused_blocks_energy", "fused_energy",
                     "fused_blocks_energy_plain", "fused_energy_plain"))
    return {"middle-range": Fault("control", ((lm, "_nielsen", linear),), "mid_accepts"),
            "growth-squared": Fault("control", ((lm, "growth_table", squared),),
                                    "second_growths"),
            "inverted": Fault("control", ((lm, "_nielsen", lambda rho: 1.0 / nielsen(rho)),),
                              "accepts"),
            "step-scaled": Fault("numerics", ((schur, "assemble_reduced", scaled_rhs),),
                                 "checked"),
            "energy-scaled": Fault("numerics", energies, "checked")}


@contextlib.contextmanager
def planted(fault: Fault):
    """Plant ``fault``'s patches for the block, and take them out after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in fault.patches]
    try:
        for mod, name, replacement in fault.patches:
            setattr(mod, name, replacement)
        yield
    finally:
        for mod, name, original in saved:
            setattr(mod, name, original)


def _same(a: dict, b: dict) -> bool:
    return all(a[k] == b[k] for k in ("status", "iterations", "fun_evals", "energy"))


def workload(name: str, mode: str, cfg: lm.LMConfig, warm: dict, runs: list,
             e0: float, reserved, kernels, reference: dict,
             control: dict, numerics: dict) -> dict:
    """A workload's record: its rate over the timed runs and its gates."""
    rates = [r["it_per_s"] for r in runs]
    gates = {
        "replay": all(_same(r, warm) for r in runs),
        "no_capture_in_window": all(not r["captured"] for r in runs),
        "kernels_vs_plain": kernels,
        "descent": all(math.isfinite(r["energy"]) and r["energy"] < e0
                       and r["status"] in DESCENT_STOPS and r["points_ok"]
                       for r in [warm] + runs),
        "reference": reference["within"],
        "control": control["ok"],
        "numerics": numerics["ok"],
    }
    peaks = [r["peak_bytes"] for r in runs if r["peak_bytes"] is not None]
    return {
        "bench": "workload", "problem": name, "mode": mode,
        "geometry": cfg.geometry or "f64", "matmul_dtype": cfg.matmul_dtype,
        "drive": cfg.drive, "max_iter": cfg.max_iter, "repeats": len(runs),
        "capture_s": warm["capture_s"], "warmup_wall_s": warm["wall_s"],
        "initial_energy": e0,
        **{k: warm[k] for k in ("status", "iterations", "fun_evals", "energy")},
        "it_per_s": {"median": statistics.median(rates), "min": min(rates),
                     "max": max(rates)},
        "runs_it_per_s": rates,
        "reads": [r["reads"] for r in runs],
        "replays": [r["replays"] for r in runs],
        "launches": [r["launches"] for r in runs],
        "peak_bytes": max(peaks) if peaks else None, "reserved_bytes": reserved,
        "gates": gates, "reference": reference, "control": control,
        "numerics": numerics,
        "correct": (gates["replay"] and gates["no_capture_in_window"]
                    and gates["descent"] and (kernels is None or kernels["ok"])
                    and gates["reference"] and gates["control"]
                    and gates["numerics"]),
        "runs": runs,
    }


def run_workloads(problem, name: str, modes, cfg: lm.LMConfig, repeats: int,
                  device=None, out=emit) -> list:
    """bench.py's workload for each of ``modes`` on one problem: the
    warm-ups, ``repeats`` rounds of timed runs (the modes alternated in
    each), then each workload's gates. Prints a line per warm-up, timed run
    and workload (``out``) and returns the workload records, each with its
    timed runs. Raises without CUDA and without ``device``.

    The jit drive's graph cache is keyed by the problem object
    (``lm._graph_key`` holds its id), and a capture for another problem
    frees this one's graphs (``lm._device_loop``): so one problem object
    serves the warm-ups, every timed run and the gates, it is never
    reloaded between them, and problems are run one after another. A timed
    run that captured (``LAST_JIT_RUN["captured"]``) fails gate (a); gate
    (d3)'s observed runs and then gate (b)'s kernel prefixes replay the
    timed graphs before any is freed, and gate (d)'s float64 prefixes run
    after (b)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    prepare, _, to_loop, _ = lm.step_functions(problem, modes[0], cfg, dev)
    e0 = float(prepare(to_loop(problem.state))[1])
    warm, warm_state, runs = {}, {}, {mode: [] for mode in modes}
    for mode in modes:
        warm[mode], warm_state[mode] = timed_run(problem, mode, cfg, dev)
        out({"bench": "warmup", "problem": name, **warm[mode]})
    for round_ in range(repeats):
        for mode in modes:
            runs[mode].append(timed_run(problem, mode, cfg, dev)[0])
            out({"bench": "run", "problem": name, "round": round_,
                 **runs[mode][-1]})
    reserved = torch.cuda.memory_reserved(dev) if cuda else None
    control, numerics = {}, {}
    for mode in modes:
        control[mode], numerics[mode] = control_run(problem, mode, cfg, dev,
                                                    warm[mode])
    kernels = kernels_vs_plain(problem, modes, cfg, dev)
    geometry = cfg.geometry or "f64"
    reference = {mode: reference_gate(problem, name, mode, geometry, warm[mode],
                                      warm_state[mode], dev) for mode in modes}
    records = []
    for mode in modes:
        records.append(workload(name, mode, cfg, warm[mode], runs[mode], e0,
                                reserved, kernels[mode], reference[mode],
                                control[mode], numerics[mode]))
        out({k: v for k, v in records[-1].items() if k != "runs"})
    return records


def last_line(name: str, records: list, device_line: str) -> dict:
    """bench.py's line (bench.py:68-98): the first workload's median rate
    is the headline, every workload's its own field."""
    metric = f"lm_iter_per_sec_{name}_{records[0]['mode']}"
    value = records[0]["it_per_s"]["median"]
    # bench.py's vs_baseline where bench_baseline.json has no entry for the
    # metric: it holds only p21's scipy rate, and p21 is not in the repo.
    line = {"metric": metric, "value": round(value, 4), "unit": "iter/s",
            "vs_baseline": 1.0, "baseline": None}
    for r in records:
        line[f"{name}_{r['mode']}_iter_per_sec"] = round(r["it_per_s"]["median"], 4)
    line["correct"] = all(r["correct"] for r in records)
    line["device"] = device_line
    return line


def main(argv=None, out=emit) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--problem", default=PROBLEM,
                    help="p16, p126, p257, ladybug or the path of a BAL file")
    ap.add_argument("--modes", default=",".join(MODES),
                    help=f"comma list of {', '.join(schur.MODES)}")
    ap.add_argument("--geometry", default="df32", choices=("df32", "f64"))
    ap.add_argument("--max-iter", type=int, default=MAX_ITER)
    ap.add_argument("--repeats", type=int, default=REPEATS,
                    help=f"timed runs per workload (at least {CARD_REPEATS} "
                    "on CUDA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    modes = tuple(args.modes.split(","))
    unknown = [m for m in modes if m not in schur.MODES]
    if unknown:
        ap.error(f"unknown modes {unknown}; choose from {schur.MODES}")
    known = args.problem in campaign.PROBLEMS or args.problem == "ladybug"
    if not known and not os.path.exists(args.problem):
        ap.error(f"no problem {args.problem!r}")
    if args.max_iter < 1:
        ap.error("--max-iter must be at least 1")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 2
    cuda = device.type == "cuda"
    if args.repeats < (CARD_REPEATS if cuda else 1):
        ap.error(f"--repeats {args.repeats}: at least "
                 f"{CARD_REPEATS if cuda else 1} on {device.type}")
    # TF32 would run the float32 Schur matmuls on the tensor cores' 10-bit
    # mantissa and change the numbers.
    if cuda and torch.backends.cuda.matmul.allow_tf32:
        print("bench_torch: torch.backends.cuda.matmul.allow_tf32 is on",
              file=sys.stderr)
        return 2
    cfg = campaign.drive_config(args.geometry, args.max_iter)
    name = problem_name(args.problem)
    t0 = time.perf_counter()
    problem, source = campaign.load_problem(args.problem, device)
    device_line = campaign.card() if cuda else "cpu"
    out({"bench": "header", "card": device_line,
         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
         "torch": torch.__version__, "cuda": torch.version.cuda,
         "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
         "problem": name, "source": source, "n_cameras": problem.n_cameras,
         "n_points": problem.n_points, "n_observations": problem.n_observations,
         "load_s": time.perf_counter() - t0, "modes": list(modes),
         "config": dataclasses.asdict(cfg), "kernels": cfg.use_kernels(device),
         "repeats": args.repeats})
    records = run_workloads(problem, name, modes, cfg, args.repeats, device, out)
    line = last_line(name, records, device_line)
    out(line)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
