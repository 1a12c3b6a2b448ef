"""The comparison that decides a run's ``correct``.

It judges what the timed path produced against the float64 reference
(``portbench/reference``), which works everything out again from the raw
BAL arrays and the start deltas that the harness handed to the program:

* every solve of the window, by its answer: the final state, the energy it
  claims for it and its stop. ``end_energy_gap`` is the claimed energy
  against the reference's energy of the returned state, relative (on a
  flatline stop the claim is the discarded last trial's energy, which the
  flatline rule puts within ``tol_fun`` of the state's: that much is
  allowed there). ``end_gain`` is what one float64 LM iteration of the
  reference, from the returned state at the mode's first-iteration
  lambda, still takes off the energy, as a share of what the solve took
  off from its start: a solve that stopped short of the optimum leaves
  a large share. A solve whose returned state is not finite, whose
  reference energy is not below its start's, or whose stop is none of
  the three the LM has, counts as ``failed``.
* one solve drawn from the seed, step by step over its first iterations:
  the program's state after each iteration k (the same captured graph
  replayed with ``max_iter`` k) against the reference's own iteration k
  from the program's state after k - 1 and its lambda (the mode's rule at
  k = 1): lambda after the iteration (``lam_gap``; a different number of
  trials shows here too), the program's step (its state after less its
  state before) in the reference's damped normal equations at the state
  before and the lambda of the program's accepted trial, by its
  Jacobi-scaled backward error (``step_error``; the directions that no
  observation fixes, BA's gauge, enter it only through lambda, so the
  error reads the step where the data decide it), the energy the
  program claims against the reference's of its state
  (``iter_energy_gap``), and what the program's step leaves of the
  energy against the reference's own step from the same state at the
  lambda of the program's accepted trial (``step_loss``: the median over
  the followed iterations of the gap of the two energies after the step,
  each as a share of the decrease of the reference's first step; a step
  that is too long or too short shows in every iteration, x1.3 at about
  0.3, while the program's float32 camera solve can miss in one hard
  iteration, which the median leaves out).
  The reference follows the program from the program's own states; its
  iteration 1 starts from the start the harness made.

Every number is held to the limit the cell's file gives it.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics

import torch

from portbench.reference import ba

#: The stops a solve may report.
STOPS = ("flatlined", "lambda_max", "max_iters")


@dataclasses.dataclass
class Answer:
    """One solve as the program returned it: its index in the window, the
    final state (ba.State, float64), the energy it claims and its stop."""

    index: int
    state: ba.State
    energy: float
    stop: str


@dataclasses.dataclass
class Step:
    """The program after ``k`` iterations of one solve (k = 0: the start):
    its state, claimed energy, lambda, evaluations and stop."""

    k: int
    state: ba.State
    energy: float | None
    lam: float | None
    fun_evals: int
    stop: str | None


def draw(seed: int, n: int, what: str) -> int:
    """An index in [0, n) drawn from the run's seed."""
    return random.Random(f"portbench-{what}:{int(seed)}").randrange(n)


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)) or b == 0:
        return math.inf
    return abs(a - b) / abs(b)


def _finite(s: ba.State) -> bool:
    return all(bool(torch.isfinite(t).all())
               for t in (s.R, s.T, s.f, s.k1, s.k2, s.X))


def judge(prob: ba.Problem, start_of, answers: list, steps: list, mode: str,
          tol_fun: float, limits: dict) -> dict:
    """{"numbers": {name: value}, "failed": solves judged wrong,
    "correct": bool, "notes": [...], "solves": each answer's reference
    energies, "iterations": each followed iteration's}. ``start_of(i)``
    gives the reference state of start ``i``; ``steps`` is one solve's
    [Step k = 0, 1, ...]."""
    notes, solves = [], []
    failed = 0
    end_gap = end_gain = 0.0
    for a in answers:
        if not _finite(a.state) or a.stop not in STOPS:
            failed += 1
            notes.append(f"solve {a.index}: stop {a.stop!r}, finite {_finite(a.state)}")
            continue
        e = ba.energy(a.state, prob)
        e0 = ba.energy(start_of(a.index), prob)
        if not e < e0:
            failed += 1
            notes.append(f"solve {a.index}: energy {e!r} not below its start's {e0!r}")
        gap = _rel(a.energy, e)
        if a.stop == "flatlined":
            gap = max(0.0, gap - tol_fun)
        end_gap = max(end_gap, gap)
        solve = {"index": a.index, "stop": a.stop, "start": e0, "end": e,
                 "claimed": a.energy}
        if e < e0:
            after = ba.lm_iteration(a.state, prob, None, mode)
            if after.accepted:
                solve["gain"] = (e - after.energy) / (e0 - e)
                end_gain = max(end_gain, solve["gain"])
                solve["next"] = e - after.energy
                # The reference's next point step in float32 ulps of the
                # point: under 1, a float32 state cannot take it.
                solve["next_step_ulps"] = float(torch.median(
                    after.dX.abs().amax(1) / (torch.finfo(torch.float32).eps
                                              * a.state.X.abs().amax(1))))
        solves.append(solve)
    readings = {"end_energy_gap": end_gap, "end_gain": end_gain}
    iterations = []
    readings.update(follow(prob, steps, mode, notes, iterations))
    numbers = {k: v for k, v in readings.items() if k in limits}
    over = {k: v for k, v in numbers.items() if not v <= limits[k]}
    for k, v in over.items():
        notes.append(f"{k} {v!r} over its limit {limits[k]!r}")
    correct = bool(answers) and failed == 0 and not over
    return {"numbers": numbers, "readings": readings, "failed": failed,
            "correct": correct, "notes": notes, "solves": solves,
            "iterations": iterations}


def follow(prob: ba.Problem, steps: list, mode: str, notes: list,
           iterations: list) -> dict:
    """The step-by-step numbers of one solve (see the module docstring);
    what each iteration read is appended to ``iterations``."""
    out = {"iter_energy_gap": 0.0, "lam_gap": 0.0, "step_error": 0.0}
    first_decrease = None
    losses = []
    checked = 0
    for prev, cur in zip(steps, steps[1:]):
        if cur.stop != "max_iters":
            notes.append(f"iteration {cur.k}: the program stopped ({cur.stop})")
            break
        ref = ba.lm_iteration(prev.state, prob, prev.lam, mode)
        if not ref.accepted:
            out["lam_gap"] = math.inf
            notes.append(f"iteration {cur.k}: the reference stops, the program goes on")
            break
        e_cur = ba.energy(cur.state, prob)
        trials = cur.fun_evals - prev.fun_evals - 1
        if trials != ref.trials:
            notes.append(f"iteration {cur.k}: {trials} trials, the reference {ref.trials}")
        dc = ba.camera_change(prev.state, cur.state)
        dX = cur.state.X - prev.state.X
        lam_trial = ref.lam0
        for t in range(trials - 1):
            lam_trial *= ba.growth(ba.LMRules.lambda_increase_base, t)
        # The reference's own step at the program's state and the lambda
        # of the program's accepted trial.
        e_ref = ref.energy if trials == ref.trials else \
            ba.step_energy(prev.state, prob, lam_trial)
        e_prev = ba.energy(prev.state, prob)
        if first_decrease is None:
            first_decrease = e_prev - e_ref
        iterations.append({"k": cur.k, "trials": trials, "ref_trials": ref.trials,
                           "lam": lam_trial, "before": e_prev, "program": e_cur,
                           "reference": e_ref})
        losses.append(abs(e_cur - e_ref) / first_decrease
                      if first_decrease > 0 else math.inf)
        gaps = {
            "iter_energy_gap": _rel(cur.energy, e_cur),
            "step_error": ba.backward_error(prev.state, prob, lam_trial,
                                            dX, dc),
            "lam_gap": _rel(cur.lam, ref.lam),
        }
        for k, v in gaps.items():
            out[k] = max(out[k], v) if not math.isnan(v) else math.inf
        checked += 1
    out["step_loss"] = statistics.median(losses) if losses else math.inf
    if checked == 0:
        out["lam_gap"] = math.inf
        notes.append("no iteration could be followed")
    return out
