"""One run of one cell: set-up, the measured window, the optional trace,
the step-by-step replay of one solve, and the check.

This is the only module of the benchmark that imports the port under test
(``bundleadjustment_benchmarks_tpu_torch``). From it the benchmark takes
the problem builder, ``lm.minimize`` (the entry the window drives),
``lm.LAST_JIT_RUN`` (its counters) and ``lm.clear_graphs``.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.core import baltext, balgen, check, registry, trace, traffic
from portbench.reference import ba

SPAN = "portbench."
#: The LM's stops by the short names the check uses.
STOP_NAMES = {"Success": "flatlined", "ExceededLambdaMax": "lambda_max",
              "MaxItersReached": "max_iters"}
#: The controls: the port's own lower-precision paths. "float32": a
#: float32 problem on the float32 drive (geometry, state and matmuls in
#: float32), the step below both df32 and float64.
CONTROLS = ("float32",)
#: The iterations of one solve of each run followed step by step.
FOLLOW_ITERATIONS = 3
#: Groups of ``trace_solves`` solves a traced run records at most before
#: one holds every chain-kernel launch the port counted in it.
TRACE_TRIES = 3
#: Device operations a process traces at most, over all its groups. On
#: the H100 (torch 2.11, CUDA 12.8) the profiler records no kernel of a
#: CUDA graph past ~349,900 operations traced in one process, and the
#: next profiler session then crashes the process (illegal address). A
#: group is traced again only while the operations traced so far and the
#: last group's count stay below this.
TRACE_RECORDS = 300_000


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers read it."""

    cell: registry.Cell
    card: str
    setup_s: float
    window_s: float
    solves: list
    mem_bytes: list
    capture_s: float
    sizes: tuple
    trace: trace.Trace | None = None
    traced: list = dataclasses.field(default_factory=list)
    trace_complete: bool | None = None
    trace_tries: int = 0


def raw_arrays(config: dict, root: str = registry.ROOT) -> dict:
    """The configuration's raw BAL arrays: read from its file (whose
    sha256 the configuration pins) or made by the frozen generator."""
    data = config["data"]
    if data["kind"] == "bal_file":
        path = f"{root}/{data['path']}"
        digest = baltext.sha256(path)
        if digest != data["sha256"]:
            raise RuntimeError(f"{data['path']}: sha256 {digest}, the "
                               f"configuration pins {data['sha256']}")
        return baltext.read_bal(path)
    if data["kind"] == "balgen":
        return balgen.generate_bal_like(
            config["n_cameras"], config["n_points"], seed=data["seed"],
            mean_degree=data["mean_degree"])
    raise ValueError(f"unknown data kind {data['kind']!r}")


def ref_state(s) -> ba.State:
    """A port BAState as the reference's float64 State, on the host."""
    def h(t):
        return t.detach().to("cpu", torch.float64)
    return ba.State(R=h(s.R), T=h(s.T), f=h(s.K[:, 0, 0]), k1=h(s.k1),
                    k2=h(s.k2), X=h(s.points))


def mem_used(dev) -> int:
    free, total = torch.cuda.mem_get_info(dev)
    return total - free


@dataclasses.dataclass
class Window:
    """The window's solves (their counters and stops), their final states
    on the host, its seconds and the trace of the solves
    ``first_traced`` .. ``first_traced + n_traced - 1``."""

    solves: list
    kept: list
    seconds: float
    trace: trace.Trace | None
    n_traced: int
    first_traced: int = 0
    #: Chain-kernel launches in the traced solves by the port's own counter
    #: (``cuda_chain.LAUNCHES``), against which the trace is checked.
    traced_launches: int = 0
    #: Whether the trace holds every one of those launches.
    trace_complete: bool | None = None
    #: Groups of solves traced before one came out complete (or the last).
    trace_tries: int = 0


class Program:
    """The port set up for one cell: the problem built from ``raw``, the
    LM config of the cell's traffic (or of a control), and the warm-up
    solve from the configuration's own state, which captures the graph."""

    def __init__(self, cell: registry.Cell, raw: dict, device,
                 control: str | None = None):
        from bundleadjustment_benchmarks_tpu_torch.io.bal import BalDataset
        from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
        from bundleadjustment_benchmarks_tpu_torch.solvers import lm

        if control is not None and control not in CONTROLS:
            raise ValueError(f"unknown control {control!r}")
        self.lm = lm
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        spec, conf = cell.traffic, cell.config
        # Every cell states float32 matmuls without TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dtype = torch.float32 if control == "float32" else torch.float64
        self.problem = pm.from_bal_dataset(
            BalDataset(**raw), dtype=dtype,
            inlier_threshold=conf["inlier_threshold"], device=self.dev)
        if control == "float32":
            self.cfg = lm.LMConfig(max_iter=spec["max_iter"], matmul_dtype="float32")
        elif spec["geometry"] == "df32":
            self.cfg = lm.LMConfig(max_iter=spec["max_iter"], geometry="df32",
                                   matmul_dtype="float32")
        else:
            self.cfg = lm.LMConfig(max_iter=spec["max_iter"])
        self.mode = spec["mode"]
        p = self.problem
        self.sizes = (p.n_cameras, p.n_points, p.n_observations)
        self.scales = conf["assumed"]["start_perturbation"]
        self.spec = cell.spec
        lm.minimize(p, self.mode, self.cfg, device=self.dev)
        self.sync()
        self.capture_s = float(lm.LAST_JIT_RUN.get("capture_s") or 0.0)
        self.mem = [mem_used(self.dev)] if self.cuda else []

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def start(self, seed: int, i: int):
        base = self.problem.state
        dT, dX = traffic.start_deltas(*traffic.start_key(self.spec, seed, i),
                                      *self.sizes[:2], self.scales, self.dev)
        return dataclasses.replace(base, T=base.T + dT.to(base.T.dtype),
                                   points=base.points + dX.to(base.points.dtype))

    def window(self, seed: int, seconds: float, n_traced: int = 0) -> Window:
        """Solves from starts 0, 1, ... until one ends past ``seconds``.
        With ``n_traced``, ``torch.profiler`` records the solves in groups
        of ``n_traced``, from the first, until a group's trace holds every
        chain-kernel launch that the port counted in it, ``TRACE_TRIES``
        groups and ``TRACE_RECORDS`` operations at most; the window runs on
        past ``seconds`` until then."""
        from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain

        lm = self.lm
        solves, kept = [], []
        prof = None
        got = Window([], [], 0.0, None, 0)
        first = recorded = 0

        def retrace() -> bool:
            if not n_traced or got.trace_complete:
                return False
            return got.trace is None or (
                got.trace_tries < TRACE_TRIES
                and recorded + len(got.trace.ops) < TRACE_RECORDS)

        t0 = time.perf_counter()
        i = 0
        while True:
            if prof is None and retrace():
                cuda_chain.reset_launches()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.__enter__()
                first = i
            with record_function(SPAN + "solve"):
                with record_function(SPAN + "start"):
                    s = self.start(seed, i)
                with record_function(SPAN + "replay_and_read"):
                    res = lm.minimize(self.problem, self.mode, self.cfg, state=s,
                                      device=self.dev)
                with record_function(SPAN + "keep"):
                    kept.append(ref_state(res.state))
                    self.sync()
            jit = lm.LAST_JIT_RUN
            solves.append({
                "iterations": res.iterations, "fun_evals": res.fun_evals,
                "stop": STOP_NAMES.get(lm.LMStatus(res.status).name, "other"),
                "energy": float(res.energy), "lam": float(res.lam),
                **{key: jit.get(key) for key in ("captured", "slots", "prepares")}})
            i += 1
            if prof is not None and i - first == n_traced:
                prof.__exit__(None, None, None)
                launches = sum(cuda_chain.LAUNCHES.values())
                tr = trace.from_profiler(prof, SPAN)
                recorded += len(tr.ops)
                prof = None
                got = Window([], [], 0.0, tr, n_traced, first, launches,
                             trace.kernel_time_s(tr, ("chain_",))[1] >= launches,
                             got.trace_tries + 1)
            if time.perf_counter() - t0 >= seconds and prof is None \
                    and not retrace():
                break
        elapsed = time.perf_counter() - t0
        if self.cuda:
            self.mem.append(mem_used(self.dev))
        return dataclasses.replace(got, solves=solves, kept=kept, seconds=elapsed)

    def follow(self, seed: int, j: int, iterations: int) -> list:
        """Solve ``j`` replayed with ``max_iter`` 1, 2, ...: [check.Step]
        from k = 0 (the start, as the program holds it) until the program
        stops or ``iterations`` are done."""
        lm = self.lm
        steps = [check.Step(0, ref_state(self.start(seed, j)), None, None, 0, None)]
        captured = False
        for k in range(1, iterations + 1):
            r = lm.minimize(self.problem, self.mode,
                            dataclasses.replace(self.cfg, max_iter=k),
                            state=self.start(seed, j), device=self.dev)
            captured |= bool(lm.LAST_JIT_RUN.get("captured"))
            steps.append(check.Step(
                k, ref_state(r.state), float(r.energy), float(r.lam),
                r.fun_evals, STOP_NAMES.get(lm.LMStatus(r.status).name, "other")))
            if steps[-1].stop != "max_iters":
                break
        self.follow_captured = captured
        return steps

    def close(self) -> None:
        """Free the program: its problem and every cached graph."""
        self.problem = None
        self.lm.clear_graphs()
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def start_profiler(dev) -> None:
    """A profiler session over one small device operation, thrown away.
    On the card the profiler (CUPTI) records the kernels of a CUDA graph
    only where the graph was captured after the profiler first ran in the
    process (on an H100, a p257 float64 solve's graph captured before it:
    1,462 device operations recorded of ~95,000), so a traced run calls
    this before its set-up captures the graph."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def judge(cell: registry.Cell, raw: dict, seed: int, win: Window, j: int,
          steps: list, tol_fun: float, captures: int, device) -> dict:
    """``check.judge`` of one run on ``device``, the program freed."""
    conf = cell.config
    dev = torch.device(device)
    prob, state0 = ba.from_raw(raw, conf["inlier_threshold"], dev)
    n, m = prob.n_cameras, prob.n_points
    scales = conf["assumed"]["start_perturbation"]

    def start_of(idx):
        dT, dX = traffic.start_deltas(*traffic.start_key(cell.spec, seed, idx),
                                      n, m, scales, dev)
        return dataclasses.replace(state0, T=state0.T + dT, X=state0.X + dX)

    def on(s):
        return ba.State(*(t.to(dev) for t in (s.R, s.T, s.f, s.k1, s.k2, s.X)))

    answers = [check.Answer(idx, on(win.kept[idx]), sv["energy"], sv["stop"])
               for idx, sv in enumerate(win.solves)]
    steps = [dataclasses.replace(st, state=on(st.state)) for st in steps]
    steps[0].state = start_of(j)
    verdict = check.judge(prob, start_of, answers, steps, cell.traffic["mode"],
                          tol_fun, cell.spec["limits"])
    verdict["numbers"]["window_captures"] = float(captures)
    if not captures <= cell.spec["limits"]["window_captures"]:
        verdict["correct"] = False
        verdict["notes"].append(f"{captures} captures after set-up")
    return verdict


def run(cell: registry.Cell, seed: int, seconds: float, traced: bool,
        device, t_process: float, control: str | None = None) -> dict:
    """One run. Returns {"run": Run, "verdict": check.judge's dict}.
    ``t_process``: the process's start on ``time.time()``'s clock, where
    set-up begins."""
    raw = raw_arrays(cell.config)
    if traced:
        start_profiler(torch.device(device))
    prog = Program(cell, raw, device, control)
    n_traced = max(1, int(cell.spec.get("trace_solves", 1))) if traced else 0
    setup_s = time.time() - t_process
    win = prog.window(seed, seconds, n_traced)
    j = check.draw(seed, len(win.solves), "follow")
    steps = prog.follow(seed, j, FOLLOW_ITERATIONS)
    captures = sum(bool(s["captured"]) for s in win.solves) + prog.follow_captured
    out = Run(cell=cell, card=torch.cuda.get_device_name(prog.dev) if prog.cuda else "cpu",
              setup_s=setup_s, window_s=win.seconds, solves=win.solves,
              mem_bytes=prog.mem, capture_s=prog.capture_s, sizes=prog.sizes,
              trace=win.trace,
              traced=win.solves[win.first_traced:win.first_traced + win.n_traced],
              trace_complete=win.trace_complete, trace_tries=win.trace_tries)
    tol_fun = prog.cfg.tol_fun
    prog.close()
    verdict = judge(cell, raw, seed, win, j, steps, tol_fun, captures, device)
    return {"run": out, "verdict": verdict}
