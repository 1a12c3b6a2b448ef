"""Faults planted in the port under the timed path, for the benchmark's own
tests and for reading a fault's numbers on the card
(``tools/calibrate.py --faults``). Each is planted before the program is
set up (so a capture records it) and undone by its ``undo``; the
benchmark's runs never plant one.

* ``unchanged``: a trial returns its state unchanged;
* ``half_batch``: the energy over the first half of the observations,
  times two (the mean over the half kept);
* ``step_scaled``: every damped step, cameras and points, times 1.3;
* ``answer_altered``: the energy a solve returns, times 1.01.

One chip holds each cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

FAULTS = ("unchanged", "half_batch", "step_scaled", "answer_altered")


def _half(fn):
    def wrapped(x, obs, tau2, *a, **kw):
        from bundleadjustment_benchmarks_tpu_torch.models import problem as pm

        k = obs.cam_idx.shape[0] // 2
        half = pm.BAObservations(
            cam_idx=obs.cam_idx[:k], pt_idx=obs.pt_idx[:k],
            measurements=obs.measurements[:k], weights=obs.weights[:k],
            measurements_pl=None if obs.measurements_pl is None
            else obs.measurements_pl[:, :k].contiguous())
        return 2.0 * fn(x, half, tau2, *a, **kw)
    return wrapped


def plant(fault: str):
    """Plant ``fault``; returns a function that undoes it."""
    from bundleadjustment_benchmarks_tpu_torch.models import problem as pm
    from bundleadjustment_benchmarks_tpu_torch.ops import cuda_chain, projection
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm, schur

    saved = []

    def put(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    if fault == "unchanged":
        put(pm, "apply_step", lambda s, dxp, dxc: s)
        put(pm, "apply_step_fast", lambda s, dxp, dxc: s)
    elif fault == "half_batch":
        put(cuda_chain, "fused_energy", _half(cuda_chain.fused_energy))
        put(cuda_chain, "fused_energy_plain", _half(cuda_chain.fused_energy_plain))
        put(projection, "energy", _half(projection.energy))
    elif fault == "step_scaled":
        real = schur.solve_damped

        def scaled(*a, **kw):
            dxp, dxc = real(*a, **kw)
            return 1.3 * dxp, 1.3 * dxc
        put(schur, "solve_damped", scaled)
    elif fault == "answer_altered":
        run = lm.DeviceLoop.run

        def altered(self, *a, **kw):
            x, status, it, fun_evals, energy, lam = run(self, *a, **kw)
            return x, status, it, fun_evals, energy * 1.01, lam
        put(lm.DeviceLoop, "run", altered)
    else:
        raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")

    def undo():
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
    return undo
