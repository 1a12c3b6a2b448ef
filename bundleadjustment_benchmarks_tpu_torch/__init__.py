"""PyTorch/CUDA port of the bundle-adjustment benchmark framework.

The JAX package ``bundleadjustment_benchmarks_tpu`` is the reference; this
package mirrors its module layout (``io/bal.py``, ``models/problem.py``,
``ops/...``, ``solvers/...``) in PyTorch's idiom: dataclasses of tensors,
plain functions on tensors, an explicit ``device`` and explicit dtypes (LM
scalars and the reduced solve in float64, no global x64 switch).

The two Pallas kernels of the per-observation chain are hand-written CUDA
kernels for Hopper (``ops/csrc``), built on first use by ``ops/cuda_chain``.

Entry point::

    from bundleadjustment_benchmarks_tpu_torch.models.problem import load_bal_problem
    from bundleadjustment_benchmarks_tpu_torch.solvers import lm

    prob = load_bal_problem("data/problem-16-22106-pre.txt.gz")
    res = lm.minimize(prob, mode="cholesky",
                      config=lm.LMConfig(matmul_dtype="float32", geometry="df32"))

``minimize`` runs on the CUDA device unless ``device="cpu"`` is passed,
on the device-resident LM drive (``LMConfig.drive="jit"``, the JAX
package's default: one captured CUDA graph per problem, replayed) unless
the config names ``drive="host"``. The command line (``cli.py``) runs the
same, on the host drive unless ``--drive jit`` is given, as the JAX
command line does: ``python -m bundleadjustment_benchmarks_tpu_torch.cli
<BAL file> [--device cpu]``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Never falls back to the CPU on its own: with no CUDA device and no
    explicit ``device``, it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for device={device!r}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
