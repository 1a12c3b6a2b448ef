"""The frozen roofline counts give the bounds the port's kernel table
holds (PERF.md): the chain kernels at p257 and at the Ladybug stand-in's
size on an H100 SXM."""

import pytest

from portbench.core import roofline


@pytest.mark.parametrize("sizes, blocks_ms, energy_ms", [
    ((257, 65132, 238476), 0.00902, 0.00168),
    ((1723, 156502, 670568), 0.02520, 0.00472),
])
def test_chain_bounds(sizes, blocks_ms, energy_ms):
    bw, fp32 = roofline.card_rates("NVIDIA H100 80GB HBM3")
    b = roofline.kernel_bounds(*sizes, bw, fp32 / 2)
    assert b["chain_blocks"][0] == pytest.approx(blocks_ms, abs=5e-6)
    assert b["chain_blocks"][1] == "bytes"
    assert b["chain_energy"][0] == pytest.approx(energy_ms, abs=5e-6)
    assert b["chain_energy"][1] == "operations"


def test_camera_solve_flops():
    n = 9 * 257
    assert roofline.camera_solve_flops(257) == pytest.approx(n ** 3 / 3 + 2 * n ** 2)
    assert roofline.camera_solve_flops(1723) / 67e12 * 1e3 == pytest.approx(18.6, abs=0.05)
    assert roofline.camera_solve_peak("NVIDIA H100 80GB HBM3") == 67e12


def test_unknown_card_raises():
    with pytest.raises(KeyError):
        roofline.card_rates("NVIDIA A100")
