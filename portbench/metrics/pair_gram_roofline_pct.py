"""The pair gram's share of its roofline, timed by the port's ``pair_gram``
spans (``pair_gram_ms``): the least time of one pair gram at the card's
published rates (``core/roofline.card_rates``), times the spans, over
their summed time. The least time is the larger of two figures:

* bytes, in the pair stacks' dtype (float32 on the df32 drive, float64 on
  the f64 drive): read once, each observation pair's two 27-value stacks,
  each observation's 27-value stack of its camera's diagonal block, and
  the weights and the weighted right-hand side, 3 values a point each;
  written once, the dense (9N)^2 sum and the (N, 9) right-hand sum;
* operations: 486 a pair (the pair's 9 x 9 block, each entry 3 products
  of a weighted stack value and a stack value, a multiply and an add
  each) at the float32 peak.

The pairs P = sum d (d - 1) / 2 over the points of the configuration's
arrays (d: a point's observations), counted once per configuration in a
process. None wherever ``pair_gram_ms`` reads nothing."""

import numpy as np

from portbench.core import registry, roofline, session

UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
LAYER = "pair gram (solvers/schur.py _pair_gram_tables: the weighted observation-pair gram of each trial)"
MOVES = "lm_iters_per_s"

#: Operations of one observation pair's 9 x 9 block.
FLOPS_PER_PAIR = 81 * 3 * 2
#: Bytes of a pair-stack value by the traffic's geometry drive.
ELEMENT_BYTES = {"df32": 4, "f64": 8}
#: (cameras, points, observations, pairs) by configuration name.
_SIZES: dict = {}


def pair_count(pt_idx) -> int:
    """Observation pairs of one point, summed over the points."""
    d = np.bincount(np.asarray(pt_idx, dtype=np.int64))
    return int((d * (d - 1) // 2).sum())


def sizes(config: dict) -> tuple:
    """(N, M, K, P) of the configuration's arrays."""
    if config["name"] not in _SIZES:
        raw = session.raw_arrays(config)
        _SIZES[config["name"]] = (len(raw["focal"]), len(raw["points"]),
                                  len(raw["pt_idx"]), pair_count(raw["pt_idx"]))
    return _SIZES[config["name"]]


def least_bytes(n: int, m: int, k: int, p: int, element: int) -> int:
    return element * (2 * 27 * p + 27 * k + 2 * 3 * m + 81 * n * n + 9 * n)


def least_s(card: str, config: dict, geometry: str) -> float:
    """The least time of one pair gram on ``card``."""
    n, m, k, p = sizes(config)
    bw, fp32 = roofline.card_rates(card)
    return max(least_bytes(n, m, k, p, ELEMENT_BYTES[geometry]) / bw,
               FLOPS_PER_PAIR * p / fp32)


def read(run):
    got = registry.reader("pair_gram_ms").spans(run)
    if got is None:
        return None
    spent = sum(b - a for a, b in got) / 1e9
    least = least_s(run.card, run.cell.config, run.cell.traffic["geometry"])
    return 100.0 * least * len(got) / spent
