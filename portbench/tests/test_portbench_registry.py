"""BENCHMARK.json resolves, by name, to the benchmark's files, and a cell
or metric dropped into a copy is picked up with no file edited."""

import json
import os
import re
import shutil

import pytest

from portbench.core import registry

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = registry.cell(BENCH, w["name"])
        assert cell.traffic["geometry"] in ("df32", "f64")
        assert cell.chips == w["chips"] == 1
        assert set(cell.spec["limits"]) >= {"window_captures"}
        assert cell.config["name"] == w["config"]


def test_every_config_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert set(c["reduced"]) <= set(conf)
        assert "start_perturbation" in conf["assumed"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_its_reader(kind):
    for entry in BENCH[kind]:
        mod = registry.reader(entry["name"])
        assert mod.UNIT == entry["unit"]
        assert mod.BETTER == entry["better"]
        assert mod.SOURCE == entry["source"]
        assert not hasattr(mod, "WORKLOADS")
        if kind == "per_layer":
            assert mod.LAYER == entry["layer"]
            assert mod.MOVES == entry["moves"]
        else:
            assert mod.LAYER is None and mod.MOVES is None


def test_names_and_units_use_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    metrics = [m for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    names += [m["name"] for m in metrics]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {e["name"] for e, _ in registry.metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = registry.metrics(BENCH, w["name"], True)
        assert layers
        for entry, _ in layers:
            assert entry["moves"] in e2e


def test_new_cell_and_metric_are_picked_up(tmp_path):
    """A copy of the benchmark with one more cell, traffic and metric, added
    as files and entries only: the new cell also reports the existing
    per-layer metrics, the roofline shares among them, once its name joins
    their entries' ``workloads`` in BENCHMARK.json."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(registry.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    new = "trafalgar257-df32-moreqr"
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": new, "config": "trafalgar-257-standin",
                               "traffic": "df32-moreqr", "chips": 1, "why": "a test"})
    for entry in bench["per_layer"]:
        if "workloads" in entry:
            entry["workloads"].append(new)
    bench["per_layer"].append({"name": "solves_traced", "unit": "solves",
                               "better": "higher", "source": "program_counter",
                               "layer": "LM driver (solvers/lm.py, DeviceLoop)",
                               "moves": "lm_iters_per_s", "workloads": [new]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/df32-cholesky.json").read_text())
    traffic["mode"] = "moreqr"
    (root / "portbench/traffic/df32-moreqr.json").write_text(json.dumps(traffic))
    shutil.copy(root / "portbench/workloads/trafalgar257-df32-cholesky.json",
                root / f"portbench/workloads/{new}.json")
    (root / "portbench/metrics/solves_traced.py").write_text(
        "UNIT = 'solves'\nBETTER = 'higher'\nSOURCE = 'program_counter'\n"
        "LAYER = 'LM driver (solvers/lm.py, DeviceLoop)'\nMOVES = 'lm_iters_per_s'\n"
        "\n\ndef read(run):\n    return len(run.traced) or None\n")
    assert all(p.read_bytes() == b for p, b in before.items())
    loaded = registry.load_benchmark(str(root))
    cell = registry.cell(loaded, new, str(root))
    assert cell.traffic["mode"] == "moreqr"
    assert cell.config["name"] == "trafalgar-257-standin"
    found = dict((e["name"], m) for e, m in registry.metrics(loaded, new, True, str(root)))
    assert set(found) == {m["name"] for m in bench["per_layer"]}
    assert {"camera_solve_roofline_pct", "chain_roofline_pct"} <= set(found)

    class Run:
        traced = [{}, {}]

    assert found["solves_traced"].read(Run()) == 2
    assert "solves_traced" not in [
        e["name"] for e, _ in registry.metrics(
            loaded, "trafalgar257-df32-cholesky", True, str(root))]


def test_a_roofline_reader_returns_none_where_its_kernels_did_not_run():
    """The chain's share in the float64 cell, whose drive runs no chain
    kernel: nothing to read, so no number (never 0)."""
    from portbench.core.trace import Trace

    mod = registry.reader("chain_roofline_pct")

    class Run:
        card = "NVIDIA H100 80GB HBM3"
        sizes = (257, 65132, 238476)
        trace_complete = True
        traced = [{"slots": 3, "prepares": 2}]
        trace = Trace(ops=[("gemm", 0, 1_000_000)], spans=[],
                      window=(0, 2_000_000))

    assert mod.read(Run()) is None
