"""BENCHMARK.json and the files it names: every configuration, cell,
traffic mix, check and per-layer metric loads by name, and the file keeps
to the benchmark's contract."""
import importlib
import json
import re

import pytest

from bench_port_tiny import ROOT, harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / SPEC["command"][1]).is_file()


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    cell = harness.load_cell(w["name"], SPEC)
    assert cell.chips == w["chips"] in (1, 4)
    four = sum(x["chips"] == 4 for x in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
    assert set(cell.checks["numbers"])


def test_every_config_and_metric_has_its_files():
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for m in SPEC["per_layer"]:
        spec = json.loads((ROOT / "benchmark" / "metrics"
                           / f"{m['name']}.json").read_text())
        reader = importlib.import_module(f"benchmark.readers.{spec['reader']}")
        assert callable(reader.read)


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in SPEC[group]:
            assert set(e) <= keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                    m["workloads"]))
    assert len(json.dumps(SPEC)) < 64 * 1024
