"""BENCHMARK.json against its contract, and the harness's discovery of
configurations, traffic mixes, drivers, metric readers and limits by name."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(harness.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MAN = harness.manifest()


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(MAN["command"]) <= 32
    assert all(one_line(w) for w in MAN["command"])
    script = MAN["command"][1]
    assert any(script.startswith(p + "/") for p in MAN["paths"])


@pytest.mark.parametrize("kind,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_their_keys_and_names(kind, keys):
    rows = MAN[kind]
    assert rows
    names = [r["name"] for r in rows]
    assert len(set(names)) == len(names)
    for r in rows:
        extra = set(r) - keys
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                         else set()), (r["name"], extra)
        assert keys <= set(r)
        assert NAME.match(r["name"]), r["name"]
        if "unit" in r:
            assert UNIT.match(r["unit"]) and r["better"] in ("lower",
                                                             "higher")
        for key in ("why", "layer", "source"):
            if key in r and kind != "end_to_end" and kind != "per_layer":
                assert one_line(r[key])
        if kind == "per_layer":
            assert one_line(r["layer"])


def test_metric_names_are_unique_across_kinds():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in MAN["workloads"]}
    fours = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(cells) // 4)
    for w in MAN["workloads"]:
        assert w["chips"] in (1, 4) and one_line(w["why"])
        e2e = harness.metrics_for(MAN, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        layer = harness.metrics_for(MAN, w["name"], trace=True)
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in e2e}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_configuration_found_by_name(cfg):
    path = ROOT / cfg["file"]
    assert any(cfg["file"].startswith(p + "/") for p in MAN["paths"])
    assert path == harness.BENCH / "configs" / f"{cfg['name']}.json"
    body = json.loads(path.read_text())
    assert body["source"] == cfg["source"]
    assert body["reduced"] == cfg["reduced"]
    assert one_line(cfg["source"]) and len(cfg["reduced"]) <= 16
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_parts_found_by_name(cell):
    traffic = harness.traffic_of(cell["traffic"])
    driver = harness.driver_of(traffic)
    assert hasattr(driver.Driver, "check")
    assert (harness.BENCH / "limits" / f"{cell['name']}.json").exists()
    for m in harness.metrics_for(MAN, cell["name"], trace=True):
        assert callable(harness.layer_reader(m["name"]))


def test_files_under_paths_are_named_from_name_characters():
    for p in MAN["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
