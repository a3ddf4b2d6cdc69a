"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

from __future__ import annotations

import json
import re

import pytest

from slam_bench import manifest

BENCH = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head")


def test_top_level_keys():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_the_contract_keys(kind):
    for entry in BENCH[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(entry) <= KEYS[kind] | extra, entry


def test_names_and_units():
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((kind, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            texts = [entry[k] for k in ("why", "layer") if k in entry]
            texts += [entry["source"]] if kind == "configs" else []
            for text in texts:
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_command_and_paths():
    assert 1 <= len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", path) and ".." not in path
        assert (manifest.ROOT / path).is_dir()
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert {"frames_per_s", "frame_ms_p50", "frame_ms_p95", "setup_s"} <= names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_an_end_to_end_metric_their_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert manifest.metrics_for(BENCH, cell, "per_layer")
        assert len(manifest.metrics_for(BENCH, cell, "end_to_end")) >= 2


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    w = manifest.workload(BENCH, cell)
    assert w["chips"] in (1, 4)
    config = manifest.load_json(manifest.config_file(w["config"]))
    traffic = manifest.load_json(manifest.traffic_file(w["traffic"]))
    assert config["name"] == w["config"]
    assert callable(manifest.driver_class(traffic["driver"]))
    limits = manifest.load_json(manifest.limits_file(cell))
    numbers = {"pose": ("pose_checked", "pose_unmatched", "pose_px"),
               "b1": ("b1_checked", "b1_gap", "b1_flips"), "ham": ("ham_checked", "ham_wrong"),
               "conf": ("conf_checked", "conf_gap")}
    checks = [c for c in numbers if f"{c}_checked" in limits]
    assert "pose" in checks
    assert set(limits) == {n for c in checks for n in numbers[c]} | {"frames_lost"}
    assert limits["frames_lost"] == {"max": 0}
    for m in manifest.metrics_for(BENCH, cell, "per_layer"):
        assert callable(manifest.metric_reader(m["name"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    path = manifest.ROOT / entry["file"]
    assert path == manifest.config_file(entry["name"])
    config = json.loads(path.read_text())
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and not WIDTHS.search(key.lower())
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


def test_four_chip_cells_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
