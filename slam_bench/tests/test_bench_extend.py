"""A cell, a traffic mix, a driver and a per-layer metric are added with new
files and manifest entries alone: a throwaway mix, driver and metric in a
copy of the benchmark's data folders, run by the unchanged harness."""

from __future__ import annotations

import json
import shutil

import torch

from slam_bench import harness, manifest

from .conftest import small


def test_throwaway_mix_and_metric(tmp_path, monkeypatch):
    for sub in ("configs", "traffic", "metrics", "limits", "drivers"):
        shutil.copytree(manifest.HERE / sub, tmp_path / sub)
    mix = json.loads((manifest.HERE / "traffic" / "sweep.json").read_text())
    mix.update(path={"kind": "line", "start": 0.0, "step": 0.02, "jitter": 0.0}, frames=80,
               on_path_end="wrap", why="a throwaway straight mix", driver="throwaway")
    (tmp_path / "drivers" / "throwaway.py").write_text(
        (manifest.HERE / "drivers" / "system.py").read_text()
        + "\n\nclass Counting(Driver):\n    calls = 0\n\n"
        "    def op(self, i):\n        Counting.calls += 1\n        return super().op(i)\n\n\n"
        "Driver = Counting\n")
    (tmp_path / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    shutil.copy(tmp_path / "limits" / "orb.sweep.json", tmp_path / "limits" / "orb.throwaway.json")
    (tmp_path / "metrics" / "throwaway_ops.py").write_text(
        '"""Operations in the window."""\n\n\ndef read(run):\n    return float(run.ops)\n')
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    bench = manifest.load_manifest()
    cell = {"name": "orb.throwaway", "config": "orb_tum640", "traffic": "throwaway", "chips": 1,
            "why": "throwaway"}
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "throwaway_ops", "unit": "ops", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "frames_per_s",
                               "workloads": ["orb.throwaway"]})
    out = harness.run_cell(cell, 5, 1.0, True, torch.device("cpu"), bench,
                           overrides=small(cell, setup_frames=12))
    assert out.result["metrics"]["throwaway_ops"]["value"] == out.info["ops"]
    assert manifest.driver_class("throwaway").calls == 0  # each load is a module of its own
    assert out.info["first_op"] == 12
    assert out.info["ops"] >= 1
