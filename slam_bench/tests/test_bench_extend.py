"""A cell, a traffic mix, a driver, a per-layer metric and a model are added
with new files and manifest entries alone: a throwaway mix, driver and
metric, and a throwaway model (its configuration, work file, check and
limits), in a copy of the benchmark's data folders, run by the unchanged
harness."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from slam_bench import bounds, harness, manifest

from .conftest import small

DATA = ("configs", "traffic", "metrics", "limits", "drivers", "checks", "work")
PRODUCTS_PER_PAIR = 2.5e12

# A check of its own: the first single-pair LoFTR confidence of each sampled
# operation, with the features it was computed from, against the reference's
# encoder layers and dual softmax run on those features. SHIFT moves the
# program's answer before it is judged (the variant whose gap passes its limit).
CHECK = '''"""Throwaway: the LoFTR confidence against the reference from its features."""

import torch

from slam_bench import compare, manifest
from slam_bench.reference import loftr as ref_loftr

NUMBERS = ("throwaway_checked", "throwaway_gap")
SHIFT = {shift}


def wrappers(op):
    def confidence(real):
        def wrapped(model, f0, f1):
            conf = real(model, f0, f1)
            if op.sampled and f0.shape[0] == 1 and not op.kept:
                op.kept.append((compare.clone(f0), compare.clone(f1), compare.clone(conf[0])))
            return conf
        return wrapped
    return {{"mono_slam_framework_torch.models.loftr_native:confidence_from_features": confidence}}


def reference(p, f0, f1):
    for i, name in enumerate(ref_loftr.LAYER_NAMES):
        if name == "self":
            f0, f1 = ref_loftr._layer(p, i, f0, f0, "f32"), ref_loftr._layer(p, i, f1, f1, "f32")
        else:
            f0 = ref_loftr._layer(p, i, f0, f1, "f32")
            f1 = ref_loftr._layer(p, i, f1, f0, "f32")
    sim = f0 @ f1.transpose(1, 2) / f0.shape[-1] / ref_loftr.TEMPERATURE
    return (torch.softmax(sim, dim=1) * torch.softmax(sim, dim=2))[0]


def judge(records, config, control):
    nums = {{"throwaway_checked": 0, "throwaway_gap": 0.0}}
    p = ref_loftr.load_weights(manifest.ROOT / config["weights"], torch.device("cpu"))
    for rec in records:
        for f0, f1, conf in rec["kept"]:
            nums["throwaway_checked"] += 1
            gap = float((conf + SHIFT - reference(p, f0, f1)).abs().max())
            nums["throwaway_gap"] = max(nums["throwaway_gap"], gap)
    return nums, {{}}
'''
WORK = f'''"""Throwaway: {PRODUCTS_PER_PAIR!r} products a LoFTR pair, none an encode."""


def flops(hooks):
    return sum(n * {PRODUCTS_PER_PAIR!r} for n, _ in hooks.loftr_confidences)
'''
# reads the configuration: the products it states a pair, times the pairs
METRIC = '''"""Throwaway: the products of the window's LoFTR pairs, as the configuration states them."""


def read(run):
    return run.config["products_per_pair"] * sum(n for n, _ in run.hooks.loftr_confidences)
'''


def test_throwaway_mix_and_metric(tmp_path, monkeypatch):
    for sub in DATA:
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


@pytest.mark.parametrize("shift,correct", [(0.0, True), (0.5, False)])
def test_throwaway_model(tmp_path, monkeypatch, shift, correct):
    for sub in DATA:
        shutil.copytree(manifest.HERE / sub, tmp_path / sub)
    config = json.loads((manifest.HERE / "configs" / "loftr_tum640.json").read_text())
    config.update(name="throwaway_model", model_work="throwaway_work", products_per_pair=PRODUCTS_PER_PAIR)
    (tmp_path / "configs" / "throwaway_model.json").write_text(json.dumps(config))
    (tmp_path / "work" / "throwaway_work.py").write_text(WORK)
    (tmp_path / "checks" / "throwaway.py").write_text(CHECK.format(shift=shift))
    (tmp_path / "metrics" / "throwaway_products.py").write_text(METRIC)
    limits = {"throwaway_checked": {"min": 1}, "throwaway_gap": {"max": 1e-3}, "frames_lost": {"max": 0}}
    (tmp_path / "limits" / "throwaway.sweep.json").write_text(json.dumps(limits))
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    bench = manifest.load_manifest()
    cell = {"name": "throwaway.sweep", "config": "throwaway_model", "traffic": "sweep", "chips": 1,
            "why": "throwaway"}
    bench["configs"].append({"name": "throwaway_model", "source": "throwaway",
                             "file": "slam_bench/configs/throwaway_model.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "throwaway_products", "unit": "products", "better": "higher",
                               "source": "program_counter", "layer": "LoFTR model",
                               "moves": "frames_per_s", "workloads": ["throwaway.sweep"]})
    out = harness.run_cell(cell, 11, 3.0, True, torch.device("cpu"), bench,
                           overrides=small(cell, setup_frames=40, sample_every=2))
    checks = out.result["checks"]
    assert set(checks) == {"throwaway_checked", "throwaway_gap", "frames_lost"}
    assert checks["throwaway_checked"]["value"] >= 1
    assert out.result["correct"] is correct
    assert (checks["throwaway_gap"]["value"] <= 1e-3) is correct
    assert checks["frames_lost"]["value"] == 0
    metrics = out.result["metrics"]
    products = metrics["throwaway_products"]["value"]
    assert products >= PRODUCTS_PER_PAIR
    # on the CPU no kernel launch is counted: the step's work is the model's alone
    want = 100.0 * products / bounds.PEAK_BF16_FLOPS / out.result["device"]["window_s"]
    assert metrics["step_mfu"]["value"] == pytest.approx(want, rel=1e-12)
