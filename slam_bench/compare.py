"""How `correct` is decided: the sampled answers of the window against the
plain references in `slam_bench/reference/`.

A cell's limits file names its checks: each `<name>_checked` key names
`checks/<name>.py`, found by `manifest.check_module`. A check module has

* `NUMBERS`: the numbers it reports, each of which the limits file bounds;
* `wrappers(op)`: `{"package.module:function": make}`, installed by
  `port.Hooks` for the run (`make(real) -> wrapped`); on an operation the
  harness samples (`op.sampled`, and `op.heavy` on every
  `b1_sample_every`-th of those) the wrappers append to `op.kept` copies of
  what the program's function took and gave, on the device and without a
  synchronization;
* `judge(records, config, control) -> (numbers, control_numbers)`: after
  the window, with the program's state freed, the sampled operations'
  records against the check's reference. Each record holds `op` (the
  operation's index), `frames` (each stream's (stream, state before, state
  after, reported pose) after it), `images` (stream 0's image of the
  operation and of the one before it, as fed) and `kept` (what this check's
  wrappers kept on it). `config` is the cell's merged configuration: a
  check's reference takes its weights or sizes from it, never from the
  program. With `control`, the check also reads each number with its
  reference one precision lower put in the program's place.

The `*_checked` numbers count what was compared and must reach their
floor. Beside the checks: no frame left lost after initialization
(`frames_lost`, set by the harness; exact). `judge_ate` reads the window's
trajectory against the poses its frames were rendered from; the harness
reports it beside the result and does not compare it: the System with TF32
switched on reads it 1.1-1.3x the program's, so no limit separates the two.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import ate as ref_ate

TRACKED_FROM = ("OK", "LOST")  # states before a frame whose pose is a tracking answer


def clone(x):
    """A device copy of a tensor the program produced (None stays None)."""
    return None if x is None else x.detach().clone()


def _pin_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def judge_ate(track) -> dict:
    """The window's tracked frames against the poses they were rendered
    from: `ate`, the RMS distance in world units between the tracked camera
    centres and the true ones after a similarity alignment (one per map:
    per stream and reset), the widest over maps."""
    maps: dict = {}
    for s, resets, pose, truth in track:
        maps.setdefault((s, resets), []).append((pose, truth))
    nums = {"ate_checked": 0, "ate": 0.0}
    for pairs in maps.values():
        if len(pairs) < 3:
            continue
        est, gt = (np.stack(c) for c in zip(*pairs))
        nums["ate_checked"] += len(pairs)
        nums["ate"] = max(nums["ate"], ref_ate.ate_rmse(est, gt))
    return nums


def judge(records, checks: dict, config: dict, control: bool = False) -> tuple[dict, dict]:
    """(numbers, control numbers) of the checks a cell's limits name
    (`checks`: name -> check module), each judging the records with its
    own captures as `kept`."""
    _pin_f32()
    nums, ctrl = {}, {}
    with torch.no_grad():
        for name, check in checks.items():
            own = [dict(rec, kept=rec["kept"][name]) for rec in records]
            n, c = check.judge(own, config, control)
            nums.update(n)
            ctrl.update(c)
    return nums, ctrl


def within(value: float, limit: dict) -> bool:
    if "max" in limit:
        return value <= limit["max"]
    return value >= limit["min"]


def limit_text(limit: dict) -> str:
    return f"<= {limit['max']}" if "max" in limit else f">= {limit['min']}"
