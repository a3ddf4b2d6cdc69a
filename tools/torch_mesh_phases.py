#!/usr/bin/env python3
"""chip_smoke.py's multi-device phases alone, on the visible cards.

    python3 tools/torch_mesh_phases.py [phase ...]

Builds the kernels, renders chip_smoke's FULL and SYSTEM_FULL drives, seeds
multistream_setup's 8 streams on cuda:0, then runs the named phases (all of
chip_smoke.MESH_PHASES by default, in that order) over
chip_smoke.smoke_mesh(): every visible card up to 4, or 4 shards on cuda:0
when there is one card. Each phase prints its JSON line (mesh_size,
distinct_cards and the card's name and power limit among its keys) and
raises if it fails; the last line gives the sharded launches and each
phase's seconds.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    names = list(argv if argv is not None else sys.argv[1:]) or list(cs.MESH_PHASES)
    unknown = sorted(set(names) - set(cs.MESH_PHASES))
    if unknown:
        print(f"unknown phases {unknown}; choose from {cs.MESH_PHASES}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cs._kernels.load()
    _, _, images = cs.render(cs.FULL)
    world_s, poses_s, images_s = cs.render_system(cs.SYSTEM_FULL)
    ms = cs.multistream_setup(dev)
    out = cs.multi_device_phases(cs.smoke_mesh(), ms, images, world_s, poses_s, images_s, names)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
