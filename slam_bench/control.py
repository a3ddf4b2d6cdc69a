"""Readings for the limits of `correct`: the program's numbers and the
control's, over several seeds of one cell, in one process.

    python3 -m slam_bench.control --workload <name> --seeds 1 2 3 --seconds 10 [--out FILE]

For each seed it runs the cell as `slam_bench.run` does (untraced) and
prints one JSON line: the numbers the comparison read from the program,
and the same comparisons with the reference computed one precision lower
put in the program's place (TF32 products for the f32 pose LM and
detection, fp8 operands for LoFTR's bf16 products). `--program-tf32` runs
the whole System with its matmuls and convolutions in TF32 (the program
states f32 and pins TF32 off) and reads what judges the whole System:
`frames_lost`, and the trajectory error reported beside the result
(`ate`, which this control does not separate from the program's). `--world-seed` renders the mix's
world from another seed, to read the numbers in other worlds than the one
the mix fixes. A limit lies above the program's largest reading and below
the control's smallest. The benchmark's own runs never run this. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--every", type=int, help="compare every N-th operation (1: all of them)")
    p.add_argument("--world-seed", type=int, help="render the mix's world from this seed")
    p.add_argument("--program-tf32", action="store_true",
                   help="run the program with TF32 matmuls and convolutions (the System's control)")
    p.add_argument("--out")
    args = p.parse_args(argv)

    import torch

    # the program pins TF32 off when it is imported: import it first
    from slam_bench import harness, manifest, port  # noqa: F401

    if not torch.cuda.is_available():
        print("slam_bench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = manifest.load_manifest()
    cell = manifest.workload(bench, args.workload)
    traffic = {}
    if args.every:
        traffic["sample_every"] = args.every
    if args.world_seed is not None:
        traffic["world"] = {"seed": args.world_seed}
    for seed in args.seeds:
        # the comparison pins f32 after each window; the program's own
        # setting is set again before each run
        torch.backends.cuda.matmul.allow_tf32 = args.program_tf32
        torch.backends.cudnn.allow_tf32 = args.program_tf32
        out = harness.run_cell(cell, seed, args.seconds, False, torch.device("cuda", 0), bench,
                               overrides={"traffic": traffic}, control=not args.program_tf32)
        line = json.dumps({"workload": args.workload, "seed": seed, "world_seed": args.world_seed,
                           "program_tf32": args.program_tf32, "numbers": out.numbers,
                           "control": out.control, "correct": out.result["correct"],
                           "failed": out.result["failed"], "attempted": out.result["attempted"],
                           "e2e": out.info["e2e"], "info": out.info})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
