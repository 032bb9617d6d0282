"""The readings a cell's limits are set from, one JSON line a seed.

    python3 portbench/tools/control.py --workload car_fused.train \
        --seeds 11,12,13 [--variants program,fp8,half,shifted]

For each seed the cell's kind module sets up as a run does (no window) and
reads each variant against the float32 reference: ``program`` (the
port, sound), ``fp8`` (the control: the reference one precision below
the configuration's bfloat16) and the faults it can plant in the
reference put in the program's place. ``PERF.md`` keeps the readings and
the limits set from them.
"""

import argparse
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="program,fp8,half,shifted")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import manifest
    from portbench.harness.cell import Context

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    _, config, traffic = manifest.cell_files(manifest.load(), args.workload)
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as work:
            ctx = Context(cell=args.workload, config=config, traffic=traffic,
                          seed=seed, seconds=0.0, trace=False,
                          device=torch.device("cuda", 0),
                          t_start=time.perf_counter(), workdir=work)
            out = kind.control(ctx, args.variants.split(","))
        print(json.dumps({"seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
