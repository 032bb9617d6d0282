"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json``, sets up and warms up (timed
as ``setup_s``), measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
end-to-end metrics, or with ``--trace 1`` the per-layer ones), ``device``
(and ``breakdown`` when traced) and, last, ``checks``: each number
compared beside its limit, which also close standard error.

It runs on the machine it is started on and needs as many CUDA devices as
the cell asks for; without them, or when JAX or the JAX package has been
loaded by the end, it prints no result and exits non-zero. Kernel builds
stay in the checkout (``build/``), so only a checkout's first run
compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import manifest, runner

    man = manifest.load()
    manifest.validate(man)
    cell, _, _ = manifest.cell_files(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    res, out = runner.run_cell(man, args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0),
                               T_START)
    found = runner.forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    for line in out.notes:
        print(line, file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
