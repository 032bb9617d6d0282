"""One traced run of a cell with the program's own spans and counters
read beside the benchmark's result.

    python3 portbench/tools/spans.py --workload car_fused.train \
        --seed 7 --seconds 51

The run is ``run.py --trace 1``'s (set-up, the untraced window, the
traced stretch, the comparison with the reference). Besides, it reads
the program's counters over the untraced window (the training loop's
wait on the prefetch queue and its host time inside the step; the
server's queue and handler p50s from ``timings()``), charges the traced
stretch's idle gaps to the program's spans (``harness/spans.py``) beside
the benchmark's ``pb.*`` charge, and reads the kernel build counters. It
prints the run's notes and one line a span on standard error, and one
JSON line last on standard output: ``result`` (the run's result line)
and ``program``. ``--events PATH`` also writes the traced stretch's
Chrome-trace events there, gzipped.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from unittest import mock  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Probe:
    """Hooks on the kinds' set-up and traced stretch: the counters when
    the untraced window starts and ends, and the stretch's events."""

    def __init__(self):
        self.trainer = self.server = self.events = None
        self.before = self.after = None
        self.serve = {}

    @contextlib.contextmanager
    def installed(self):
        from portbench.harness import spans, trace
        from portbench.kinds import serve, train

        start, server, traced, summarize = (
            train.checked_start, serve.start_server, trace.traced,
            trace.summarize)

        def checked_start(ctx):
            st = start(ctx)
            self.trainer = st["trainer"]
            self.before = spans.train_counters(self.trainer)
            return st

        def start_server(ctx, init):
            out = server(ctx, init)
            self.server = out[0]
            return out

        def traced_(run, device):
            if self.trainer is not None:
                self.after = spans.train_counters(self.trainer)
            if self.server is not None:
                self.serve = spans.serve_readings(self.server)
            self.trainer = self.server = None   # the kinds free them
            return traced(run, device)

        def summarize_(events):
            self.events = events
            return summarize(events)

        with contextlib.ExitStack() as stack:
            for obj, name, fn in ((train, "checked_start", checked_start),
                                  (serve, "start_server", start_server),
                                  (trace, "traced", traced_),
                                  (trace, "summarize", summarize_)):
                stack.enter_context(mock.patch.object(obj, name, fn))
            yield self


def measure(man, cell, seed, seconds, device, t_start, config=None,
            traffic=None, events_path=None):
    """``(result, program, notes)`` of one traced run of ``cell``; the
    stretch's events written to ``events_path`` (gzipped) when given."""
    from codenerf_tpu_torch.ops import _build
    from portbench.harness import runner, spans

    with Probe().installed() as probe:
        res, out = runner.run_cell(man, cell, seed, seconds, True, device,
                                   t_start, config, traffic)
    if events_path is not None:
        with gzip.open(events_path, "wt") as f:
            json.dump(probe.events or [], f)
    r = dict(out.readings, **spans.train_readings(probe.before, probe.after),
             **probe.serve)
    readings = {k: v for k, v in ((k, f(r)) for k, f in
                                  spans.READINGS.items()) if v is not None}
    summary = r.get("trace") or {}
    gaps = spans.program_gaps(probe.events or [])
    items = r.get("steps_traced") or r.get("renders_traced") or 0
    window_s = summary.get("window_s", 0.0)
    build = getattr(_build, "counters", None)
    program = {
        "readings": readings,
        "program_gaps": [[k, v] for k, v in gaps.items()],
        "breakdown_gaps": summary.get("idle_gaps", []),
        "window_s": window_s,
        "traced_items": items,
        "window_ms_per_item": 1e3 * window_s / items if items else None,
        "build": dict(build) if build is not None else None,
    }
    notes = list(out.notes) + (spans.gap_notes(gaps, window_s)
                               if window_s > 0 else [])
    notes.append(f"kernel builds: {program['build']}")
    return res, program, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--events", default=None)
    args = ap.parse_args(argv)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    res, program, notes = measure(manifest.load(), args.workload, args.seed,
                                  args.seconds, torch.device("cuda", 0),
                                  T_START, events_path=args.events)
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "result": res, "program": program}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
