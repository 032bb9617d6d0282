"""Closed-loop clients against the rate a serving cell's server sustains,
to choose the cell's number of clients.

    python3 portbench/tools/sweep.py --workload car_fused.serve \
        --clients 1,2,4,8,16 --seconds 10 --seed 7

One server; for each number of clients a closed-loop window of the
cell's requests, and one JSON line: the clients, the rate completed, p50
and p95 latency, and the server's lock-held render time from ``/stats``.
The rate stops rising where the server is the limit.
"""

import argparse
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
    ap.add_argument("--clients", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.kinds import serve
    from portbench.harness import manifest
    from portbench.harness.cell import Context
    from portbench.harness.weights import make_weights

    _, config, tf = manifest.cell_files(manifest.load(), args.workload)
    with tempfile.TemporaryDirectory() as work:
        ctx = Context(args.workload, config, tf, args.seed, args.seconds,
                      False, torch.device("cuda", 0), time.perf_counter(),
                      work)
        n_obj = config["scene"]["n_objects"]
        init = make_weights(config["hparams"]["net_hyperparams"], n_obj,
                            ctx.sub_seed(1), ctx.device, tf["weight_gain"],
                            tf["weight_colour"])
        server, _ = serve.start_server(ctx, init)
        try:
            reqs = serve.requests_of(tf, n_obj, ctx.sub_seed(2))
            for r in reqs[:tf["warmup_requests"]]:
                serve.post(server, r)
            for clients in (int(c) for c in args.clients.split(",")):
                gen = serve.LoadGen(server, reqs, clients, args.seconds)
                try:
                    res, wall = gen.run()
                    gen.bodies([])
                finally:
                    gen.close()
                lat = [r["done_s"] - r["sent_s"] for r in res
                       if r["status"] == 200]
                print(json.dumps({
                    "clients": clients, "completed_per_s": len(lat) / wall,
                    "failed": len(res) - len(lat),
                    "p50_ms": serve.quantile(lat, 0.5) * 1e3,
                    "p95_ms": serve.quantile(lat, 0.95) * 1e3,
                    "stats": serve.stats(server)["latency_ms"]}), flush=True)
        finally:
            server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
