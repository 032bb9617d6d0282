"""Serve renders from a trained run over HTTP (the twin of
``tools/serve.py``):

    python -m codenerf_tpu_torch.serve --saved_dir <run> \\
        --jsonfile srncar.json --port 8000 [--device cuda]

Then:
  curl localhost:8000/healthz
  curl -X POST localhost:8000/render \\
      -d '{"obj": 0, "azimuth": 1.0, "elevation": 0.3, "radius": 1.3}' \\
      -o frame.png
  curl localhost:8000/stats

``--warmup`` renders each listed size once before serving (on the card
that builds the CUDA context and the allocator's pools, so the first
request does not pay for them).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serve renders (PyTorch)")
    ap.add_argument("--saved_dir", type=str, required=True)
    ap.add_argument("--jsonfile", type=str, default="srncar.json")
    ap.add_argument("--exps_root", type=str, default="exps")
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--warmup", type=str, default="128x128",
                    help="comma-separated HxW sizes to render once at boot "
                         "('' to skip)")
    ap.add_argument("--occupancy", action="store_true",
                    help="serve with per-object occupancy-grid empty-space "
                         "skipping (needs bound_sphere_radius in the config "
                         "or --occ_radius)")
    ap.add_argument("--occ_radius", type=float, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; cuda without a card raises")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from codenerf_tpu_torch.config import load_hparams
    from codenerf_tpu_torch.serving import RenderServer

    hp = load_hparams(args.jsonfile)
    server = RenderServer.from_checkpoint(
        os.path.join(args.exps_root, args.saved_dir), hp,
        device=args.device, host=args.host, port=args.port,
        use_occupancy=args.occupancy, occ_radius=args.occ_radius)
    for size in filter(None, args.warmup.split(",")):
        h, w = (int(x) for x in size.lower().split("x"))
        print(f"warmup: rendering {h}x{w} once ...", flush=True)
        server.render({"obj": 0, "H": h, "W": w})
    print(f"serving {server.n_objects} objects on "
          f"http://{server.host}:{server.port}  (POST /render, GET /healthz)",
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main(sys.argv[1:])
