#!/usr/bin/env python3
"""Where the trunk kernels' time goes, on one NVIDIA GPU: each variant
removes one part of ``trunk_fwd_kernel`` or ``trunk_dx_kernel`` from a
copy of ``codenerf_tpu_torch/ops/csrc/train_fused.cu`` (its results are
then wrong: only its time counts), builds it beside the others (one
``nvcc`` each, started together) and times both kernels' device ms per
launch (``torch.profiler``) in the frozen mode at 4096 × 96 and the
weight-gradient mode at 16,384 × 96, W=256. The time a part removes is
an upper bound of its cost: removing work can also let the rest overlap
differently.

    python3 trunk_ablation.py        # needs one CUDA card

Prints the card line, one line per variant, and exits non-zero without a
card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "codenerf_tpu_torch", "ops", "csrc",
                      "train_fused.cu")
OUT = os.path.join(HERE, "build", "trunk_ablation")

# variant: [(text in the source, its replacement), ...]
VARIANTS = {
    "base": [],
    "no_pe (fwd: PE not built)": [
        ("      build_pe(a, A, rays, m0, t2);\n", "")],
    "no_epilogue (fwd: register epilogue)": [
        ("        fwd_epilogue(acc, L, biases + l * TW, A, nh, m0, a.P, a.S, "
         "wl, lane);\n", "")],
    "no_vector_pass (fwd: stores, injection)": [
        ("        fwd_vector_pass(L, A, rays, l + 1 < a.n_layers, m0, a.P, "
         "t2);\n", "")],
    "no_mask_bits (fwd)": [("  if (!mask_out) return;", "  return;")],
    "no_products (both: no wgmma)": [
        ("      if (N == 256) wgmma_n128(", "      if (false) wgmma_n128("),
        ("      else wgmma_n64(", "      else if (false) wgmma_n64(")],
    "no_dx_epilogue (dx)": [
        ("        dx_epilogue(acc, L, a, A, mk, to_smem || L.out, nh, m0, wl, "
         "lane);\n", "")],
    "no_gh_stores (dx)": [
        ("        if (L.out) {\n          pair_sync(rh);\n"
         "          store_tile(L.out, A, TW, m0, a.P, t2);",
         "        if (false) {\n          pair_sync(rh);\n"
         "          store_tile(L.out, A, TW, m0, a.P, t2);")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant edit does not match the source "
                               f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(src: str):
    from codenerf_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for k, (name, edits) in enumerate(VARIANTS.items()):
        cu = os.path.join(OUT, f"v{k}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        so = os.path.join(OUT, f"v{k}.so")
        jobs.append((name, so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n"
                               f"{log[-3000:]}")
        libs.append((name, so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trunk_ablation: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from codenerf_tpu_torch.ops import _build, fused_train

    print(f"card {chip_smoke.card_line()}", flush=True)
    with open(SOURCE) as f:
        libs = build(f.read())
    dev = torch.device("cuda:0")
    shapes = [("frozen 4096x96", chip_smoke.kernel_inputs(dev, 4096, 96)[1],
               dict(weight_grads=False)),
              ("training 16384x96",
               chip_smoke.kernel_inputs(dev, 16384, 96)[1],
               dict(weight_grads=True))]
    print("variant | " + " | ".join(f"{tag}: fwd ms, dx ms"
                                    for tag, _, _ in shapes), flush=True)
    for name, so in libs:
        lib = ctypes.CDLL(so)
        fused_train._bind(lib)
        lib._bound = True
        _build._LIBS[fused_train._KERNEL] = lib
        row = []
        for _, args, kw in shapes:
            def call():
                return fused_train.train_fused(*args, **kw)
            fwd = chip_smoke.device_ms(call, "trunk_fwd_kernel", 5)
            dx = chip_smoke.device_ms(call, "trunk_dx_kernel", 5)
            row.append(f"{fwd:.3f}, {dx:.3f}")
        print(f"{name} | " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
