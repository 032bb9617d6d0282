#!/usr/bin/env python3
"""Where the kernels' time goes, on one NVIDIA GPU: each variant removes
one part of a kernel from a copy of
``codenerf_tpu_torch/ops/csrc/train_fused.cu`` (its results are then
wrong: only its time counts), builds it beside the others (one ``nvcc``
each, started together) and times the kernels' device ms per launch
(``torch.profiler``). The time a part removes is an upper bound of its
cost: removing work can also let the rest overlap differently.

    python3 trunk_ablation.py            # the trunk kernels
    python3 trunk_ablation.py --dw-head  # the dW kernel and the head
    python3 trunk_ablation.py --small    # the sigma head, the last pass

The trunk: ``trunk_fwd_kernel`` and ``trunk_dx_kernel`` in the frozen
mode at 4096 × 96 and the weight-gradient mode at 16,384 × 96, W=256,
and ``trunk_fwd_kernel`` in the served forwards: ``sigma_fwd`` at 16,384
× 64 (NeRF's coarse pass of a 128² view) and ``planes_fwd`` at 16,384 ×
192 (its fine network). The forward's parts: the PE, the register
epilogue, the TMA stores of the planes from the tile, the staged
injection (the per-ray rows' fill and the latent adds), the mask bits
and the products.
``--dw-head``: ``wgrad_kernel`` alone (``fused_train.weight_grads``) on
seeded random planes of the training shape (16,384 × 96: the eight
trunk layers' inputs and gh planes), and ``head_kernel`` in the
weight-gradient mode at 16,384 × 96 and the frozen mode at 4096 × 96.
``--small``: not parts removed but the shapes of two small kernels,
each alone on seeded random inputs: ``sigma_head_kernel``
(``fused_mlp.sigma_head``) at 16,384 × 32 with 4, 8 or 16 points a
warp, 4 blocks an SM, or one or 16 waves, and ``ray_sum_fold_kernel``
(``fused_train.fold_ray_sums``) on a training call's spans (16,384 ×
96: the rays' and the slices' rows, 5 × 256 values a row) with one, two or
four waves of resident blocks; beside them, once, ``torch.matmul(t,
w_sig)`` and ``x.to(torch.bfloat16)`` of the rays' span. The trunk list
also times the dx kernel without its per-ray sums (``no_ray_sums``).

Prints the card line, one line per variant, and exits non-zero without a
card. Needs one CUDA card.
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
        ("      build_pe(a, A, m0, t2);\n", "")],
    "no_epilogue (fwd: the whole register epilogue)": [
        ("        fwd_epilogue(acc, L, biases + l * TW, A, st, a.rec, ray0, "
         "nh, m0,\n                     a.P, a.S, wl, lane);\n", "")],
    "no_tma_stores (fwd: the planes' stores from the tile)": [
        ("      if (elected && a.pe_out) {", "      if (false) {"),
        ("        if (elected && L.dst) {", "        if (false) {")],
    "no_staged_injection (fwd: the stage's fill, the latent adds)": [
        ("      if (a.rec) {\n        const int nrays",
         "      if (false) {\n        const int nrays"),
        ("        if (pj[h]) {", "        if (false) {")],
    "no_mask_bits (fwd)": [("  if (!mask_out) return;", "  return;")],
    "no_products (both: no wgmma)": [
        ("      if (N == 256) wgmma_n128(", "      if (false) wgmma_n128("),
        ("      else wgmma_n64(", "      else if (false) wgmma_n64(")],
    "no_dx_epilogue (dx)": [
        ("        dx_epilogue(acc, L, a, A, mk, to_smem || L.out, nh, m0, wl, "
         "lane);\n", "")],
    "no_ray_sums (dx: no per-ray code-cotangent sums)": [
        ("  if (L.rs_pre)\n    ray_sums(", "  if (false)\n    ray_sums("),
        ("  if (L.rs_post)\n    ray_sums(", "  if (false)\n    ray_sums(")],
    "no_gh_stores (dx)": [
        ("        if (L.out) {\n          pair_sync(rh);\n"
         "          store_tile(L.out, A, TW, m0, a.P, t2);",
         "        if (false) {\n          pair_sync(rh);\n"
         "          store_tile(L.out, A, TW, m0, a.P, t2);")],
}


# The dW kernel and the head.
DB_LOOP = "    for (int r = grp; r < 64; r += groups) {\n"
DW_VARIANTS = {
    "base": [],
    "no_db (wgrad: no column sums)": [
        (DB_LOOP, "    for (int r = grp; r < 0; r += groups) {\n")],
    "no_products (wgrad: no wgmma)": [
        ("      wgmma_tt_n256(acc, da + 128 * k, db + 128 * k, ks | k);",
         "      if (false) wgmma_tt_n256(acc, da + 128 * k, db + 128 * k, "
         "ks | k);")],
    "no_multicast (wgrad: each block loads all four B boxes)": [
        ("          for (int b = 2 * rank; b < 2 * rank + 2; ++b)\n"
         "            tma_box_multicast(st + (DW_B0 + b) * DW_BOX, bm, "
         "T.b0 + 64 * b,\n"
         "                              p, full + stage, 0x3);",
         "          for (int b = 0; b < 4; ++b)\n"
         "            tma_box(st + (DW_B0 + b) * DW_BOX, bm, T.b0 + 64 * b, "
         "p,\n"
         "                    full + stage);")],
    "splits_33 (wgrad: 33 point splits)": [
        ("constexpr int DW_SPLITS = 66;", "constexpr int DW_SPLITS = 33;")],
    "no_phase4 (head: no per-ray sums)": [
        ("this ray's sums over its samples.\n    if (h.part) {",
         "this ray's sums over its samples.\n    if (false) {")],
}


# The small kernels' shapes.
SH = "constexpr int SH_POINTS = 8;"
SH_BOUNDS = """\
__global__ void __launch_bounds__(PH_THREADS, PH_BLOCKS_PER_SM)
    sigma_head_kernel("""
PH = "cap = (size_t)sm_count() * PH_BLOCKS_PER_SM * 4;"
RS = "cap = (size_t)sm_count() * RS_BLOCKS_PER_SM * 4;"
SMALL_VARIANTS = {
    "base (8 points a warp; 4 waves)": [],
    "sigma head: 4 points a warp": [(SH, SH.replace("8", "4"))],
    "sigma head: 16 points a warp": [(SH, SH.replace("8", "16"))],
    "sigma head: 4 blocks an SM": [(SH_BOUNDS, SH_BOUNDS.replace(
        "PH_BLOCKS_PER_SM", "4"))],
    "sigma head: 1 wave": [(PH, PH.replace("* 4", "* 1"))],
    "sigma head: 16 waves": [(PH, PH.replace("* 4", "* 16"))],
    "last pass: 1 wave": [(RS, RS.replace("* 4", "* 1"))],
    "last pass: 2 waves": [(RS, RS.replace("* 4", "* 2"))],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant edit does not match the source "
                               f"once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(src: str, variants):
    from codenerf_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    jobs = []
    for k, (name, edits) in enumerate(variants.items()):
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


def use(lib_path: str) -> None:
    """Load a variant's library in the place of the kernels' own."""
    from codenerf_tpu_torch.ops import _build, fused_train

    lib = ctypes.CDLL(lib_path)
    fused_train._bind(lib)
    lib._bound = True
    _build._LIBS[fused_train._KERNEL] = lib


def dw_head(libs) -> None:
    """The --dw-head table: wgrad_kernel alone on seeded random planes,
    head_kernel in both modes."""
    import torch

    import chip_smoke
    from codenerf_tpu_torch.ops import fused_train

    dev = torch.device("cuda:0")
    P, W = 16384 * 96, 256
    gen = torch.Generator(device=dev).manual_seed(0)

    def plane(cols):
        return (torch.randn(P, cols, generator=gen, device=dev)
                .to(torch.bfloat16))

    shapes = [(W, W // 2)] + [(W, W)] * 6 + [(64, W)]
    pairs = [(plane(m), plane(n)) for m, n in shapes]
    modes = [("training 16384x96",
              chip_smoke.kernel_inputs(dev, 16384, 96)[1],
              dict(weight_grads=True)),
             ("frozen 4096x96", chip_smoke.kernel_inputs(dev, 4096, 96)[1],
              dict(weight_grads=False))]
    print("variant | wgrad_kernel ms (random planes) | head_kernel ms: "
          + ", ".join(tag for tag, _, _ in modes), flush=True)
    for name, so in libs:
        use(so)
        dw = chip_smoke.device_ms(lambda: fused_train.weight_grads(pairs),
                                  "wgrad_kernel", 5)
        heads = []
        for _, args, kw in modes:
            heads.append(chip_smoke.device_ms(
                lambda: fused_train.train_fused(*args, **kw), "head_kernel",
                5))
        print(f"{name} | {dw:.3f} | " + ", ".join(f"{h:.3f}" for h in heads),
              flush=True)


def small(libs) -> None:
    """The --small table: sigma_head_kernel and ray_sum_fold_kernel alone
    on seeded random inputs at the main paths' largest shapes."""
    import torch

    import chip_smoke
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    dev = torch.device("cuda:0")
    P, W, n = 16384 * 32, 256, 16384 * 5 * 256
    gen = torch.Generator(device=dev).manual_seed(0)
    t = torch.randn(P, W, generator=gen, device=dev).to(torch.bfloat16)
    w_sig = torch.randn(W, generator=gen, device=dev) * 0.1
    b_sig = torch.zeros(1, device=dev)
    span = torch.randn(n, generator=gen, device=dev)
    tiles = torch.randn(fused_train.slice_rows(16384, 96) * 5 * 256,
                        generator=gen, device=dev)
    w_bf16 = w_sig.to(torch.bfloat16)
    lib = (chip_smoke.device_ms(lambda: torch.matmul(t, w_bf16), ""),
           chip_smoke.device_ms(lambda: span.to(torch.bfloat16), ""))
    print("variant | sigma_head_kernel ms (16384x32) | ray_sum_fold_kernel "
          "ms (16384x96)", flush=True)
    print(f"torch.matmul(t, w_sig) | x.to(torch.bfloat16) | {lib[0]:.4f} | "
          f"{lib[1]:.4f}", flush=True)
    for name, so in libs:
        use(so)
        sig = chip_smoke.device_ms(
            lambda: fused_mlp.sigma_head(16384, 32, t, w_sig, b_sig),
            "sigma_head_kernel")
        conv = chip_smoke.device_ms(
            lambda: fused_train.fold_ray_sums(span, tiles, 16384, 96, 3, 1,
                                              W),
            "ray_sum_fold_kernel")
        print(f"{name} | {sig:.4f} | {conv:.4f}", flush=True)


def forward_args(args) -> tuple:
    """The served forwards' operands (``fused_mlp.sigma_fwd``,
    ``planes_fwd``) from a training call's (``chip_smoke.kernel_inputs``)."""
    cfg, S, R, _, _, ro8, vd8, z, sproj, tproj, vcontrib, _, trunk = args
    return cfg, S, R, ro8, vd8, z, sproj, tproj, vcontrib, trunk


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("trunk_ablation: torch.cuda.is_available() is False; this "
              "script needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from codenerf_tpu_torch.ops import fused_mlp, fused_train

    print(f"card {chip_smoke.card_line()}", flush=True)
    with open(SOURCE) as f:
        src = f.read()
    if "--dw-head" in sys.argv[1:]:
        dw_head(build(src, DW_VARIANTS))
        return 0
    if "--small" in sys.argv[1:]:
        small(build(src, SMALL_VARIANTS))
        return 0
    libs = build(src, VARIANTS)
    dev = torch.device("cuda:0")
    shapes = [("frozen 4096x96", chip_smoke.kernel_inputs(dev, 4096, 96)[1],
               dict(weight_grads=False)),
              ("training 16384x96",
               chip_smoke.kernel_inputs(dev, 16384, 96)[1],
               dict(weight_grads=True))]
    served = [("sigma_fwd 16384x64", fused_mlp.sigma_fwd,
               forward_args(chip_smoke.kernel_inputs(dev, 16384, 64)[1])),
              ("planes_fwd 16384x192", fused_mlp.planes_fwd,
               forward_args(chip_smoke.kernel_inputs(dev, 16384, 192)[1]))]
    print("variant | " + " | ".join(f"{tag}: fwd ms, dx ms"
                                    for tag, _, _ in shapes) + " | "
          + " | ".join(f"{tag}: fwd ms" for tag, _, _ in served), flush=True)
    for name, so in libs:
        use(so)
        row = []
        for _, args, kw in shapes:
            def call():
                return fused_train.train_fused(*args, **kw)
            fwd = chip_smoke.device_ms(call, "trunk_fwd_kernel", 5)
            dx = chip_smoke.device_ms(call, "trunk_dx_kernel", 5)
            row.append(f"{fwd:.3f}, {dx:.3f}")
        for _, fn, fargs in served:
            fwd = chip_smoke.device_ms(lambda: fn(*fargs),
                                       "trunk_fwd_kernel", 5)
            row.append(f"{fwd:.3f}")
        print(f"{name} | " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
