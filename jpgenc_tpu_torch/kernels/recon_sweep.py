"""Hold the reconstruction kernels against another revision's and time them
by tile.

    python3 -m jpgenc_tpu_torch.kernels.recon_sweep [--other PATH]

The inputs, 16 x 1080p at Q75: the K1 coefficients of
`fixtures.synth_batch` in 4:2:0, 4:2:2, 4:4:4 and gray (the inputs of
chip_smoke.py's phase 10), and `fixtures.dense_coefficients`, every
coefficient nonzero, in 4:2:0 and gray.

  * `--other PATH`: builds that recon.cu alone (nvcc, sm_90a; the same two C
    entry points) into a temporary directory, counts the bytes on which its
    pixels and this package's differ on every input, and times both by CUDA
    events in turns (other, this, this, other).
  * The tiles (`csrc/recon.cu`: kTile MCUs, kGrayTile blocks a thread
    block): rebuilds the package's kernels with `-DJPGENC_RECON_TILE=n
    -DJPGENC_RECON_GRAY_TILE=m` for each candidate, prints what ptxas
    reports for the two kernels (registers, spills), checks that the pixels
    do not depend on the tile, and times every candidate in turn, twice.

Needs one NVIDIA GPU and nvcc; prints one JSON object per line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

CANDIDATES = {"8 / 32": (8, 32), "16 / 48": (16, 48), "16 / 64": (16, 64),
              "16 / 128": (16, 128), "32 / 64": (32, 64)}
KERNELS = ("recon_kernel", "recon_gray_kernel")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another revision's csrc/recon.cu")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("recon_sweep: needs an NVIDIA GPU")
    from jpgenc_tpu_torch import decoder, engine
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.kernels.tile_sweep import ptxas_report
    from jpgenc_tpu_torch.ops.cuda import k1_dct, recon
    from jpgenc_tpu_torch.utils import fixtures

    def ms(fn, iters=20):
        fn()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        return round(t0.elapsed_time(t1) / iters, 4)

    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}), flush=True)

    n, h, w = 16, 1080, 1920
    imgs = fixtures.synth_batch(h, w, n)
    y = imgs.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    src = {"rgb": torch.from_numpy(imgs).cuda(),
           "gray": torch.from_numpy(
               np.clip(np.round(y), 0, 255).astype(np.uint8)).cuda()}
    qt = engine.qtables_for_quality(75)
    inputs = {}
    for mode in ("420", "422", "444", "gray", "420 all-nonzero",
                 "gray all-nonzero"):
        sub = mode.split()[0]
        lay = engine.get_plan(h, w, sub, 75, "cuda").layout
        if mode.endswith("all-nonzero"):
            dx, dqt = fixtures.dense_coefficients(
                n, lay.mcus_y, lay.mcus_x, lay.blocks_per_mcu * 64, 6)
            x4 = torch.from_numpy(dx).cuda()
            qs = [dqt[0]] if lay.is_gray else [dqt[0], dqt[1], dqt[1]]
        else:
            plan = engine.get_plan(h, w, sub, 75, "cuda")
            zz = k1_dct.fused_pixels_to_scan(
                src["gray" if lay.is_gray else "rgb"], lay, plan.kdct, plan.q)
            x4 = zz.reshape(n, lay.mcus_y, lay.mcus_x, -1)
            qs = [qt[0]] if lay.is_gray else [qt[0], qt[1], qt[1]]
        q_rows = torch.from_numpy(
            np.repeat(decoder._q_rows(lay, qs), n, axis=0)).cuda()
        inputs[mode] = (lay, x4, q_rows)

    def this(mode):
        lay, x4, q_rows = inputs[mode]
        return recon.fused_recon_rgb(x4, q_rows, lay)

    if args.other:
        with tempfile.TemporaryDirectory() as tmp:
            so = os.path.join(tmp, "libother.so")
            r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared",
                                "-o", so, args.other],
                               capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"recon_sweep: nvcc failed:\n{r.stderr}")
            other = ctypes.CDLL(so)
        for name in ("recon_launch", "recon_gray_launch"):
            getattr(other, name).argtypes = build.SIGNATURES[name]
            getattr(other, name).restype = ctypes.c_int

        def theirs(mode):
            lay, x4, q_rows = inputs[mode]
            shape = (n, h, w) if lay.is_gray else (n, h, w, 3)
            out = torch.empty(shape, dtype=torch.uint8, device="cuda")
            ptrs = (x4.data_ptr(), q_rows.data_ptr(),
                    recon._kidct(str(x4.device)).data_ptr(), out.data_ptr(),
                    n, lay.mcus_y, lay.mcus_x, h, w)
            stream = torch.cuda.current_stream().cuda_stream
            if lay.is_gray:
                rc = other.recon_gray_launch(*ptrs, stream)
            else:
                c0 = lay.comps[0]
                rc = other.recon_launch(*ptrs, c0.hs, c0.vs, stream)
            if rc != 0:
                sys.exit(f"recon_sweep: the other kernel's launch gave {rc}")
            return out

        for mode in inputs:
            a, b = theirs(mode), this(mode)
            torch.cuda.synchronize()
            times = [ms(lambda: theirs(mode)), ms(lambda: this(mode)),
                     ms(lambda: this(mode)), ms(lambda: theirs(mode))]
            print(json.dumps({
                "input": mode, "bytes": a.numel(),
                "bytes_differing": int((a != b).sum()),
                "other_ms": [times[0], times[3]],
                "this_ms": [times[1], times[2]]}), flush=True)

    for name, (tile, gray_tile) in CANDIDATES.items():
        build.select(f"-DJPGENC_RECON_TILE={tile}",
                     f"-DJPGENC_RECON_GRAY_TILE={gray_tile}")
        print(json.dumps({"tile": name,
                          "build_s": round(build.build_seconds, 1),
                          "ptxas": ptxas_report(build.build_log, KERNELS)}),
              flush=True)
    first = {}
    for turn in range(2):
        for name, (tile, gray_tile) in CANDIDATES.items():
            build.select(f"-DJPGENC_RECON_TILE={tile}",
                         f"-DJPGENC_RECON_GRAY_TILE={gray_tile}")
            row = {"turn": turn, "tile": name}
            for mode in inputs:
                got = this(mode)
                if not torch.equal(first.setdefault(mode, got), got):
                    sys.exit(f"recon_sweep: {mode} changes with tile {name}")
                row[mode] = ms(lambda: this(mode))
            print(json.dumps(row), flush=True)
    build.select()


if __name__ == "__main__":
    main()
