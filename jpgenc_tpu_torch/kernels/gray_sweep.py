"""Hold the gray encode kernels (gray K1A, gray K1) against another
revision's and time them by tile.

    python3 -m jpgenc_tpu_torch.kernels.gray_sweep [--other DIR]

The inputs, gray at Q75, w_blk 8: the luma of `fixtures.synth_batch` at
16 x 1080p (chip_smoke.py's gray frames) and at 2 x 2048 x 16384 (8 tiles of
2048 x 2048 side by side); for the counts also 2 frames of 1001 x 1337 (odd
sizes, a row pitch that is no multiple of 4) and the 16 x 1080p frames at
restart intervals 1, 7 and 240.

  * `--other DIR`: builds DIR's `k1a_gray.cu` and `k1_dct.cu` (with DIR's
    `common.cuh`; nvcc, sm_90a; the same two C entry points) into a
    temporary directory, counts the coefficients (gray K1A's and gray K1's),
    words and bits on which its outputs and this package's differ on every
    input, and times both revisions' kernels by CUDA events in turns (other,
    this, this, other). DIR is a directory the copy to the card holds, such
    as a git-ignored `.gray_old/` unpacked from another commit's `csrc/`.
  * The tiles (`csrc/common.cuh`: kGrayTile = 16 * JPGENC_GRAY_BPT blocks a
    thread block): rebuilds the package's kernels with `-DJPGENC_GRAY_BPT=n`
    for n in 4, 6, 8, 10, prints what ptxas reports for the two kernels
    (registers, spills), checks that the outputs do not depend on the tile,
    and times every candidate in turn, twice.

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

BPTS = (4, 6, 8, 10)
KERNELS = ("k1a_gray_kernel", "k1_gray_kernel")
W_BLK = 8


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another revision's csrc/ directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("gray_sweep: needs an NVIDIA GPU")
    from jpgenc_tpu_torch import engine
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.kernels.tile_sweep import ptxas_report
    from jpgenc_tpu_torch.ops.cuda import k1_dct
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

    def luma(rgb):
        y = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                              np.float32)
        return np.clip(np.round(y), 0, 255).astype(np.uint8)

    def gray_batch(h, w, n):
        return torch.from_numpy(luma(fixtures.synth_batch(h, w, n))).cuda()

    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}), flush=True)

    g16 = gray_batch(1080, 1920, 16)
    tile = gray_batch(2048, 2048, 2)
    wide = tile.repeat(1, 1, 8).contiguous()
    timed = {"16x1080p": (g16, 0), "2x2048x16384": (wide, 0)}
    counted = dict(timed)
    counted["2x1001x1337"] = (gray_batch(1001, 1337, 2), 0)
    for dri in (1, 7, 240):
        counted[f"16x1080p DRI {dri}"] = (g16, dri)

    def plan_of(x, dri):
        return engine.get_plan(x.shape[1], x.shape[2], "gray", 75, "cuda",
                               dri)

    def k1a(lib, x, dri, zz=True):
        """lib's gray K1A: (buf, bits, zz or None), the outputs allocated as
        the wrapper allocates them."""
        plan = plan_of(x, dri)
        lay = plan.layout
        b, h, w = x.shape
        s = k1_dct.n_slots_padded(lay)
        buf = torch.empty((b, s, W_BLK), dtype=torch.int32, device="cuda")
        bits = torch.empty((b, s), dtype=torch.int32, device="cuda")
        buf[:, lay.n_scan:] = 0
        bits[:, lay.n_scan:] = 0
        z = (torch.empty((b, lay.n_mcus, 64), dtype=torch.int16,
                         device="cuda") if zz else None)
        rc = lib.k1a_gray_launch(
            x.data_ptr(), b, h, w, lay.restart_interval or lay.n_mcus, s,
            plan.kdct.data_ptr(), plan.q.data_ptr(), plan.ac_rows.data_ptr(),
            plan.dc_rows.data_ptr(), plan.misc.data_ptr(), W_BLK,
            buf.data_ptr(), bits.data_ptr(), z.data_ptr() if zz else None,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"gray_sweep: k1a_gray_launch gave {rc}")
        return buf, bits, z

    def k1(lib, x, dri):
        plan = plan_of(x, dri)
        b, h, w = x.shape
        s = k1_dct.n_slots_padded(plan.layout)
        z = torch.empty((b, s, 64), dtype=torch.int16, device="cuda")
        z[:, plan.layout.n_scan:] = 0
        rc = lib.k1_gray_launch(x.data_ptr(), b, h, w, s,
                                plan.kdct.data_ptr(), plan.q.data_ptr(),
                                z.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"gray_sweep: k1_gray_launch gave {rc}")
        return z

    def outputs(lib, key):
        x, dri = counted[key]
        return (*k1a(lib, x, dri), k1(lib, x, dri))

    def times(lib, key):
        x, dri = timed[key]
        return {"k1a_gray_ms": ms(lambda: k1a(lib, x, dri, zz=False)),
                "k1_gray_ms": ms(lambda: k1(lib, x, dri))}

    if args.other:
        with tempfile.TemporaryDirectory() as tmp:
            so = os.path.join(tmp, "libother.so")
            r = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so,
                 os.path.join(args.other, "k1a_gray.cu"),
                 os.path.join(args.other, "k1_dct.cu")],
                capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"gray_sweep: nvcc failed:\n{r.stderr}")
            print(json.dumps({"other_ptxas": ptxas_report(r.stderr,
                                                          KERNELS)}),
                  flush=True)
            other = ctypes.CDLL(so)
        for name in ("k1a_gray_launch", "k1_gray_launch"):
            getattr(other, name).argtypes = build.SIGNATURES[name]
            getattr(other, name).restype = ctypes.c_int
        this = build.library()
        for key in counted:
            a, b = outputs(other, key), outputs(this, key)
            torch.cuda.synchronize()
            print(json.dumps({
                "input": key, "coefficients": b[2].numel(),
                "k1a_zz_differing": int((a[2] != b[2]).sum()),
                "k1_zz_differing": int((a[3] != b[3]).sum()),
                "words_differing": int((a[0] != b[0]).sum()),
                "bits_differing": int((a[1] != b[1]).sum()),
                "k1_equals_k1a": bool(torch.equal(
                    b[3][:, :b[2].shape[1]].reshape(-1), b[2].reshape(-1)))}),
                flush=True)
        for key in timed:
            t = [times(other, key), times(this, key), times(this, key),
                 times(other, key)]
            print(json.dumps({"input": key, "other": [t[0], t[3]],
                              "this": [t[1], t[2]]}), flush=True)

    def select(bpt):
        return build.select(f"-DJPGENC_GRAY_BPT={bpt}")

    for bpt in BPTS:
        select(bpt)
        print(json.dumps({"blocks_a_tile": 16 * bpt,
                          "build_s": round(build.build_seconds, 1),
                          "ptxas": ptxas_report(build.build_log, KERNELS)}),
              flush=True)
    first = {}
    for turn in range(2):
        for bpt in BPTS:
            lib = select(bpt)
            row = {"turn": turn, "blocks_a_tile": 16 * bpt}
            for key in timed:
                got = outputs(lib, key)
                ref = first.setdefault(key, got)
                if not all(torch.equal(p, q) for p, q in zip(ref, got)):
                    sys.exit(f"gray_sweep: {key} changes with {16 * bpt} "
                             f"blocks a tile")
                row[key] = times(lib, key)
            print(json.dumps(row), flush=True)
    build.select()


if __name__ == "__main__":
    main()
