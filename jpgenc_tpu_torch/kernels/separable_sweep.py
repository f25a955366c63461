"""Hold the separable K1 kernel against another revision's and time it by
tile.

    python3 -m jpgenc_tpu_torch.kernels.separable_sweep [--other DIR]

The inputs (`fixtures.synth_batch`, the separable variant through the C
entry point `k1_dct_launch`): 16 x 1080p in 4:2:0, 4:2:2 and 4:4:4 at Q75
and Q95 (chip_smoke.py's frames), and 4:2:0 Q75 at 2 x 2048 x 16384 (8 tiles
of 2048 x 2048 side by side); for the counts also 2 frames of 1001 x 1337
(odd sizes, a row pitch that is no multiple of 4), 4 frames of 1080p noise
at Q95 (every coefficient busy) and the 16 x 1080p 4:2:0 frames at restart
intervals 1, 7 and 120 (pad slots, which must stay zero).

  * `--other DIR`: builds DIR's `k1_dct.cu` (with DIR's `common.cuh`; nvcc,
    sm_90a; the same C entry point) into a temporary directory, counts the
    coefficients on which its output and this package's differ on every
    input, and times both revisions' kernels by CUDA events in turns (other,
    this, this, other) on the timed inputs. DIR is a directory the copy to
    the card holds, such as a git-ignored `.sep_old/` unpacked from another
    commit's `csrc/`.
  * The tiles (`csrc/common.cuh`: JPGENC_SEP_TILE MCUs of 4:2:0 a thread
    block, JPGENC_SEP_N MCUs a luma thread): rebuilds the package's kernels
    with each candidate, prints what ptxas reports for `k1_color_kernel`
    (registers, spills), checks that the outputs do not depend on the tile,
    and times every candidate in turn, twice, on the timed inputs at Q75.

Needs one NVIDIA GPU and nvcc; prints one JSON object per line.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

#: (JPGENC_SEP_TILE, JPGENC_SEP_N): threads a block are 192 * tile / n
TILES = ((8, 8), (16, 8), (12, 12), (24, 12), (8, 4), (32, 8))
KERNELS = ("k1_color_kernel",)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another revision's csrc/ directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("separable_sweep: needs an NVIDIA GPU")
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

    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}), flush=True)

    x16 = torch.from_numpy(fixtures.synth_batch(1080, 1920, 16)).cuda()
    tile = torch.from_numpy(fixtures.synth_batch(2048, 2048, 2))
    wide = tile.repeat(1, 1, 8, 1).contiguous().cuda()
    odd = torch.from_numpy(fixtures.synth_batch(1001, 1337, 2)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(9)
    noise = torch.randint(0, 256, (4, 1080, 1920, 3), dtype=torch.uint8,
                          device="cuda", generator=gen)
    # key: (images, sampling, quality, restart interval)
    timed = {f"16x1080p {s} Q{q}": (x16, s, q, 0)
             for s in ("420", "422", "444") for q in (75, 95)}
    timed["2x2048x16384 420 Q75"] = (wide, "420", 75, 0)
    counted = dict(timed)
    for s in ("420", "422", "444"):
        counted[f"2x1001x1337 {s} Q75"] = (odd, s, 75, 0)
    counted["4x1080p noise 420 Q95"] = (noise, "420", 95, 0)
    for dri in (1, 7, 120):
        counted[f"16x1080p 420 Q75 DRI {dri}"] = (x16, "420", 75, dri)

    def k1(lib, key, table):
        x, sub, q, dri = table[key]
        plan = engine.get_plan(x.shape[1], x.shape[2], sub, q, "cuda", dri)
        lay = plan.layout
        b, h, w = x.shape[:3]
        hs, vs, _ = k1_dct.geometry(lay)
        s = k1_dct.n_slots_padded(lay)
        z = torch.empty((b, s, 64), dtype=torch.int16, device="cuda")
        z[:, lay.n_scan:] = 0
        rc = lib.k1_dct_launch(2, x.data_ptr(), b, h, w, hs, vs, s,
                               plan.sep.data_ptr(), plan.q.data_ptr(),
                               z.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"separable_sweep: k1_dct_launch gave {rc} on {key}")
        return z, lay.n_scan

    def times(lib):
        return {key: ms(lambda: k1(lib, key, timed)) for key in timed}

    if args.other:
        with tempfile.TemporaryDirectory() as tmp:
            so = os.path.join(tmp, "libother.so")
            r = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so,
                 os.path.join(args.other, "k1_dct.cu")],
                capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"separable_sweep: nvcc failed:\n{r.stderr}")
            print(json.dumps({"other_ptxas": ptxas_report(r.stderr,
                                                          KERNELS)}),
                  flush=True)
            other = ctypes.CDLL(so)
        other.k1_dct_launch.argtypes = build.SIGNATURES["k1_dct_launch"]
        other.k1_dct_launch.restype = ctypes.c_int
        this = build.library()
        print(json.dumps({"this_ptxas": ptxas_report(build.build_log,
                                                     KERNELS)}), flush=True)
        for key in counted:
            (a, n_scan), (b, _) = k1(other, key, counted), k1(this, key,
                                                              counted)
            torch.cuda.synchronize()
            print(json.dumps({
                "input": key, "coefficients": b.numel(),
                "differing": int((a != b).sum()),
                "pad_slots_zero": not bool(b[:, n_scan:].any())}),
                flush=True)
        t = [times(other), times(this), times(this), times(other)]
        for key in timed:
            print(json.dumps({"input": key,
                              "other": [t[0][key], t[3][key]],
                              "this": [t[1][key], t[2][key]]}), flush=True)

    def select(tile_, n):
        return build.select(f"-DJPGENC_SEP_TILE={tile_}",
                            f"-DJPGENC_SEP_N={n}")

    for tile_, n in TILES:
        select(tile_, n)
        print(json.dumps({"tile": tile_, "n": n,
                          "build_s": round(build.build_seconds, 1),
                          "ptxas": ptxas_report(build.build_log, KERNELS)}),
              flush=True)
    swept = [k for k in timed if k.endswith("Q75")]
    first = {}
    for turn in range(2):
        for tile_, n in TILES:
            lib = select(tile_, n)
            row = {"turn": turn, "tile": tile_, "n": n}
            for key in swept:
                got = k1(lib, key, timed)[0]
                if not torch.equal(first.setdefault(key, got), got):
                    sys.exit(f"separable_sweep: {key} changes with tile "
                             f"{tile_}, n {n}")
                row[key] = ms(lambda: k1(lib, key, timed))
            print(json.dumps(row), flush=True)
    build.select()


if __name__ == "__main__":
    main()
