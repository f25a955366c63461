"""Time K1 rows and K1A at each tile size of the shared colour transform.

    python3 -m jpgenc_tpu_torch.kernels.tile_sweep

The tile (`common.cuh`: kTileMcus = 4 * kBpt MCUs per thread block) is a
compile-time constant. This script builds the kernels once per candidate
(`-DJPGENC_BPT=4|6|8|10`: 16, 24, 32, 40 MCUs; the last two also with
`-DJPGENC_PLAIN_IDX`, K1A without its special-register reads), prints what
ptxas reports for the three kernels that depend on it (registers, spills),
checks that the coefficients, words and bits do not depend on the build, and
times K1 rows and K1A by CUDA events at 16 x 1080p (120 MCUs a row) and at
2 x 2048 x 16384 (1024 MCUs a row), 4:2:0 Q75 w_blk 8, every candidate in
turn, twice. Needs one NVIDIA GPU and nvcc; prints one JSON object per line.
"""
import json
import subprocess
import sys

CANDIDATES = {"16": ("-DJPGENC_BPT=4",), "24": ("-DJPGENC_BPT=6",),
              "32": ("-DJPGENC_BPT=8",), "40": ("-DJPGENC_BPT=10",),
              "32, plain indices": ("-DJPGENC_BPT=8", "-DJPGENC_PLAIN_IDX"),
              "40, plain indices": ("-DJPGENC_BPT=10", "-DJPGENC_PLAIN_IDX")}
SHAPES = ((16, 1080, 1920), (2, 2048, 16384))
TILE_KERNELS = ("k1a_kernel", "k1_kernel", "k1_repack_kernel")


def ptxas_report(log: str, kernels=TILE_KERNELS) -> list[str]:
    """'<entry>: <registers, spills>' for the named kernels (by default
    those that depend on the tile), from nvcc's -Xptxas=-v output."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill" in ln:
            spill = ln.split(":", 1)[-1].strip()
        elif "Used" in ln and entry:
            if any(k in entry for k in kernels):
                out.append(f"{entry}: {ln.split(':', 1)[-1].strip()}; "
                           f"{spill}")
            entry = None
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("tile_sweep: needs an NVIDIA GPU")
    from jpgenc_tpu_torch import engine
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.ops.cuda import k1_dct, k1a_fused
    from jpgenc_tpu_torch.utils import fixtures

    def ms(fn, iters):
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
    for name, flags in CANDIDATES.items():
        build.select(*flags)
        print(json.dumps({"mcus_a_tile": name,
                          "build_s": round(build.build_seconds, 1),
                          "ptxas": ptxas_report(build.build_log)}), flush=True)
    for b, h, w in SHAPES:
        plan = engine.get_plan(h, w, "420", 75, "cuda")
        ops = (plan.layout, plan.kdct, plan.q)
        tabs = (plan.ac_rows, plan.dc_rows, plan.misc)
        tile = torch.from_numpy(fixtures.synth_batch(h, min(w, 2048), b))
        x = tile.repeat(1, 1, w // tile.shape[2], 1).contiguous().cuda()

        def rows():
            return k1_dct.fused_pixels_to_scan(x, *ops, variant="rows")

        def k1a():
            return k1a_fused.fused_pixels_to_pack(x, *ops, tabs, 8)

        first = None
        for turn in range(2):
            for name, flags in CANDIDATES.items():
                build.select(*flags)
                got = (rows(), *k1a())
                first = first or got
                if not all(torch.equal(a, c) for a, c in zip(first, got)):
                    sys.exit(f"tile_sweep: the output changes with {name}")
                print(json.dumps({"shape": [b, h, w], "turn": turn,
                                  "mcus_a_tile": name,
                                  "k1_rows_ms": ms(rows, 10),
                                  "k1a_ms": ms(k1a, 10)}), flush=True)
    build.select()


if __name__ == "__main__":
    main()
