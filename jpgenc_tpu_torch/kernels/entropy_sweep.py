"""Hold kernel A and the merge tail (kernel B with the word compaction)
against another revision's and time both.

    python3 -m jpgenc_tpu_torch.kernels.entropy_sweep [--other DIR]

The inputs, at Q75 unless named: K1's coefficients of `fixtures.
synth_batch(1080, 1920, 16)` in 4:2:0, 4:2:2, 4:4:4 and gray (the luma),
at restart intervals 0, 1, 7, 120 and 240, with the standard tables and with
per-image optimized tables, at w_blk 8, 24 and 56; 2 frames of 2048 x 16384
(8 tiles of 2048 x 2048 side by side) in 4:2:0; 4 frames of seeded uniform
noise at Q95 (w_blk 16 and 56); and the all-nonzero input (every AC
coefficient 1..1023 in magnitude, DC differences up to 2046, at the 16 x
1080p 4:2:0 shapes) at w_blk 8 and 24, where every block overflows, and 56.
Each kernel A output goes through the merge tail capped at the tight and at
the worst tier.

  * Always: this package's kernel A against `pack_blocks_plain` and its
    merge tail against `merge_plain` on the bench input (4:2:0, DRI 0,
    optimized tables, w_blk 8), and the times of both.
  * `--other DIR`: builds DIR's `block_pack.cu` and `seg_merge.cu` (with
    DIR's `common.cuh`; nvcc, sm_90a) into a temporary directory, where DIR
    holds the sources of a revision whose kernel B had the C entry point
    `seg_merge_launch(buf, w0, r, n_blocks, w_blk, spb, out_w, out, stream)`
    behind a torch prologue (`seg_merge.seg_offsets`, a zeroed output) and
    before `pack.wcompact_unstuffed`, as up to PR 7. It counts the words
    and bits of kernel A, and the stream words (each image's aligned
    prefix), nbits and ovf of the merge tail, on which the two revisions
    differ on every input, and times both in turns (other, this, this,
    other) by CUDA events, the tails' device time and kernels a call also
    under torch.profiler. DIR is a directory the copy to the card holds,
    such as a git-ignored `.entropy_old/` unpacked from another commit's
    `csrc/`.

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

Q = 75
MODES = ("420", "422", "444", "gray")
DRIS = (0, 1, 7, 120, 240)
W_BLKS = (8, 24, 56)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another revision's csrc/ directory")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("entropy_sweep: needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from jpgenc_tpu_torch import engine
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.ops import pack
    from jpgenc_tpu_torch.ops.cuda import block_pack, seg_merge
    from jpgenc_tpu_torch.utils import fixtures

    dev = torch.device("cuda")

    def emit(obj):
        print(json.dumps(obj), flush=True)

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

    def device(fn, n_calls=10):
        """Device ms and device records a call under torch.profiler."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0)), e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"device_ms": round(sum(t for t, _ in rows) / n_calls / 1e3,
                                   4),
                "records_per_call": sum(c for _, c in rows) / n_calls}

    emit({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()})

    other = None
    if args.other:
        with tempfile.TemporaryDirectory() as tmp:
            so = os.path.join(tmp, "libother.so")
            r = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", so,
                 os.path.join(args.other, "block_pack.cu"),
                 os.path.join(args.other, "seg_merge.cu")],
                capture_output=True, text=True)
            if r.returncode != 0:
                sys.exit(f"entropy_sweep: nvcc failed:\n{r.stderr}")
            other = ctypes.CDLL(so)
        other.block_pack_launch.argtypes = build.SIGNATURES[
            "block_pack_launch"]
        other.block_pack_launch.restype = ctypes.c_int
        P, I = ctypes.c_void_p, ctypes.c_int
        other.seg_merge_launch.argtypes = [P, P, P, I, I, I, I, P, P]
        other.seg_merge_launch.restype = ctypes.c_int
    build.library()                  # this revision's kernels, built first

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def pack_other(zz, dcdiff, pl, tabs, w_blk):
        """The other revision's kernel A, allocated as the wrapper does."""
        b, s = zz.shape[:2]
        ac, dc, misc = tabs
        buf = torch.empty((b, s, w_blk), dtype=torch.int32, device=dev)
        bits = torch.empty((b, s), dtype=torch.int32, device=dev)
        rc = other.block_pack_launch(
            zz.data_ptr(), dcdiff.data_ptr(), pl.ac_tab.data_ptr(),
            pl.dc_tab.data_ptr(), pl.valid.data_ptr(), b, s, ac.data_ptr(),
            dc.data_ptr(), misc.data_ptr(), 1 if ac.dim() == 2 else b,
            w_blk, buf.data_ptr(), bits.data_ptr(), stream())
        if rc:
            sys.exit(f"entropy_sweep: other block_pack_launch gave {rc}")
        return buf, bits

    def pack_this(zz, dcdiff, pl, tabs, w_blk):
        return block_pack.fused_block_pack(zz, dcdiff, pl.ac_tab, pl.dc_tab,
                                           pl.valid, tabs, w_blk)

    def merge_other(buf, bits, n_seg, w_blk, cap_w, walign):
        """The other revision's tail: the torch prologue, its kernel B, the
        torch compaction and the overflow flag (EncodePlan.merge up to
        PR 7)."""
        b = buf.shape[0]
        flat_bits = bits.reshape(-1)
        w0, r, seg_bits = seg_merge.seg_offsets(flat_bits, b * n_seg, w_blk)
        out_w = min(buf.shape[1] // n_seg * w_blk + 2, cap_w)
        out = torch.zeros((b * n_seg, out_w), dtype=torch.int32, device=dev)
        rc = other.seg_merge_launch(buf.data_ptr(), w0.data_ptr(),
                                    r.data_ptr(), flat_bits.numel(), w_blk,
                                    buf.shape[1] // n_seg, out_w,
                                    out.data_ptr(), stream())
        if rc:
            sys.exit(f"entropy_sweep: other seg_merge_launch gave {rc}")
        wstream, nbits = pack.wcompact_unstuffed(
            out.reshape(b, n_seg, -1), seg_bits.reshape(b, n_seg), cap_w,
            walign)
        return wstream, nbits, bits.amax(dim=1) > 32 * w_blk

    def merge_this(buf, bits, n_seg, w_blk, cap_w, walign):
        return seg_merge.fused_merge(buf, bits, n_seg, w_blk, cap_w, walign)

    def merge_apart(a, b, walign, cap_w):
        """(stream words, nbits, ovf) on which two tails differ, the words
        within each image's aligned prefix (by a's nbits) below cap_w."""
        need = pack.seg_nwords_aligned(a[1].to(torch.int64), walign).sum(1)
        words = sum(int((a[0][i, :k] != b[0][i, :k]).sum())
                    for i, k in enumerate(need.clamp(max=cap_w).tolist()))
        return words, int((a[1] != b[1]).sum()), int((a[2] != b[2]).sum())

    def luma(rgb):
        y = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                              np.float32)
        return np.clip(np.round(y), 0, 255).astype(np.uint8)

    rgb16 = fixtures.synth_batch(1080, 1920, 16)
    x16 = torch.from_numpy(rgb16).to(dev)
    g16 = torch.from_numpy(luma(rgb16)).to(dev)

    def coefficients(x, mode, dri, quality=Q):
        h, w = x.shape[1], x.shape[2]
        pl = engine.get_plan(h, w, mode, quality, "cuda", dri)
        return (pl, *pl.zz_scan(x))

    def dense_coefficients(pl, shape):
        rng = np.random.default_rng(5)
        mag = rng.integers(1, 1024, shape, dtype=np.int16)
        zz = torch.from_numpy(mag * rng.choice(np.array([-1, 1], np.int16),
                                               shape)).to(dev)
        zz[..., 0] = torch.from_numpy(rng.integers(
            -1023, 1024, shape[:2], dtype=np.int16)).to(dev)
        return zz, block_pack.slot_metadata(pl.prev_same, zz)

    def hold(key, pl, zz, dcdiff, tables, w_blks, quality=Q):
        """Kernel A and the merge tail, this revision against the other, on
        one input; prints the counts apart."""
        lay = pl.layout
        tab_sets = {"standard": pl.standard_tables}
        if "optimized" in tables:
            tab_sets["optimized"] = pl.optimized_tables(
                pl.histogram(zz, dcdiff))[1]
        caps = {t: engine.scan_caps(lay, quality, t)[0] // 4
                for t in ("tight", "worst")}
        for name, tabs in tab_sets.items():
            for w_blk in w_blks:
                a = pack_this(zz, dcdiff, pl, tabs, w_blk)
                row = {"input": key, "tables": name, "w_blk": w_blk,
                       "blocks": a[1].numel(),
                       "overflowing": int((a[1] > 32 * w_blk).sum())}
                if other is not None:
                    o = pack_other(zz, dcdiff, pl, tabs, w_blk)
                    row["words_apart"] = int((a[0] != o[0]).sum())
                    row["bits_apart"] = int((a[1] != o[1]).sum())
                for tier, cap in caps.items():
                    t = merge_this(*a, lay.n_segments, w_blk, cap,
                                   pl.walign)
                    if other is not None:
                        u = merge_other(*a, lay.n_segments, w_blk, cap,
                                        pl.walign)
                        row[f"merge_{tier}_apart"] = dict(zip(
                            ("words", "nbits", "ovf"),
                            merge_apart(u, t, pl.walign, cap)))
                torch.cuda.synchronize()
                emit(row)

    # the bench input first: this revision against the plain versions, and
    # the times
    pl, zz, dcdiff = coefficients(x16, "420", 0)
    lay = pl.layout
    _, opt = pl.optimized_tables(pl.histogram(zz, dcdiff))
    a = pack_this(zz, dcdiff, pl, opt, 8)
    n_img = zz.shape[0]
    pbuf, pbits = block_pack.pack_blocks_plain(
        zz.reshape(-1, 64), dcdiff.reshape(-1), pl.ac_tab.repeat(n_img), opt,
        8, dctab=pl.dc_tab.repeat(n_img), valid=pl.valid.repeat(n_img),
        img=torch.arange(n_img, device=dev).repeat_interleave(zz.shape[1]))
    cap = engine.scan_caps(lay, Q, "tight")[0] // 4
    t = merge_this(*a, 1, 8, cap, pl.walign)
    p = seg_merge.merge_plain(*a, 1, 8, cap, pl.walign)
    emit({"input": "bench 16x1080p 420 optimized w_blk 8",
          "kernel_a_vs_plain_words_apart": int(
              (a[0].reshape(-1, 8) != pbuf).sum()),
          "kernel_a_vs_plain_bits_apart": int(
              (a[1].reshape(-1) != pbits).sum()),
          "merge_vs_plain_apart": dict(zip(("words", "nbits", "ovf"),
                                           merge_apart(p, t, pl.walign,
                                                       cap)))})
    del pbuf, pbits
    dzz, ddc = dense_coefficients(pl, tuple(zz.shape))
    std = pl.standard_tables
    mine = ("this", pack_this, merge_this)
    runs = [mine, mine] if other is None else \
        [("other", pack_other, merge_other), mine, mine,
         ("other", pack_other, merge_other)]
    times = {}
    for side, pk, mg in runs:
        row = times.setdefault(side, [])
        row.append({
            "kernel_a_ms": ms(lambda: pk(zz, dcdiff, pl, opt, 8)),
            "kernel_a_all_nonzero_w56_ms": ms(
                lambda: pk(dzz, ddc, pl, std, 56), 10),
            "merge_ms": ms(lambda: mg(*a, 1, 8, cap, pl.walign)),
            "merge_profile": device(lambda: mg(*a, 1, 8, cap, pl.walign))})
    emit({"times": times, "shape": "16 x 1080p 4:2:0 Q75, kernel A with "
          "per-image tables at w_blk 8 (all-nonzero: standard tables, "
          "w_blk 56), merge tail on K1's words at the tight cap"})
    if other is None:
        return

    hold("16x1080p 420 all-nonzero", pl, dzz, ddc, ("standard",), W_BLKS)
    del dzz, ddc, a, t, p
    for mode in MODES:
        x = g16 if mode == "gray" else x16
        for dri in DRIS:
            pl, zz, dcdiff = coefficients(x, mode, dri)
            hold(f"16x1080p {mode} DRI {dri}", pl, zz, dcdiff,
                 ("standard", "optimized"), W_BLKS)
            del zz, dcdiff
    del x16, g16
    tile = fixtures.synth_batch(2048, 2048, 2)
    xw = torch.from_numpy(np.ascontiguousarray(np.tile(tile, (1, 1, 8, 1)))
                          ).to(dev)
    pl, zz, dcdiff = coefficients(xw, "420", 0)
    hold("2x2048x16384 420", pl, zz, dcdiff, ("standard", "optimized"),
         (8, 56))
    del xw, zz, dcdiff
    noise = np.random.default_rng(95).integers(0, 256, (4, 1080, 1920, 3),
                                               np.uint8)
    pl, zz, dcdiff = coefficients(torch.from_numpy(noise).to(dev), "420", 0,
                                  quality=95)
    hold("4x1080p noise Q95", pl, zz, dcdiff, ("standard", "optimized"),
         (16, 56), quality=95)


if __name__ == "__main__":
    main()
