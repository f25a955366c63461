#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`jpgenc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `jpgenc_tpu_torch/csrc/` with nvcc (sm_90a),
checks each kernel against its plain PyTorch version on the card, and drives
the encode paths through `parallel.mesh.encode_batch` and the decode paths
through `api.decode_batch` / `api.decode`, each with the launch counters
reset just before it and read just after:

  * the fused path: 16 distinct 1080p RGB frames, 4:2:0, Q75, standard tables
    (K1A -> the merge tail: kernel B with the word compaction);
  * the split path: the same frames with optimize=True, one Huffman table set
    per image (K1 -> histogram -> host tables -> kernel A -> kernel B);
  * gray: the luma of the same frames, without optimize (gray K1A -> kernel
    B) and with it (gray K1 -> ... -> kernel A -> kernel B);
  * the decoder: the files of the paths above (standard tables, optimized
    tables, gray) back to pixels on the card (host entropy decode -> packed
    upload -> densify -> the reconstruction kernel), as one batch, in chunks
    of 4 and one file alone; a restart-interval file, a file with escaped
    coefficients, and a 4:1:1 layout (torch ops, no kernel);
  * restart intervals: the 16 frames with DRI 120, fused and optimize, gray
    with DRI 240, and small odd sizes with DRI 1, 3, 7 in every mode;
  * a wide frame: 2 frames of 2048 x 16384 with optimize=True, whose pass 1
    is the K1 kernel over the MCU repack (past the reference's row gate);
  * the separable K1 kernel: the 16 frames with optimize=True under
    k1_dct.K1_DENSE = False;
  * islow: the libjpeg-exact integer path (torch ops -> kernel A -> kernel
    B), one 1080p frame and small odd sizes in every mode, against the numpy
    reference (ref.islow + ref.encoder) byte for byte;
  * the file-driven entry points: the 16 frames through stage_batch (the
    pinned side-stream upload), equal to the fused path's files; 32 RGB
    1080p PPMs and 4 gray 720p PGMs through `python -m jpgenc_tpu_torch
    batch --device cuda` in a subprocess (three chunks, one shape change,
    the next chunk staged while one encodes; launch counters printed by the
    subprocess at exit), each file equal to encode_batch's, a resume that
    skips all 36 and a CLI decode equal to api.decode; and bench_torch.py
    with the headline, decode and batch_sharded rows at a batch of 16;
  * distribution: one 4320 x 7680 frame through encode_striped in 6 and 8
    stripes, fused and optimize, its luma in 7 stripes and an islow +
    optimize case at 4321 rows (files equal api.encode's at their DRI);
    the 16 frames over the device list ["cuda", "cuda"] (encode fused and
    optimize, the batch-split decode, the transcode); and
    `dryrun_torch.py --ranks 2 --device cuda --full`, two processes over
    gloo on the one card, whose files' SHA-256 equal this process's.

Every output file is checked by the repo's own means: the C++ scan decoder,
with the file's own tables, returns the kernel's coefficients exactly, and
frame 0's scan equals the numpy reference encoder's entropy coding of those
coefficients. The fused and the split kernels must hold the same
coefficients and, with the same tables, the same packed words: K1A, K1 rows
and the K1 repack kernel run one per-block transform (BT.601, box subsample,
each 8x8 block times KDCT_ZZ in shared memory), gray K1A and gray K1 its gray
counterpart, and each may differ from its plain version only where the
float64 value lies within 1e-4 of a rounding boundary. The files' bits per
pixel must stay within 1e-4 of the values recorded before that transform
replaced the dense operator. Decoded
pixels equal the reconstruction kernel's on the encoder's own coefficients
exactly, and the kernel is held against its plain version (max |diff| <= 1
on fewer than 1e-3 of the bytes) and the float64 reference (max |diff| <= 3)
on the encoder's coefficients in four modes, at one small odd size each,
and on an input of the same shapes with every coefficient nonzero (the
kernels leave out zero terms; that input times them with none left out).

Every phase either passes or exits non-zero; nothing falls back to the CPU,
to a plain version or to a Python finalize. Each earlier stdout line is one
JSON object; the lines before the last are the kernels' summary and the
card's `nvidia-smi` name and power limit; the last line is
{"ok": true, "device": {...}}. Exits non-zero, printing no result, when CUDA
is not available or the package is not beside it.
"""
import json
import subprocess
import sys
import time

import numpy as np

Q = 75
H, W = 1080, 1920
KNIFE_EDGE_FRAC = 1e-4     # k1_dct.py:18-24: |diff| <= 1 on <= 1e-4 of coefs
PIXEL_FRAC = 1e-3          # test_pallas_recon.py:24-30: recon vs plain version
# dB, decoded vs source pixels; the first run read 38.46 (colour), 43.36 (gray)
PSNR_FLOOR = 35.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores, same sheet
# bits per pixel of each path's files with the dense-operator kernels (this
# script's run on an H100 before the per-block transform): a faster
# transform must not change the files by more than a knife-edge coefficient
BPP_BEFORE = {"fused": 0.2403, "optimize": 0.1758, "gray": 0.1957,
              "gray_optimize": 0.146, "dri": 0.2411, "dri_optimize": 0.1766,
              "gray_dri": 0.1972, "wide_optimize": 0.1101,
              "wide_fused": 0.1807, "separable": 0.1758,
              "islow 1080p standard": 0.2412,
              "islow 1080p optimize DRI 120": 0.1776}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    from jpgenc_tpu_torch import api, decoder, engine, native
    from jpgenc_tpu_torch.container import parser
    from jpgenc_tpu_torch.kernels import build, tile_sweep
    from jpgenc_tpu_torch.layout import make_layout
    from jpgenc_tpu_torch.ops import entropy, pack
    from jpgenc_tpu_torch.ops.cuda import (block_pack, k1_dct, k1a_fused,
                                           recon, seg_merge, symbol_hist)
    from jpgenc_tpu_torch.parallel import mesh
    from jpgenc_tpu_torch.ref import decoder as ref_decoder
    from jpgenc_tpu_torch.ref import encoder as ref_encoder
    from jpgenc_tpu_torch.ref import islow as ref_islow
    from jpgenc_tpu_torch.utils import fixtures
    from jpgenc_tpu_torch.utils.metrics import psnr

    dev = torch.device("cuda")

    def sync_ms(fn, iters: int, warmup: int = 1) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters

    def device_profile(fn, n_calls):
        """(device ms, device records) per call of fn under torch.profiler:
        the kernels' and copies' device time, and how many ran. None where
        the profiler reports no device time."""
        from torch.profiler import ProfilerActivity, profile
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
        us = sum(t for t, _ in rows)
        if not us:
            return None
        return {"device_ms": round(us / n_calls / 1e3, 4),
                "launches_per_call": sum(c for _, c in rows) / n_calls}

    def knife_edge(a, b, what):
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        mx, frac = int(d.max()), float((d > 0).double().mean())
        if mx > 1 or frac > KNIFE_EDGE_FRAC:
            fail(f"{what}: max |diff| {mx}, mismatch fraction {frac:.2e}")
        return mx, frac

    def same_bpp(key, value):
        if abs(value - BPP_BEFORE[key]) > 1e-4 + 1e-9:
            fail(f"bpp of {key}: {value}, recorded {BPP_BEFORE[key]}")
        return value

    # --- phase 1: the card and the build -----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    build.library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    spilled = [ln for ln in ptxas if "spill" in ln and
               "0 bytes spill stores, 0 bytes spill loads" not in ln]
    if spilled:
        fail(f"ptxas reports register spills: {spilled}")
    t0 = time.perf_counter()
    if not native.available():
        fail("the C++ scan codec did not build (no g++?): the host finalize "
             "would silently run in Python")
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build.build_seconds, 3),
          "kernels_with_spills": len(spilled),
          "native_build_s": round(time.perf_counter() - t0, 3)})

    plan = engine.get_plan(H, W, "420", Q, "cuda")
    lay = plan.layout
    ops = (lay, plan.kdct, plan.q)
    tabs = (plan.ac_rows, plan.dc_rows, plan.misc)
    slot_plan = (plan.ac_tab, plan.dc_tab, plan.valid)
    qt = list(engine.qtables_for_quality(Q))
    dc_t, ac_t = ref_encoder.standard_tables()
    gplan = engine.get_plan(H, W, "gray", Q, "cuda")
    glay = gplan.layout
    gops = (glay, gplan.kdct, gplan.q)
    gtabs = (gplan.ac_rows, gplan.dc_rows, gplan.misc)

    def raster(zz_scan, layout=lay):
        """[n_slots * 64] scan-ordered -> [n_total, 64] raster blocks."""
        out = np.empty((layout.n_scan, 64), np.int32)
        out[layout.scan_flat] = zz_scan.reshape(-1, 64)
        return out

    # --- phase 2: K1A against its plain version and the numpy reference ----
    imgs4 = fixtures.synth_batch(H, W, 4)
    x4 = torch.from_numpy(imgs4).to(dev)
    zz_plain4 = k1a_fused.transform_plain(x4, *ops)
    k1a_out = {}
    for w_blk in (8, 56):
        buf, bits, zz = k1a_fused.fused_pixels_to_pack(x4, *ops, tabs, w_blk,
                                                       return_zz=True)
        torch.cuda.synchronize()
        mx, frac = knife_edge(zz, zz_plain4, f"K1A zz vs plain, w_blk={w_blk}")
        ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), lay, tabs,
                                              w_blk)
        if not (torch.equal(ebits, bits) and torch.equal(ebuf, buf)):
            fail(f"K1A entropy half != entropy_plain(kernel zz), w_blk={w_blk}")
        k1a_out[w_blk] = (buf, bits, zz)
        emit({"phase": "k1a", "w_blk": w_blk, "zz_vs_plain_max_abs": mx,
              "zz_vs_plain_mismatch_frac": frac, "entropy_exact": True,
              "max_bits": int(bits.max())})
    if not torch.equal(k1a_out[8][2], k1a_out[56][2]):
        fail("K1A zz differs between two launches")
    t0 = time.perf_counter()
    for i in range(len(imgs4)):
        ref = ref_encoder.image_to_zigzag(imgs4[i], lay, qt)[lay.scan_flat]
        mx, frac = knife_edge(k1a_out[8][2][i].reshape(-1, 64).cpu(),
                              torch.from_numpy(ref), f"K1A vs ref frame {i}")
        emit({"phase": "k1a_vs_ref_encoder", "frame": i, "max_abs": mx,
              "mismatch_frac": frac})
    ref_s = time.perf_counter() - t0

    # --- phase 3: the merge tail against its plain version ------------------
    # kernel B, the compaction and the overflow flag in one wrapper
    # (seg_merge.fused_merge) against merge_plain (seg_merge_plain ->
    # pack.wcompact_unstuffed -> amax) on the card: nbits and ovf exactly,
    # and every word of each image's aligned prefix
    cap_w = engine.scan_caps(lay, Q, "tight")[0] // 4
    noise = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    x2 = torch.from_numpy(np.stack([imgs4[0], noise])).to(dev)

    def hold_merge(buf, bits, layout, cap, w_blk, what):
        walign = pack.walign_for(layout.blocks_per_segment)
        kw, kn, ko = seg_merge.fused_merge(buf, bits, layout.n_segments,
                                           w_blk, cap, walign)
        pw, pn, po = seg_merge.merge_plain(buf, bits, layout.n_segments,
                                           w_blk, cap, walign)
        torch.cuda.synchronize()
        if not (torch.equal(kn, pn) and torch.equal(ko, po)):
            fail(f"merge tail nbits/ovf != merge_plain ({what})")
        need = pack.seg_nwords_aligned(kn.to(torch.int64), walign).sum(1)
        for i, k in enumerate(need.clamp(max=cap).tolist()):
            if not torch.equal(kw[i, :k], pw[i, :k]):
                fail(f"merge tail image {i} != merge_plain ({what})")
        return need, ko

    dri3 = engine.get_plan(H, W, "420", Q, "cuda", 120)
    for pl3 in (plan, dri3):
        lay3 = pl3.layout
        for x_, what in ((x4, "4 frames"), (x2, "frame 0 + noise")):
            buf8, bits8 = k1a_fused.fused_pixels_to_pack(
                x_, lay3, pl3.kdct, pl3.q, tabs, 8)
            for cap in (None, cap_w):
                cap_ = engine.scan_caps(lay3, Q, "worst")[0] // 4 \
                    if cap is None else cap
                need, ovf_ = hold_merge(buf8, bits8, lay3, cap_, 8,
                                        f"{what}, DRI "
                                        f"{lay3.restart_interval}, cap "
                                        f"{cap_}")
                emit({"phase": "merge_tail", "input": what,
                      "restart_interval": lay3.restart_interval,
                      "segments": lay3.n_segments, "cap_words": cap_,
                      "prefix_words": need.tolist(), "ovf": ovf_.tolist(),
                      "exact": True})
    if not ovf_[1] or ovf_[0]:
        fail("the noise frame did not overflow w_blk 8, or frame 0 did")
    del buf8, bits8

    # --- phase 4: the fused path --------------------------------------------
    imgs16 = fixtures.synth_batch(H, W, 16)
    x16 = torch.from_numpy(imgs16).to(dev)
    torch.cuda.synchronize()
    counters = (k1a_fused, seg_merge, k1_dct, block_pack, recon,
                symbol_hist)

    def reset_counters():
        decoder.unfused_calls = 0
        for mod in counters:
            for name in ("launches", "launches_gray", "launches_repack",
                         "launches_color", "plain_calls"):
                if hasattr(mod, name):
                    setattr(mod, name, 0)

    def read_counters():
        """(launches by kernel name, plain calls) since reset_counters."""
        return ({"k1a_fused": k1a_fused.launches,
                 "k1a_gray": k1a_fused.launches_gray,
                 "seg_merge": seg_merge.launches,
                 "k1_dct": k1_dct.launches,
                 "k1_dense_repack": k1_dct.launches_repack,
                 "k1_color": k1_dct.launches_color,
                 "k1_gray": k1_dct.launches_gray,
                 "block_pack": block_pack.launches,
                 "recon": recon.launches,
                 "recon_gray": recon.launches_gray},
                sum(mod.plain_calls for mod in counters))

    def drive(x, expect, n_walls, **kw):
        """Reset the counters, run encode_batch once, read them, require the
        `expect`ed kernels and no others, then time n_walls more calls."""
        reset_counters()
        t0 = time.perf_counter()
        files = mesh.encode_batch(x, quality=Q, subsampling="420",
                                  device="cuda", **kw)
        first_s = time.perf_counter() - t0
        launches, plain = read_counters()
        ran = {k for k, v in launches.items() if v}
        if ran != set(expect) or plain:
            fail(f"path {kw}: launches {launches} (expected {expect}), "
                 f"plain calls {plain}")
        walls = []
        for _ in range(n_walls):
            t0 = time.perf_counter()
            again = mesh.encode_batch(x, quality=Q, subsampling="420",
                                      device="cuda", **kw)
            walls.append(time.perf_counter() - t0)
            if again != files:
                fail(f"encode_batch {kw} is not deterministic")
        return files, launches, plain, first_s, walls

    def busy(x, n_calls=5, **kw):
        """Device busy share of steady encode_batch calls under
        torch.profiler: the kernels' and copies' device time over the wall
        of the window, and the top kernels by device time. The profiler
        slows the host side, so this is a lower bound of the share without
        it. Time per call is the window's total over n_calls, so a dropped
        record lowers it. None where the profiler reports no device
        time."""
        from torch.profiler import ProfilerActivity, profile

        def call():
            return mesh.encode_batch(x, quality=Q, subsampling="420",
                                     device="cuda", **kw)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_calls):
                call()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
        # device-side rows only (kernels, copies): the host-side row of a
        # torch op repeats its kernels' device time
        rows = sorted(((dev_us(e), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and dev_us(e) > 0), reverse=True)
        total = sum(us for us, _, _ in rows)
        if not total:
            return None
        return {"device_ms_per_call": round(total / n_calls / 1e3, 3),
                "wall_ms_per_call": round(wall_us / n_calls / 1e3, 3),
                "busy_share": round(total / wall_us, 3),
                # [name, device ms per call, records in the window]: the
                # profiler has been seen to drop a launch (4 records of a
                # kernel that ran once in each of the 5 calls)
                "top": [[k[:60], round(us / n_calls / 1e3, 3), n]
                        for us, k, n in rows[:6]]}

    def rates(walls, n_frames):
        mpix = n_frames * H * W / 1e6
        return {"wall_s": [round(t, 4) for t in walls],
                "mpix_per_s_best": round(mpix / min(walls), 1),
                "mpix_per_s_median":
                    round(mpix / sorted(walls)[len(walls) // 2], 1)}

    def bpp(files):
        return round(float(np.mean([8 * len(f) / (H * W) for f in files])), 4)

    fin0 = native.finalize_calls, native.finalize_workers
    files, launches, plain, first_s, walls = drive(
        x16, ("k1a_fused", "seg_merge"), 3)
    main_launches, walls_fused = dict(launches), walls
    # each call's 16 files in one native finalize, on about one C++ worker
    # a MiB of scan (the fixture's 16 frames: about 1 MB)
    finalize = {"calls": native.finalize_calls - fin0[0],
                "workers": native.finalize_workers - fin0[1]}
    if finalize["calls"] != 4:
        fail(f"expected one batch finalize a call of 4: {finalize}")

    _, _, zz16 = k1a_fused.fused_pixels_to_pack(x16, *ops, tabs, 8,
                                                return_zz=True)
    zz16_np = zz16.cpu().numpy().astype(np.int32)

    def decode(data, layout=lay):
        """Parse a file and scan-decode it with ITS OWN tables."""
        p = parser.parse_jpeg(data)
        if (p.height, p.width, p.subsampling) != (H, W, layout.subsampling):
            fail(f"file header {p.height}x{p.width} {p.subsampling}")
        coef = native.decode_scan(
            p.scan_data, layout, [c.dc_tab for c in p.comps],
            [c.ac_tab for c in p.comps],
            [p.dc_tables.get(i) for i in range(2)],
            [p.ac_tables.get(i) for i in range(2)])
        if coef is None:
            fail("the native scan decoder is unavailable (no g++?)")
        return p, coef

    for i, data in enumerate(files):
        _, coef = decode(data)
        if not np.array_equal(coef, raster(zz16_np[i])):
            fail(f"file {i}: decoded coefficients != kernel zz")
    p0, _ = decode(files[0])
    t0 = time.perf_counter()
    if p0.scan_data != ref_encoder.entropy_scan(lay, raster(zz16_np[0]), dc_t,
                                                ac_t):
        fail("frame 0 scan != ref.encoder.entropy_scan(kernel zz)")
    entropy_ref_s = time.perf_counter() - t0

    # worst-tier retry: a uniform-noise frame overflows the tight tier
    tight = plan.fetch(plan(x2, cap_w * 4, 8), cap_w * 4)
    if tight[0][2] is not None or tight[1][2] is None:
        fail("expected the tight tier to fit frame 0 and overflow the noise")
    pair = mesh.encode_batch(x2, quality=Q, device="cuda")
    _, _, zzn = k1a_fused.fused_pixels_to_pack(x2[1:], *ops, tabs, 56,
                                               return_zz=True)
    zzn_np = zzn[0].cpu().numpy().astype(np.int32)
    if pair[0] != files[0]:
        fail("frame 0 bytes differ between batches")
    if not np.array_equal(decode(pair[1])[1], raster(zzn_np)):
        fail("noise frame (worst tier) decoded != kernel zz")
    emit({"phase": "encode_batch", "frames": len(files),
          "launches": launches, "plain_calls": plain, "finalize": finalize,
          "first_call_s": round(first_s, 4), **rates(walls, len(files)),
          "profile": busy(x16),
          "bpp": same_bpp("fused", bpp(files)),
          "noise_bpp": round(8 * len(pair[1]) / (H * W), 4),
          "decode_exact": True, "entropy_scan_exact": True,
          "ref_encoder_s": round(ref_s, 2),
          "entropy_scan_s": round(entropy_ref_s, 2)})

    # --- phase 5: K1 and gray K1 against their plain versions and K1A -------
    zz_k1 = k1_dct.fused_pixels_to_scan(x4, *ops)
    torch.cuda.synchronize()
    k1_err, frac = knife_edge(zz_k1.reshape(zz_plain4.shape), zz_plain4,
                              "K1 zz vs plain")
    if not torch.equal(zz_k1.reshape(-1), k1a_out[8][2].reshape(-1)):
        fail("K1 zz != K1A zz on the same frames")
    emit({"phase": "k1", "zz_vs_plain_max_abs": k1_err,
          "zz_vs_plain_mismatch_frac": frac, "equals_k1a_zz": True})

    def luma(rgb):
        y = rgb.astype(np.float32) @ np.array([0.299, 0.587, 0.114],
                                              np.float32)
        return np.clip(np.round(y), 0, 255).astype(np.uint8)

    gray16 = np.stack([luma(f) for f in imgs16])
    g16 = torch.from_numpy(gray16).to(dev)
    g4 = g16[:4].contiguous()
    gzz_plain4 = k1_dct.transform_plain(g4, *gops)
    gzz_k1 = k1_dct.fused_pixels_to_scan(g4, *gops)
    gray_out = {}
    for w_blk in (8, 56):
        gbuf, gbits, gzz = k1a_fused.fused_pixels_to_pack(
            g4, *gops, gtabs, w_blk, return_zz=True)
        torch.cuda.synchronize()
        ebuf, ebits = k1a_fused.entropy_plain(gzz.to(torch.int32), glay,
                                              gtabs, w_blk)
        if not (torch.equal(ebits, gbits) and torch.equal(ebuf, gbuf)):
            fail(f"gray K1A entropy half != entropy_plain, w_blk={w_blk}")
        if not torch.equal(gzz, gzz_k1):
            fail(f"gray K1 zz != gray K1A zz, w_blk={w_blk}")
        gray_out[w_blk] = (gbuf, gbits)
    gk1_err, gfrac = knife_edge(gzz_k1, gzz_plain4, "gray K1 zz vs plain")
    emit({"phase": "k1_gray", "zz_vs_plain_max_abs": gk1_err,
          "zz_vs_plain_mismatch_frac": gfrac, "equals_k1a_gray_zz": True,
          "k1a_gray_entropy_exact": True,
          "max_bits": int(gray_out[56][1].max())})

    # --- phase 6: the histogram, then kernel A against its plain version ----
    dcdiff4 = block_pack.slot_metadata(plan.prev_same, zz_k1)
    h_launches = symbol_hist.launches
    hist4 = entropy.symbol_histogram(zz_k1, dcdiff4, *slot_plan)
    if symbol_hist.launches != h_launches + 1:
        fail("the symbol histogram did not launch its kernel")
    t0 = time.perf_counter()
    ref_hist = ref_encoder.symbol_histogram(
        lay, raster(zz_k1[0].cpu().numpy().astype(np.int32)))
    if not np.array_equal(hist4[0].cpu().numpy(), ref_hist):
        fail("symbol histogram kernel != ref.encoder.symbol_histogram, "
             "frame 0")
    emit({"phase": "histogram", "exact": True,
          "symbols": int(ref_hist.sum()),
          "ref_histogram_s": round(time.perf_counter() - t0, 2)})

    _, opt_tabs4 = plan.optimized_tables(hist4)
    n4, s4 = zz_k1.shape[:2]
    img_of_slot = torch.arange(n4, device=dev).repeat_interleave(s4)
    for name, t in (("standard", tabs), ("optimized", opt_tabs4)):
        for w_blk in (8, 56):
            abuf, abits = block_pack.fused_block_pack(zz_k1, dcdiff4,
                                                      *slot_plan, t, w_blk)
            torch.cuda.synchronize()
            pbuf, pbits = block_pack.pack_blocks_plain(
                zz_k1.reshape(-1, 64), dcdiff4.reshape(-1),
                plan.ac_tab.repeat(n4), t, w_blk,
                img=img_of_slot if t is opt_tabs4 else None)
            if not (torch.equal(abits.reshape(-1), pbits)
                    and torch.equal(abuf.reshape(-1, w_blk), pbuf)):
                fail(f"kernel A != pack_blocks_plain ({name}, w_blk={w_blk})")
            if t is tabs and not (torch.equal(abuf, k1a_out[w_blk][0]) and
                                  torch.equal(abits, k1a_out[w_blk][1])):
                fail(f"kernel A(K1 zz) != K1A buf/bits, w_blk={w_blk}")
            emit({"phase": "block_pack", "tables": name, "w_blk": w_blk,
                  "exact": True, "equals_k1a": t is tabs,
                  "max_bits": int(abits.max())})
    gdc = block_pack.slot_metadata(gplan.prev_same, gzz_k1)
    for w_blk in (8, 56):
        abuf, abits = block_pack.fused_block_pack(
            gzz_k1, gdc, gplan.ac_tab, gplan.dc_tab, gplan.valid, gtabs, w_blk)
        if not (torch.equal(abuf, gray_out[w_blk][0]) and
                torch.equal(abits, gray_out[w_blk][1])):
            fail(f"kernel A(gray K1 zz) != gray K1A buf/bits, w_blk={w_blk}")
    k1a_out_bits8 = k1a_out[8][1]
    del zz_plain4, gzz_plain4, k1a_out, gray_out

    # --- phase 7: the split path (optimize=True) at full width --------------
    def check_optimized(files, plain_files, zz_np, layout, n_tabs, what):
        """Every file parses, carries its own DHT, decodes to the kernel's
        coefficients exactly and is smaller than the standard-table file;
        frame 0's scan equals the reference coder's with the file's tables."""
        _, std_ac = ref_encoder.standard_tables()
        for i, data in enumerate(files):
            p, coef = decode(data, layout)
            if not np.array_equal(coef, raster(zz_np[i], layout)):
                fail(f"{what} file {i}: decoded coefficients != K1 zz")
            same = all(np.array_equal(p.ac_tables[t].vals, std_ac[t].vals)
                       and np.array_equal(p.ac_tables[t].bits, std_ac[t].bits)
                       for t in range(n_tabs))
            if same:
                fail(f"{what} file {i}: DHT equals Annex K")
            if len(data) >= len(plain_files[i]):
                fail(f"{what} file {i}: {len(data)} bytes, not smaller than "
                     f"the standard-table file's {len(plain_files[i])}")
        p0, _ = decode(files[0], layout)
        own_dc = [p0.dc_tables[t] for t in range(n_tabs)]
        own_ac = [p0.ac_tables[t] for t in range(n_tabs)]
        if p0.scan_data != ref_encoder.entropy_scan(
                layout, raster(zz_np[0], layout), own_dc, own_ac):
            fail(f"{what} frame 0 scan != ref.encoder.entropy_scan with the "
                 "optimized tables")

    opt_files, launches, plain, first_s, walls = drive(
        x16, ("k1_dct", "block_pack", "seg_merge"), 3, optimize=True)
    opt_launches = dict(launches)
    # the histogram kernel's launches over the path's 4 calls (it is not
    # among read_counters' kernels, whose sets every path checks exactly)
    opt_hist_launches = symbol_hist.launches
    if opt_hist_launches < 4:
        fail(f"optimize: {opt_hist_launches} histogram launches in 4 calls")
    zz16_k1 = k1_dct.fused_pixels_to_scan(x16, *ops)
    if not torch.equal(zz16_k1.reshape(-1), zz16.reshape(-1)):
        fail("K1 zz != K1A zz at B=16")
    check_optimized(opt_files, files, zz16_np, lay, 2, "optimize")

    # the split of one optimize call: pass 1 / host tables / pass 2
    def split_of_optimize(pl, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zz, dcdiff, hist = pl.zz_and_histogram(x)
        hist = hist.cpu()                                # syncs
        t1 = time.perf_counter()
        _, tb = pl.optimized_tables(hist)
        t2 = time.perf_counter()
        cap = engine.scan_caps(pl.layout, Q, "tight")[0]
        scans = pl.finalize(
            pl.fetch(pl.entropy_from_zz(zz, dcdiff, tb, cap, 8), cap))
        t3 = time.perf_counter()
        if any(s is None for s in scans):
            fail("a frame overflowed the tight tier in the timed split")
        dev_ms = sync_ms(
            lambda: pl.entropy_from_zz(zz, dcdiff, tb, cap, 8), 5)
        return {"pass1_ms": round(1e3 * (t1 - t0), 3),
                "tables_ms": round(1e3 * (t2 - t1), 3),
                "pass2_ms": round(1e3 * (t3 - t2), 3),
                "pass2_device_ms": round(dev_ms, 3)}

    split_of_optimize(plan, x16)                         # warm
    emit({"phase": "encode_batch_optimize", "frames": len(opt_files),
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4), **rates(walls, len(opt_files)),
          "bpp": same_bpp("optimize", bpp(opt_files)),
          "bpp_standard_tables": bpp(files),
          "split": split_of_optimize(plan, x16),
          "profile": busy(x16, optimize=True),
          "decode_exact": True, "entropy_scan_exact": True})

    # the noise frame through optimize: the worst-tier retry from cached zz
    reset_counters()
    pair_opt = mesh.encode_batch(x2, quality=Q, optimize=True, device="cuda")
    launches, plain = read_counters()
    if launches["block_pack"] < 2 or launches["k1_dct"] != 1 or plain:
        fail(f"optimize noise retry: launches {launches}, plain {plain}")
    if pair_opt[0] != opt_files[0]:
        fail("optimize frame 0 bytes differ between batches")
    if not np.array_equal(decode(pair_opt[1])[1], raster(zzn_np)):
        fail("optimize noise frame (worst tier) decoded != kernel zz")
    emit({"phase": "optimize_noise_retry", "launches": launches,
          "noise_bpp": round(8 * len(pair_opt[1]) / (H * W), 4),
          "noise_bpp_standard_tables": round(8 * len(pair[1]) / (H * W), 4),
          "decode_exact": True})

    # --- phase 8: gray at full width, without and with optimize -------------
    gfiles, launches, plain, first_s, walls = drive(
        g16, ("k1a_gray", "seg_merge"), 3)
    gray_launches = dict(launches)
    gzz16 = k1_dct.fused_pixels_to_scan(g16, *gops)
    gzz16_np = gzz16.cpu().numpy().astype(np.int32)
    for i, data in enumerate(gfiles):
        if not np.array_equal(decode(data, glay)[1],
                              raster(gzz16_np[i], glay)):
            fail(f"gray file {i}: decoded coefficients != kernel zz")
    if decode(gfiles[0], glay)[0].scan_data != ref_encoder.entropy_scan(
            glay, raster(gzz16_np[0], glay), dc_t[:1], ac_t[:1]):
        fail("gray frame 0 scan != ref.encoder.entropy_scan(kernel zz)")
    emit({"phase": "encode_batch_gray", "frames": len(gfiles),
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4), **rates(walls, len(gfiles)),
          "profile": busy(g16), "bpp": same_bpp("gray", bpp(gfiles)),
          "decode_exact": True,
          "entropy_scan_exact": True})

    gopt_files, launches, plain, first_s, walls = drive(
        g16, ("k1_gray", "block_pack", "seg_merge"), 3, optimize=True)
    gray_opt_launches = dict(launches)
    check_optimized(gopt_files, gfiles, gzz16_np, glay, 1, "gray optimize")
    split_of_optimize(gplan, g16)                        # warm
    emit({"phase": "encode_batch_gray_optimize", "frames": len(gopt_files),
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4),
          **rates(walls, len(gopt_files)),
          "bpp": same_bpp("gray_optimize", bpp(gopt_files)),
          "bpp_standard_tables": bpp(gfiles),
          "split": split_of_optimize(gplan, g16),
          "profile": busy(g16, optimize=True),
          "decode_exact": True, "entropy_scan_exact": True})

    # --- phase 9: every kernel against its plain version, then its time, at
    # the paths' shapes (B=16, w_blk=8) ---------------------------------------
    n_img = len(imgs16)

    def hold_pack(x, kops, ktabs, what):
        """A fused kernel (K1A, gray K1A) against its plain version on the
        same B=16 input: the coefficients under the knife-edge policy, the
        packed words and bits exactly equal to the plain entropy coding of
        the kernel's coefficients, and the whole plain version's output
        exactly where no coefficient differs. Returns (buf, bits, zz, max
        coefficient error)."""
        buf, bits, zz = k1a_fused.fused_pixels_to_pack(x, *kops, ktabs, 8,
                                                       return_zz=True)
        err, frac = knife_edge(zz, k1a_fused.transform_plain(x, *kops),
                               f"{what} zz vs plain, B=16")
        ebuf, ebits = k1a_fused.entropy_plain(zz.to(torch.int32), kops[0],
                                              ktabs, 8)
        if not (torch.equal(ebuf, buf) and torch.equal(ebits, bits)):
            fail(f"{what} entropy half != entropy_plain(kernel zz), B=16")
        if frac == 0.0:
            pbuf, pbits = k1a_fused.pixels_to_pack_plain(x, *kops, ktabs, 8)
            if not (torch.equal(pbuf, buf) and torch.equal(pbits, bits)):
                fail(f"{what} != pixels_to_pack_plain, B=16")
        return buf, bits, zz, err

    def only_knife_edges(zz, x, kops, what):
        """A kernel of the shared transform (colour or gray) against its
        plain version: the knife-edge policy, and a coefficient may differ
        only where the float64 value of the same function lies within 1e-4
        of a rounding boundary. Returns (max |diff|, coefficients that
        differ)."""
        plain = k1_dct.transform_plain(x, *kops)
        z = zz[:, :kops[0].n_scan].reshape(plain.shape).to(torch.int32)
        err, _ = knife_edge(z, plain, what)
        d = z != plain
        n = int(d.sum())
        if n:
            exact = k1_dct.scaled_coefficients(x, *kops, dtype=torch.float64)
            dist = ((exact - exact.floor()) - 0.5).abs()
            if not bool((dist[d] < 1e-4).all()):
                fail(f"{what}: differs away from a float64 rounding boundary")
        return err, n

    b16, bits16, zz16_again, k1a_err = hold_pack(x16, ops, tabs, "K1A")
    if not torch.equal(zz16_again, zz16):
        fail("K1A zz differs between two launches at B=16")
    del zz16_again
    k1_err, k1_differing = only_knife_edges(zz16_k1, x16, ops,
                                            "K1 zz vs plain, B=16")
    _, _, gzz16a, gk1a_err = hold_pack(g16, gops, gtabs, "gray K1A")
    if not torch.equal(gzz16a, gzz16):
        fail("gray K1 zz != gray K1A zz at B=16")
    del gzz16a
    gk1_err, gk1_differing = only_knife_edges(gzz16, g16, gops,
                                              "gray K1 zz vs plain, B=16")

    k1a_ms = sync_ms(lambda: k1a_fused.fused_pixels_to_pack(x16, *ops, tabs,
                                                            8), 10)
    k1a_plain_ms = sync_ms(lambda: k1a_fused.pixels_to_pack_plain(
        x16, *ops, tabs, 8), 2)
    k1_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(x16, *ops), 10)
    k1_plain_ms = sync_ms(lambda: k1_dct.pixels_to_scan_plain(x16, *ops), 3)
    gk1a_ms = sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
        g16, *gops, gtabs, 8), 20)
    gk1a_plain_ms = sync_ms(lambda: k1a_fused.pixels_to_pack_plain(
        g16, *gops, gtabs, 8), 2)
    gk1_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(g16, *gops), 20)
    gk1_plain_ms = sync_ms(lambda: k1_dct.pixels_to_scan_plain(g16, *gops), 3)

    # the other samplings of the shared transform, for the record
    sampling_ms = {}
    for sub_ in ("422", "444"):
        pl_ = engine.get_plan(H, W, sub_, Q, "cuda")
        kops_ = (pl_.layout, pl_.kdct, pl_.q)
        sampling_ms[sub_] = {
            "k1_rows": round(sync_ms(lambda: k1_dct.fused_pixels_to_scan(
                x16, *kops_, variant="rows"), 10), 4),
            "k1a": round(sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
                x16, *kops_, tabs, 8), 10), 4)}

    # the merge tail (EncodePlan.merge: kernel B, the compaction, ovf) at
    # the fused path's shapes: by CUDA events, and its device time and
    # kernels per call under torch.profiler
    need16, _ = hold_merge(b16, bits16, lay, cap_w, 8, "16 frames")
    seg_err = 0
    seg_prefix_words = int(need16.clamp(max=cap_w).sum())

    def tail():
        return plan.merge(b16, bits16, cap_w * 4, 8)

    def tail_plain():
        return seg_merge.merge_plain(b16, bits16, lay.n_segments, 8, cap_w,
                                     plan.walign)

    seg_ms = sync_ms(tail, 20)
    seg_plain_ms = sync_ms(tail_plain, 5)
    seg_dev = device_profile(tail, 10)

    # kernel A at the optimize path's shapes: per-image tables, w_blk 8
    dcdiff16 = block_pack.slot_metadata(plan.prev_same, zz16_k1)
    hist16 = entropy.symbol_histogram(zz16_k1, dcdiff16, *slot_plan)
    _, opt_tabs16 = plan.optimized_tables(hist16)

    def a_kernel():
        return block_pack.fused_block_pack(zz16_k1, dcdiff16, *slot_plan,
                                           opt_tabs16, 8)

    def a_plain():
        return block_pack.pack_blocks_plain(
            zz16_k1.reshape(-1, 64), dcdiff16.reshape(-1),
            plan.ac_tab.repeat(n_img), opt_tabs16, 8,
            img=torch.arange(n_img, device=dev).repeat_interleave(
                zz16_k1.shape[1]))

    abuf, abits = a_kernel()
    pbuf, pbits = a_plain()
    a_err = int((abuf.reshape(-1, 8).to(torch.int64)
                 - pbuf.to(torch.int64)).abs().max())
    if a_err or not torch.equal(abits.reshape(-1), pbits):
        fail("kernel A != pack_blocks_plain with per-image tables, B=16")
    del abuf, abits, pbuf, pbits
    a_ms = sync_ms(a_kernel, 20)
    a_plain_ms = sync_ms(a_plain, 2)
    # kernel A's worst case at the same shapes: every AC coefficient nonzero
    # (|v| 1..1023), DC differences up to +-2046, standard tables; exact at
    # w_blk 8 (every block overflows it) and 56, timed at 56
    rng_d = np.random.default_rng(5)
    mag = rng_d.integers(1, 1024, tuple(zz16_k1.shape), dtype=np.int16)
    dense = torch.from_numpy(mag * rng_d.choice(
        np.array([-1, 1], np.int16), mag.shape)).to(dev)
    dense[..., 0] = torch.from_numpy(rng_d.integers(
        -1023, 1024, tuple(zz16_k1.shape[:2]), dtype=np.int16)).to(dev)
    ddc = block_pack.slot_metadata(plan.prev_same, dense)
    for w_blk in (8, 56):
        abuf, abits = block_pack.fused_block_pack(dense, ddc, *slot_plan,
                                                  tabs, w_blk)
        pbuf, pbits = block_pack.pack_blocks_plain(
            dense.reshape(-1, 64), ddc.reshape(-1), plan.ac_tab.repeat(n_img),
            tabs, w_blk, dctab=plan.dc_tab.repeat(n_img),
            valid=plan.valid.repeat(n_img))
        if not (torch.equal(abits.reshape(-1), pbits)
                and torch.equal(abuf.reshape(-1, w_blk), pbuf)):
            fail(f"kernel A != pack_blocks_plain, all-nonzero, w_blk={w_blk}")
        if w_blk == 8 and int(abits.min()) <= 256:
            fail("a block of the all-nonzero input fits w_blk 8")
        del abuf, pbuf, pbits
    a_dense_ms = sync_ms(lambda: block_pack.fused_block_pack(
        dense, ddc, *slot_plan, tabs, 56), 10)
    a_dense_bits = int(abits.to(torch.int64).sum())
    del dense, ddc, abits
    # the histogram kernel at the optimize path's shapes against its plain
    # version: every count equal
    hist_plain16 = symbol_hist.histogram_plain(zz16_k1, dcdiff16, *slot_plan)
    hist_differing = int((hist16 != hist_plain16).sum())
    if hist_differing:
        fail(f"symbol histogram kernel != histogram_plain in "
             f"{hist_differing} bins, B=16")
    del hist_plain16
    hist_ms = sync_ms(lambda: entropy.symbol_histogram(
        zz16_k1, dcdiff16, *slot_plan), 20)
    hist_plain_ms = sync_ms(lambda: symbol_hist.histogram_plain(
        zz16_k1, dcdiff16, *slot_plan), 5)
    hist_ptxas = tile_sweep.ptxas_report(build.build_log,
                                         ("symbol_hist_kernel",))
    if any("0 bytes spill stores, 0 bytes spill loads" not in ln
           for ln in hist_ptxas):
        fail(f"the histogram kernel spills: {hist_ptxas}")
    torch.cuda.synchronize()

    # --- phase 10: the reconstruction kernels against their plain version ---
    # on the coefficients K1 / gray K1 made from the 16 frames (scan order IS
    # the MCU-major layout), and at one small odd geometry per mode
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: recon_plain's matmul would be the side that is "
             "wrong")

    def scan_input(pl, x):
        """(layout, x4 [B, my, mx, L] int16, q_rows [B, L] f32) on the card,
        from K1's coefficients of x and the plan's quant tables."""
        lay_ = pl.layout
        zz = k1_dct.fused_pixels_to_scan(x, lay_, pl.kdct, pl.q)
        qs = [qt[0]] if lay_.is_gray else [qt[0], qt[1], qt[1]]
        q_rows = np.repeat(decoder._q_rows(lay_, qs), x.shape[0], axis=0)
        return (lay_, zz.reshape(x.shape[0], lay_.mcus_y, lay_.mcus_x, -1),
                torch.from_numpy(q_rows).to(dev))

    def pixel_edge(a, b, what):
        d = (a.to(torch.int16) - b.to(torch.int16)).abs()
        mx, frac = int(d.max()), float((d > 0).double().mean())
        if mx > 1 or frac >= PIXEL_FRAC:
            fail(f"{what}: max |diff| {mx}, mismatch fraction {frac:.2e}")
        return mx, frac

    def nearer_to_float64(out, plain, ref):
        """Where kernel and plain version differ on one frame: how often
        each is the nearer one to the float64 reference."""
        o, p = out.cpu().numpy().astype(int), plain.cpu().numpy().astype(int)
        differ = o != p
        dk, dp = np.abs(o - ref)[differ], np.abs(p - ref)[differ]
        return {"bytes_differing": int(differ.sum()),
                "kernel_nearer": int((dk < dp).sum()),
                "plain_nearer": int((dp < dk).sum())}

    recon_in, recon_out, recon_err = {}, {}, {}
    small = fixtures.synth_batch(61, 130, 3)
    for mode in ("420", "422", "444", "gray"):
        xin = g16 if mode == "gray" else x16
        pl = engine.get_plan(H, W, mode, Q, "cuda")
        lay_, x4_, q_ = scan_input(pl, xin)
        out = recon.fused_recon_rgb(x4_, q_, lay_)
        torch.cuda.synchronize()
        plain_px = recon.recon_plain(x4_, q_, lay_)
        mx_, frac = pixel_edge(out, plain_px, f"recon {mode} vs plain")
        # frame 0 against the float64 reference (limit 3, the reference's)
        t0 = time.perf_counter()
        blocks0 = raster(x4_[0].cpu().numpy().astype(np.int32), lay_)
        ref0 = ref_decoder.reconstruct_ref(
            lay_, blocks0, [qt[0]] if lay_.is_gray else [qt[0], qt[1], qt[1]])
        ref_s = time.perf_counter() - t0
        # the function that carries a reference decode across gives this
        # kernel input back from the raster blocks and the tables by id
        cx, cq = decoder.coefficients_from_reference(
            lay_, blocks0, {0: qt[0], 1: qt[1]})
        if not (torch.equal(cx.to(dev), x4_[:1])
                and torch.equal(cq.to(dev), q_[:1])):
            fail(f"coefficients_from_reference {mode} != the kernel's input")
        d64 = {}
        for side, px in (("kernel", out), ("plain", plain_px)):
            d64[side] = int(np.abs(px[0].cpu().numpy().astype(int)
                                   - ref0.astype(int)).max())
            if d64[side] > 3:
                fail(f"recon {mode} {side} vs float64: max |diff| "
                     f"{d64[side]}")
        nearer = nearer_to_float64(out[0], plain_px[0], ref0.astype(int))
        del plain_px
        # one small odd geometry: mcus_x = 9 for 4:2:0, last MCU row cropped
        xs_ = torch.from_numpy(small[..., 1].copy() if mode == "gray"
                               else small).to(dev)
        spl = engine.get_plan(61, 130, mode, Q, "cuda")
        slay, sx4, sq = scan_input(spl, xs_)
        smx, sfrac = pixel_edge(recon.fused_recon_rgb(sx4, sq, slay),
                                recon.recon_plain(sx4, sq, slay),
                                f"recon {mode} 61x130 vs plain")
        recon_in[mode], recon_out[mode] = (lay_, x4_, q_), out
        recon_err[mode] = mx_
        emit({"phase": "recon", "mode": mode, "vs_plain_max_abs": mx_,
              "vs_plain_mismatch_frac": frac, "odd_61x130_max_abs": smx,
              "odd_61x130_mismatch_frac": sfrac,
              "vs_float64_max_abs": d64, "where_they_differ": nearer,
              "reconstruct_ref_s": round(ref_s, 2)})
    # the bench input's sparsity as the products see it: a warp walks the
    # union of its 8 blocks' nonzero coefficients
    bench_terms = {m: recon.product_terms(recon_in[m][1], recon_in[m][0])
                   for m in ("420", "gray")}
    emit({"phase": "recon_bench_terms", **bench_terms})
    # the same shapes with every coefficient nonzero (+-1..3, quant 4..12):
    # the products with no term left out
    dense_in = {}
    for mode in ("420", "gray"):
        lay_ = recon_in[mode][0]
        dx, dqt = fixtures.dense_coefficients(
            n_img, lay_.mcus_y, lay_.mcus_x, lay_.blocks_per_mcu * 64, 6)
        per_comp = [dqt[0]] if lay_.is_gray else [dqt[0], dqt[1], dqt[1]]
        dx4 = torch.from_numpy(dx).to(dev)
        dq = torch.from_numpy(np.repeat(decoder._q_rows(lay_, per_comp),
                                        n_img, axis=0)).to(dev)
        out = recon.fused_recon_rgb(dx4, dq, lay_)
        torch.cuda.synchronize()
        mx_, frac = pixel_edge(out, recon.recon_plain(dx4, dq, lay_),
                               f"recon {mode} all-nonzero vs plain")
        ref0 = ref_decoder.reconstruct_ref(
            lay_, raster(dx[0].astype(np.int32), lay_), per_comp)
        d64 = int(np.abs(out[0].cpu().numpy().astype(int)
                         - ref0.astype(int)).max())
        if d64 > 3:
            fail(f"recon {mode} all-nonzero vs float64: max |diff| {d64}")
        terms = recon.product_terms(dx4, lay_)
        if terms["terms_per_sample"] != 64:
            fail(f"recon {mode} all-nonzero input has zeros: {terms}")
        dense_in[mode] = (lay_, dx4, dq)
        emit({"phase": "recon_all_nonzero", "mode": mode,
              "shape": list(dx4.shape), "vs_plain_max_abs": mx_,
              "vs_plain_mismatch_frac": frac, "vs_float64_max_abs": d64,
              "clamped_frac": float(((out == 0) | (out == 255))
                                    .double().mean())})
        del out, dx
    recon_out = {m: recon_out[m] for m in ("420", "gray")}
    for m in ("422", "444"):
        del recon_in[m]

    # --- phase 11: the decode paths through the API --------------------------
    def drive_decode(files, mode, src, what):
        """decode_batch as one batch, in chunks of 4, and decode of one
        file, each between a counter reset and a read; pixels must equal
        the kernel's on the encoder's own coefficients exactly."""
        name = "recon_gray" if mode == "gray" else "recon"
        want = recon_out[mode]

        def counted(fn, n_expect, label):
            reset_counters()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, plain = read_counters()
            ran = {k: v for k, v in launches.items() if v}
            if ran != {name: n_expect} or plain or decoder.unfused_calls:
                fail(f"decode {what} {label}: launches {launches} (expected "
                     f"{name}: {n_expect}), plain calls {plain}, unfused "
                     f"{decoder.unfused_calls}")
            return out, launches, wall

        batch, launches, first_s = counted(
            lambda: api.decode_batch(files, to_device=True), 1, "batch")
        if not (batch.is_cuda and batch.dtype == torch.uint8
                and torch.equal(batch, want)):
            fail(f"decode_batch {what} != kernel(encoder coefficients)")
        chunks, launches4, _ = counted(
            lambda: api.decode_batch(files, to_device=True, chunk=4), 4,
            "chunk=4")
        if not (isinstance(chunks, list) and len(chunks) == 4
                and torch.equal(torch.cat(chunks), want)):
            fail(f"decode_batch {what} chunk=4 != kernel(encoder "
                 "coefficients)")
        one, launches1, one_s = counted(
            lambda: api.decode(files[0], to_device=True), 1, "decode")
        if not torch.equal(one, want[0]):
            fail(f"decode {what} != kernel(encoder coefficients)")
        host = api.decode_batch(files[:2])
        if not all(isinstance(a, np.ndarray) and np.array_equal(
                a, want[i].cpu().numpy()) for i, a in enumerate(host)):
            fail(f"decode_batch {what} to_device=False differs")
        lay_ = recon_in[mode][0]
        zz_np = gzz16_np if mode == "gray" else zz16_np
        for i, data in enumerate(files):
            lay2, blocks, _ = decoder.decode_to_coefficients(data)
            if lay2 is not lay_ or not np.array_equal(blocks,
                                                  raster(zz_np[i], lay_)):
                fail(f"decode_to_coefficients {what} file {i} != K1 zz")
        db = [psnr(batch[i].cpu().numpy(), src[i]) for i in range(len(files))]
        if min(db) < PSNR_FLOOR:
            fail(f"decode {what}: PSNR {min(db):.2f} dB under the floor")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.decode_batch(files, to_device=True)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        emit({"phase": f"decode_batch_{what}", "frames": len(files),
              "launches": launches, "launches_chunk4": launches4,
              "launches_decode": launches1, "plain_calls": 0,
              "pixels_equal_kernel_on_encoder_coefficients": True,
              "coefficients_exact": True,
              "psnr_db_min": round(min(db), 3),
              "psnr_db_mean": round(float(np.mean(db)), 3),
              "first_call_s": round(first_s, 4),
              "decode_one_s": round(one_s, 4),
              **rates(walls, len(files))})
        return launches

    dec_launches = drive_decode(files, "420", imgs16, "standard")
    dec_opt_launches = drive_decode(opt_files, "420", imgs16, "optimized")
    dec_gray_launches = drive_decode(gfiles, "gray", gray16, "gray")

    # --- phase 12: a restart-interval file, a file with escapes, 4:1:1 -------
    def decode_small(data, what, need_exceptions=False):
        parsed = parser.parse_jpeg(data)
        lay_ = decoder.layout_from_parsed(parsed)
        pk = decoder.scan_packed(parsed, lay_)
        if pk is None:
            fail(f"{what}: no packed stream from the native decoder")
        if need_exceptions and not pk[1].size:
            fail(f"{what}: the exception list is empty")
        reset_counters()
        out = api.decode(data, to_device=True)
        launches, plain = read_counters()
        if launches["recon"] != 1 or plain:
            fail(f"{what}: launches {launches}, plain calls {plain}")
        # the kernel-vs-plain limit against the same decode on the CPU (the
        # plain version); against float64 the reference's own limit of 3:
        # where ideal arithmetic gives a tie (a flat block's DC * q / 8 on
        # x.5), float32 breaks it either way, in every float32 version
        mx_, frac = pixel_edge(
            out, torch.from_numpy(api.decode(data, device="cpu")).to(dev),
            f"{what} vs the CPU decode")
        d64 = (out.cpu().numpy().astype(int)
               - ref_decoder.exact_decode(data).astype(int))
        if np.abs(d64).max() > 3:
            fail(f"{what} vs exact_decode: max |diff| {np.abs(d64).max()}")
        emit({"phase": "decode_" + what, "segments": lay_.n_segments,
              "exceptions": int(pk[1].size), "vs_cpu_decode_max_abs": mx_,
              "vs_cpu_decode_mismatch_frac": frac,
              "vs_exact_decode_max_abs": int(np.abs(d64).max()),
              "vs_exact_decode_mismatch_frac":
                  round(float((d64 != 0).mean()), 6)})

    decode_small(ref_encoder.encode(fixtures.synth_frame(120, 136), Q, "420",
                                    restart_interval=2), "dri")
    two_level = (np.random.default_rng(1).integers(0, 2, (96, 128, 3))
                 * 255).astype(np.uint8)
    decode_small(ref_encoder.encode(two_level, 95, "420"), "escapes",
                 need_exceptions=True)

    lay411 = make_layout(64, 96, "411")
    zz411 = ref_encoder.image_to_zigzag(fixtures.synth_frame(64, 96), lay411,
                                        [qt[0], qt[1], qt[1]])
    reset_counters()
    px411 = decoder.reconstruct_pixels(lay411, zz411, {0: qt[0], 1: qt[1]},
                                       to_device=True)
    launches, plain = read_counters()
    if any(launches.values()) or plain or decoder.unfused_calls != 1:
        fail(f"4:1:1: launches {launches}, plain {plain}, unfused "
             f"{decoder.unfused_calls}")
    d411 = int(np.abs(px411.cpu().numpy().astype(int) - ref_decoder
                      .reconstruct_ref(lay411, zz411, {0: qt[0], 1: qt[1]})
                      .astype(int)).max())
    if not px411.is_cuda or d411 > 3:
        fail(f"4:1:1 vs float64: max |diff| {d411}")
    emit({"phase": "decode_411", "kernel_launches": 0, "unfused_calls": 1,
          "vs_float64_max_abs": d411})

    # --- phase 13: the decode path's times ------------------------------------
    def decode_times(files, mode):
        """The device half alone (stage_recon's run() by CUDA events), the
        densify alone, the host half alone, and the walls."""
        lay_, x4_, q_ = recon_in[mode]
        mpix = len(files) * H * W / 1e6
        out = {}
        for chunk in (None, 4):
            run, h2d = decoder.stage_recon(files, chunk=chunk)
            ms = sync_ms(run, 10)
            out[f"device_ms_chunk_{chunk}"] = round(ms, 4)
            out[f"device_mpix_per_s_chunk_{chunk}"] = round(mpix / ms * 1e3, 1)
        out["h2d_bytes"] = h2d
        job = decoder._recon_jobs(files, None)[1][0]()
        arrays, _ = decoder._upload(job, dev)
        out["upload_form"] = job.form
        out["densify_ms"] = round(sync_ms(lambda: decoder._densify(
            lay_, job.form, arrays, job.nb), 10), 4)
        # the host half, in its parts: marker parse alone, parse + entropy
        # decode (8 threads over the files), the chunk-flat stream (numpy),
        # then the upload and, for to_device=False, the download; and one
        # file's entropy decode on one thread
        parse, entropy_, flatten, up, down, one = [], [], [], [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            parsed = [parser.parse_jpeg(d) for d in files]
            t1 = time.perf_counter()
            thunk = decoder._recon_jobs(files, None)[1][0]
            t2 = time.perf_counter()
            job = thunk()
            t3 = time.perf_counter()
            decoder._upload(job, dev)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            recon_out[mode].cpu()
            t5 = time.perf_counter()
            decoder.scan_packed(parsed[0], lay_, n_threads=1)
            one.append(time.perf_counter() - t5)
            parse.append(t1 - t0)
            entropy_.append(t2 - t1)
            flatten.append(t3 - t2)
            up.append(t4 - t3)
            down.append(t5 - t4)

        def ms(ts):
            return [round(1e3 * t, 3) for t in ts]
        out.update({"parse_ms": ms(parse), "parse_and_entropy_ms": ms(entropy_),
                    "flatten_ms": ms(flatten), "upload_ms": ms(up),
                    "download_ms": ms(down),
                    "entropy_one_file_one_thread_ms": ms(one)})
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.decode_batch(files)
            walls.append(time.perf_counter() - t0)
        out["to_host"] = rates(walls, len(files))
        return out

    emit({"phase": "decode_times", "standard": decode_times(files, "420"),
          "gray": decode_times(gfiles, "gray")})
    lay_, x4_, q_ = recon_in["420"]
    recon_ms = sync_ms(lambda: recon.fused_recon_rgb(x4_, q_, lay_), 20)
    recon_plain_ms = sync_ms(lambda: recon.recon_plain(x4_, q_, lay_), 3)
    glay_, gx4_, gq_ = recon_in["gray"]
    grecon_ms = sync_ms(lambda: recon.fused_recon_rgb(gx4_, gq_, glay_), 20)
    grecon_plain_ms = sync_ms(lambda: recon.recon_plain(gx4_, gq_, glay_), 3)
    dlay_, dx4_, dq_ = dense_in["420"]
    recon_dense_ms = sync_ms(lambda: recon.fused_recon_rgb(dx4_, dq_, dlay_),
                             20)
    gdlay_, gdx4_, gdq_ = dense_in["gray"]
    grecon_dense_ms = sync_ms(
        lambda: recon.fused_recon_rgb(gdx4_, gdq_, gdlay_), 20)
    torch.cuda.synchronize()

    # --- phase 14: restart intervals -----------------------------------------
    def decode_any(data, layout):
        """Parse a file and scan-decode it with ITS OWN tables, for any
        geometry; the header must carry the layout's."""
        p = parser.parse_jpeg(data)
        if (p.height, p.width, p.subsampling, p.restart_interval) != (
                layout.height, layout.width, layout.subsampling,
                layout.restart_interval):
            fail(f"file header {p.height}x{p.width} {p.subsampling} DRI "
                 f"{p.restart_interval}")
        coef = native.decode_scan(
            p.scan_data, layout, [c.dc_tab for c in p.comps],
            [c.ac_tab for c in p.comps],
            [p.dc_tables.get(i) for i in range(2)],
            [p.ac_tables.get(i) for i in range(2)])
        if coef is None:
            fail("the native scan decoder is unavailable (no g++?)")
        return p, coef

    def check_rst(p, layout, what):
        """RSTn count and numbering (mod 8) of a parsed file's scan. A
        stuffed scan holds FF only before 00 or a marker."""
        sd = np.frombuffer(p.scan_data, np.uint8)
        nxt = sd[1:][sd[:-1] == 0xFF]
        got = nxt[nxt != 0].tolist()
        want = [0xD0 + (i & 7) for i in range(layout.n_segments - 1)]
        if got != want:
            fail(f"{what}: {len(got)} RSTn markers, expected {len(want)} "
                 "numbered mod 8")

    def check_dri_files(dfiles, layout, zz_np, want_px, what):
        """Headers, RSTn, coefficients equal K1's, and decode_batch on the
        card gives the recon kernel's pixels on the encoder's coefficients."""
        for i, data in enumerate(dfiles):
            p, coef = decode_any(data, layout)
            check_rst(p, layout, f"{what} file {i}")
            if not np.array_equal(coef, raster(zz_np[i], layout)):
                fail(f"{what} file {i}: decoded coefficients != K1 zz")
        px = api.decode_batch(dfiles, to_device=True)
        if not torch.equal(px, want_px):
            fail(f"{what}: decode_batch != kernel(encoder coefficients)")

    DRI, GDRI = 120, 240
    dplan = engine.get_plan(H, W, "420", Q, "cuda", DRI)
    dlay = dplan.layout
    dops = (dlay, dplan.kdct, dplan.q)
    dbuf, dbits, dzz = k1a_fused.fused_pixels_to_pack(x4, *dops, tabs, 8,
                                                      return_zz=True)
    torch.cuda.synchronize()
    if not torch.equal(dzz, zz16[:4]):
        fail("K1A zz changed with the restart interval")
    pbuf, pbits = k1a_fused.pixels_to_pack_plain(x4, *dops, tabs, 8)
    dri_plain_equal = torch.equal(
        zz16[:4].to(torch.int32), k1a_fused.transform_plain(x4, *dops))
    if dri_plain_equal and not (torch.equal(pbuf, dbuf)
                                and torch.equal(pbits, dbits)):
        fail("K1A with DRI != pixels_to_pack_plain")
    ebuf, ebits = k1a_fused.entropy_plain(dzz.to(torch.int32), dlay, tabs, 8)
    if not (torch.equal(ebuf, dbuf) and torch.equal(ebits, dbits)):
        fail("K1A with DRI: entropy half != entropy_plain(kernel zz)")
    if torch.equal(dbits, k1a_out_bits8):
        fail("the restart interval did not change K1A's bit counts")

    # K1A's time with and without the restart interval, in turns in one
    # window; and with the restart layout on the other plan's operand
    # tensors, which tells the layout's effect from the operands' placement
    def k1a_time(layout, pl):
        return sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
            x16, layout, pl.kdct, pl.q, tabs, 8), 10)

    k1a_turns = {"no_dri": [k1a_time(lay, plan)],
                 "dri": [k1a_time(dlay, dplan)],
                 "dri_layout_on_no_dri_operands": [k1a_time(dlay, plan)],
                 "no_dri_layout_on_dri_operands": [k1a_time(lay, dplan)]}
    for key, (l_, p_) in (("dri", (dlay, dplan)), ("no_dri", (lay, plan))):
        k1a_turns[key].append(k1a_time(l_, p_))
    k1a_turns = {k: [round(t, 4) for t in v] for k, v in k1a_turns.items()}

    dri_files, launches, plain, first_s, walls = drive(
        x16, ("k1a_fused", "seg_merge"), 3, restart_interval=DRI)
    dri_launches = dict(launches)
    check_dri_files(dri_files, dlay, zz16_np, recon_out["420"], "DRI 120")
    # the plain path, by hand on the card: plain K1A -> plain kernel B ->
    # compaction -> the same fetch and finalize; files byte for byte
    dcap = engine.scan_caps(dlay, Q, "tight")[0]
    n_dseg = dlay.n_segments
    plain_scans = dplan.finalize(dplan.fetch(seg_merge.merge_plain(
        pbuf, pbits, n_dseg, 8, dcap // 4, dplan.walign), dcap))
    if dri_plain_equal:
        for i, scan in enumerate(plain_scans):
            if scan is None or dri_files[i] != (
                    engine.jfif_headers(dlay, Q) + scan + engine.EOI):
                fail(f"DRI 120 file {i} != the plain path's file")
    emit({"phase": "encode_batch_dri", "restart_interval": DRI,
          "segments": n_dseg, "frames": len(dri_files), "launches": launches,
          "plain_calls": plain, "first_call_s": round(first_s, 4),
          **rates(walls, len(dri_files)), "profile": busy(
              x16, restart_interval=DRI),
          "bpp": same_bpp("dri", bpp(dri_files)),
          "bpp_no_dri": bpp(files), "decode_exact": True,
          "rst_markers_exact": True, "decode_batch_pixels_exact": True,
          "equals_plain_path_files": dri_plain_equal,
          "k1a_ms_in_turns": k1a_turns})

    dri_opt_files, launches, plain, first_s, walls = drive(
        x16, ("k1_dct", "block_pack", "seg_merge"), 3, restart_interval=DRI,
        optimize=True)
    dri_opt_launches = dict(launches)
    check_dri_files(dri_opt_files, dlay, zz16_np, recon_out["420"],
                    "DRI 120 optimize")
    if any(len(a) >= len(b) for a, b in zip(dri_opt_files, dri_files)):
        fail("DRI 120 optimize: a file is not smaller than the standard one")
    emit({"phase": "encode_batch_dri_optimize", "restart_interval": DRI,
          "frames": len(dri_opt_files), "launches": launches,
          "plain_calls": plain, "first_call_s": round(first_s, 4),
          **rates(walls, len(dri_opt_files)),
          "bpp": same_bpp("dri_optimize", bpp(dri_opt_files)),
          "decode_exact": True, "rst_markers_exact": True,
          "decode_batch_pixels_exact": True})

    gdplan = engine.get_plan(H, W, "gray", Q, "cuda", GDRI)
    gdlay = gdplan.layout
    gdops = (gdlay, gdplan.kdct, gdplan.q)
    gdbuf, gdbits, gdzz = k1a_fused.fused_pixels_to_pack(
        g4, *gdops, gtabs, 8, return_zz=True)
    ebuf, ebits = k1a_fused.entropy_plain(gdzz.to(torch.int32), gdlay, gtabs,
                                          8)
    if not (torch.equal(ebuf, gdbuf) and torch.equal(ebits, gdbits)):
        fail("gray K1A with DRI: entropy half != entropy_plain(kernel zz)")
    gdri_files, launches, plain, first_s, walls = drive(
        g16, ("k1a_gray", "seg_merge"), 3, restart_interval=GDRI)
    gdri_launches = dict(launches)
    check_dri_files(gdri_files, gdlay, gzz16_np, recon_out["gray"],
                    "gray DRI 240")
    emit({"phase": "encode_batch_gray_dri", "restart_interval": GDRI,
          "segments": gdlay.n_segments, "frames": len(gdri_files),
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4),
          **rates(walls, len(gdri_files)),
          "bpp": same_bpp("gray_dri", bpp(gdri_files)),
          "decode_exact": True, "rst_markers_exact": True,
          "decode_batch_pixels_exact": True})
    del dbuf, dbits, dzz, pbuf, pbits, gdbuf, gdbits, gdzz

    # small sizes: DRI 1, 3 (short last segment, pad slots), 7 in every
    # mode, odd widths; and the worst tier (w_blk 56) once with DRI
    def small_case(img, mode, quality, what, **kw):
        """api.encode on the card: launches only, the file's coefficients
        equal K1's, the bytes equal the CPU (plain) path's wherever the
        coefficients agree, and it decodes on the card."""
        sub = "420" if mode == "gray" else mode
        dri_ = kw.get("restart_interval", 0)
        reset_counters()
        data = api.encode(img, quality, sub, device="cuda", **kw)
        launches, plain = read_counters()
        if plain or not launches["seg_merge"]:
            fail(f"{what}: launches {launches}, plain calls {plain}")
        pl = engine.get_plan(img.shape[0], img.shape[1], mode, quality,
                             "cuda", dri_)
        lay_ = pl.layout
        p, coef = decode_any(data, lay_)
        check_rst(p, lay_, what)
        same = True
        if kw.get("dct_method", "float") == "float":
            xs_ = torch.from_numpy(img)[None].to(dev)
            zz_ = pl.zz_scan(xs_)[0][0, :lay_.n_scan]
            if not np.array_equal(coef, raster(
                    zz_.cpu().numpy().astype(np.int32), lay_)):
                fail(f"{what}: decoded coefficients != K1 zz")
            cpl = engine.get_plan(img.shape[0], img.shape[1], mode, quality,
                                  "cpu", dri_)
            same = torch.equal(
                cpl.zz_scan(torch.from_numpy(img)[None])[0][0, :lay_.n_scan],
                zz_.cpu())
        if same and data != api.encode(img, quality, sub, device="cpu",
                                       **kw):
            fail(f"{what}: bytes != the CPU (plain) path's")
        if api.decode(data, to_device=True).shape[:2] != img.shape[:2]:
            fail(f"{what}: decode gave another size")
        return data, launches, same

    n_small, n_same = 0, 0
    small_rgb = fixtures.synth_frame(61, 130)
    for mode in ("420", "422", "444", "gray"):
        img_ = small_rgb[..., 1].copy() if mode == "gray" else small_rgb
        for dri_ in (1, 3, 7):
            for opt in (False, True):
                _, _, same = small_case(
                    img_, mode, Q, f"61x130 {mode} DRI {dri_} optimize={opt}",
                    restart_interval=dri_, optimize=opt)
                n_small, n_same = n_small + 1, n_same + int(same)
    noise_small = np.random.default_rng(77).integers(0, 256, (32, 48, 3),
                                                     np.uint8)
    npl = engine.get_plan(32, 48, "444", 100, "cuda", 1)
    safe = engine.tiers_for(npl.layout, 100)[-2]
    if npl.finalize(npl.fetch(
            npl(torch.from_numpy(noise_small)[None].to(dev), *safe),
            safe[0])) != [None]:
        fail("the small noise frame did not overflow the safe tier")
    small_case(noise_small, "444", 100, "32x48 noise Q100 DRI 1 worst tier",
               restart_interval=1)
    emit({"phase": "dri_small", "cases": n_small + 1,
          "bytes_equal_cpu_path": n_same, "worst_tier_with_dri": True})

    # --- phase 15: a wide frame, past the reference's row gate ---------------
    WH, WW = 2048, 16384
    t0 = time.perf_counter()
    wide = np.stack([np.concatenate(
        [fixtures.synth_frame(WH, 2048, seed=100 + 8 * f + t)
         for t in range(8)], axis=1) for f in range(2)])
    wide_gen_s = time.perf_counter() - t0
    xw = torch.from_numpy(wide).to(dev)
    wplan = engine.get_plan(WH, WW, "420", Q, "cuda")
    wlay = wplan.layout
    wops = (wlay, wplan.kdct, wplan.q)
    if k1_dct.k1_variant(wlay) != "repack" or k1_dct.k1_variant(lay) != "rows":
        fail("the row gate does not select the repack variant at 16384 px")

    def drive_wide(expect, **kw):
        reset_counters()
        t0 = time.perf_counter()
        out = mesh.encode_batch(xw, quality=Q, device="cuda", **kw)
        first = time.perf_counter() - t0
        launches, plain = read_counters()
        if {k for k, v in launches.items() if v} != set(expect) or plain:
            fail(f"wide frame {kw}: launches {launches} (expected {expect}), "
                 f"plain calls {plain}")
        ws = []
        for _ in range(2):
            t0 = time.perf_counter()
            if mesh.encode_batch(xw, quality=Q, device="cuda", **kw) != out:
                fail(f"wide frame {kw}: not deterministic")
            ws.append(time.perf_counter() - t0)
        mpix = len(out) * WH * WW / 1e6
        return out, launches, {
            "first_call_s": round(first, 4),
            "wall_s": [round(t, 4) for t in ws],
            "mpix_per_s_best": round(mpix / min(ws), 1),
            "bpp": round(float(np.mean([8 * len(f) / (WH * WW)
                                        for f in out])), 4)}

    wide_opt, launches, wide_opt_stats = drive_wide(
        ("k1_dense_repack", "block_pack", "seg_merge"), optimize=True)
    wide_launches = dict(launches)
    wide_fused, launches, wide_fused_stats = drive_wide(
        ("k1a_fused", "seg_merge"))
    same_bpp("wide_optimize", wide_opt_stats["bpp"])
    same_bpp("wide_fused", wide_fused_stats["bpp"])
    zz_rep = k1_dct.fused_pixels_to_scan(xw, *wops)
    zz_rows = k1_dct.fused_pixels_to_scan(xw, *wops, variant="rows")
    torch.cuda.synchronize()
    if not torch.equal(zz_rep, zz_rows):
        fail("wide frame: repack kernel zz != row kernel zz")
    _, _, zz_wk1a = k1a_fused.fused_pixels_to_pack(xw, *wops, tabs, 8,
                                                   return_zz=True)
    if not torch.equal(zz_wk1a.reshape(-1), zz_rep.reshape(-1)):
        fail("wide frame: K1A zz != repack kernel zz")
    del zz_wk1a
    rep_err, rep_differing = only_knife_edges(
        zz_rep, xw, wops, "wide frame: repack kernel zz vs plain")
    zzw_np = zz_rep.cpu().numpy().astype(np.int32)
    for i in range(len(wide)):
        for what, fs in (("optimize", wide_opt), ("fused", wide_fused)):
            if not np.array_equal(decode_any(fs[i], wlay)[1],
                                  raster(zzw_np[i], wlay)):
                fail(f"wide frame {what} file {i}: decoded coefficients != "
                     "the repack kernel's zz")
    rep16 = k1_dct.fused_pixels_to_scan(x16, *ops, variant="repack")
    if not torch.equal(rep16, zz16_k1):
        fail("repack kernel zz != row kernel zz at 16 x 1080p")
    del rep16, zz_rows
    rep_wide_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        xw, *wops, variant="repack"), 5)
    rows_wide_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        xw, *wops, variant="rows"), 5)
    rep_wide_ms2 = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        xw, *wops, variant="repack"), 5)
    rep_plain_ms = sync_ms(lambda: k1_dct.pixels_to_scan_plain(xw, *wops), 2)
    prologue_wide_ms = sync_ms(
        lambda: k1_dct.mcu_bytes(xw, wlay).contiguous(), 5)
    rep16_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="repack"), 10)
    rows16_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="rows"), 10)
    prologue16_ms = sync_ms(lambda: k1_dct.mcu_bytes(x16, lay).contiguous(),
                            10)
    k1a_wide_ms = sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
        xw, *wops, tabs, 8), 3)
    emit({"phase": "wide_frame", "shape": [len(wide), WH, WW, 3],
          "generate_s": round(wide_gen_s, 2), "launches": wide_launches,
          "plain_calls": 0, "optimize": wide_opt_stats,
          "fused": wide_fused_stats, "repack_equals_rows": True,
          "k1a_equals_repack": True, "zz_vs_plain_max_abs": rep_err,
          "zz_vs_plain_differing": rep_differing,
          "differences_only_at_float64_knife_edges": True,
          "files_decode_to_kernel_zz": True,
          "k1_ms": {"wide_repack": [round(rep_wide_ms, 4),
                                    round(rep_wide_ms2, 4)],
                    "wide_rows": round(rows_wide_ms, 4),
                    "wide_repack_prologue": round(prologue_wide_ms, 4),
                    "wide_plain": round(rep_plain_ms, 4),
                    "wide_k1a": round(k1a_wide_ms, 4),
                    "x16_1080p_repack": round(rep16_ms, 4),
                    "x16_1080p_rows": round(rows16_ms, 4),
                    "x16_1080p_repack_prologue": round(prologue16_ms, 4)}})
    wide_px, wide_slots = xw.numel(), len(wide) * wlay.n_scan
    wide_mcus = len(wide) * wlay.n_mcus
    del xw, zz_rep, zzw_np, wide, wide_opt, wide_fused

    # --- phase 16: the separable K1 kernel (K1_DENSE = False) ----------------
    k1_dct.K1_DENSE = False
    try:
        if k1_dct.k1_variant(lay) != "separable":
            fail("K1_DENSE = False does not select the separable variant")
        sep_files, launches, plain, first_s, walls = drive(
            x16, ("k1_color", "block_pack", "seg_merge"), 3, optimize=True)
        sep_launches = dict(launches)
        sep_profile = busy(x16, optimize=True)
    finally:
        k1_dct.K1_DENSE = True
    zz_sep = k1_dct.fused_pixels_to_scan(x16, *ops, variant="separable",
                                         sep=plan.sep)
    torch.cuda.synchronize()
    sep_plain = k1_dct.color_plain(x16, lay, plan.sep, plan.q)
    d_sep = zz_sep != sep_plain
    sep_err = int((zz_sep.to(torch.int32) - sep_plain.to(torch.int32))
                  .abs().max())
    sep_n = int(d_sep.sum())
    if sep_err > 1 or sep_n > 1e-3 * d_sep.numel():
        fail(f"separable kernel vs color_plain: max |diff| {sep_err} on "
             f"{sep_n} coefficients")
    if sep_n:
        # they may differ only where the float64 value lies within 1e-4 of a
        # rounding boundary
        nb_ = lay.blocks_per_mcu - 2
        pl64 = k1_dct.mcu_planar(x16, lay).double()
        r_, g_, b_ = pl64[:, :, 0], pl64[:, :, 1], pl64[:, :, 2]
        y_ = 0.299 * r_ + 0.587 * g_ + 0.114 * b_ - 128.0
        cb_ = -0.168735892 * r_ + -0.331264108 * g_ + 0.5 * b_
        cr_ = 0.5 * r_ + -0.418687589 * g_ + -0.081312411 * b_
        kd_, sc_ = plan.sep[:64].double(), plan.sep[64:].double()
        exact = torch.cat(
            [(y_.reshape(*y_.shape[:2], nb_, 64) @ kd_).flatten(2),
             cb_ @ sc_, cr_ @ sc_], dim=-1) / plan.q.double()
        dist = ((exact - exact.floor()) - 0.5).abs().reshape(zz_sep.shape)
        if not bool((dist[d_sep] < 1e-4).all()):
            fail("separable kernel differs from color_plain away from a "
                 "float64 rounding boundary")
        del pl64, r_, g_, b_, y_, cb_, cr_, exact, dist
    d_k1 = (zz_sep.to(torch.int32) - zz16_k1.to(torch.int32)).abs()
    sep_vs_k1_max = int(d_k1.max())
    sep_vs_k1_frac = float((d_k1 > 0).double().mean())
    if sep_vs_k1_max > 1 or sep_vs_k1_frac > max(KNIFE_EDGE_FRAC,
                                                 2.0 / d_k1.numel()):
        fail(f"separable kernel vs K1: max |diff| {sep_vs_k1_max}, fraction "
             f"{sep_vs_k1_frac:.2e}")
    zz_sep_np = zz_sep.cpu().numpy().astype(np.int32)
    for i, data in enumerate(sep_files):
        if not np.array_equal(decode(data)[1], raster(zz_sep_np[i])):
            fail(f"separable file {i}: decoded coefficients != kernel zz")
    sep_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="separable", sep=plan.sep), 10)
    k1_again_ms = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="rows"), 10)
    k1a_again_ms = sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
        x16, *ops, tabs, 8), 10)
    sep_ms2 = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="separable", sep=plan.sep), 10)
    k1_again_ms2 = sync_ms(lambda: k1_dct.fused_pixels_to_scan(
        x16, *ops, variant="rows"), 10)
    k1a_again_ms2 = sync_ms(lambda: k1a_fused.fused_pixels_to_pack(
        x16, *ops, tabs, 8), 10)
    sep_plain_ms = sync_ms(lambda: k1_dct.color_plain(x16, lay, plan.sep,
                                                      plan.q), 3)
    # 4:2:2 and 4:4:4 at 1080p: the separable kernel in turns with K1 rows
    sep_sampling_ms = {}
    for sub_ in ("422", "444"):
        pl_ = engine.get_plan(H, W, sub_, Q, "cuda")
        kops_ = (pl_.layout, pl_.kdct, pl_.q)
        t_ = [sync_ms(lambda: k1_dct.fused_pixels_to_scan(
            x16, *kops_, variant=v_, sep=pl_.sep), 10)
            for v_ in ("separable", "rows", "rows", "separable")]
        sep_sampling_ms[sub_] = {"separable": [round(t_[0], 4),
                                               round(t_[3], 4)],
                                 "k1_rows": [round(t_[1], 4),
                                             round(t_[2], 4)]}
    # registers and spills of its three instantiations (phase 1 fails on
    # any spill)
    sep_ptxas = tile_sweep.ptxas_report(build.build_log, ("k1_color_kernel",))
    emit({"phase": "encode_batch_separable", "frames": len(sep_files),
          "launches": sep_launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4), **rates(walls, len(sep_files)),
          "profile": sep_profile,
          "bpp": same_bpp("separable", bpp(sep_files)),
          "vs_color_plain_max_abs": sep_err,
          "vs_color_plain_differing": sep_n,
          "differences_only_at_float64_knife_edges": True,
          "vs_k1_max_abs": sep_vs_k1_max,
          "vs_k1_mismatch_frac": sep_vs_k1_frac,
          "files_decode_to_kernel_zz": True,
          "ms": [round(sep_ms, 4), round(sep_ms2, 4)],
          "ms_422_444": sep_sampling_ms, "ptxas": sep_ptxas,
          "k1_rows_ms_same_window": [round(k1_again_ms, 4),
                                     round(k1_again_ms2, 4)],
          "k1a_ms_same_window": [round(k1a_again_ms, 4),
                                 round(k1a_again_ms2, 4)]})
    del zz_sep, sep_plain, d_sep, d_k1, zz_sep_np

    # --- phase 17: islow, the libjpeg-exact integer path ---------------------
    def islow_reference(img, layout, quality, optimize):
        """The numpy encode: ref.islow's coefficients, ref.encoder's coder."""
        qts = list(engine.qtables_for_quality(quality))
        blocks = ref_islow.image_to_zigzag_islow(img, layout, qts)
        if optimize:
            dc_, ac_ = engine.tables_from_freq(
                ref_encoder.symbol_histogram(layout, blocks),
                1 if layout.is_gray else 2)
        else:
            dc_, ac_ = ref_encoder.standard_tables()
        return (engine.jfif_headers(layout, quality, dc_, ac_)
                + ref_encoder.entropy_scan(layout, blocks, dc_, ac_)
                + engine.EOI)

    def islow_case(img, mode, what, n_frames=1, **kw):
        sub = "420" if mode == "gray" else mode
        x_ = torch.from_numpy(np.stack([img] * n_frames)).to(dev)
        reset_counters()
        t0 = time.perf_counter()
        out = mesh.encode_batch(x_, quality=Q, subsampling=sub,
                                dct_method="islow", device="cuda", **kw)
        wall = time.perf_counter() - t0
        launches, plain = read_counters()
        ran = {k for k, v in launches.items() if v}
        if ran != {"block_pack", "seg_merge"} or plain:
            fail(f"islow {what}: launches {launches}, plain calls {plain}")
        lay_ = make_layout(img.shape[0], img.shape[1], mode,
                           kw.get("restart_interval", 0))
        t0 = time.perf_counter()
        ref = islow_reference(img, lay_, Q, kw.get("optimize", False))
        ref_s_ = time.perf_counter() - t0
        if any(f != ref for f in out):
            fail(f"islow {what}: file != ref.islow + ref.encoder")
        if api.encode(img, Q, sub, dct_method="islow", device="cuda",
                      **kw) != ref:
            fail(f"islow {what}: api.encode != encode_batch")
        return launches, wall, ref_s_, len(ref)

    islow_rows = []
    for what, kw in (("1080p standard", {}),
                     ("1080p optimize DRI 120",
                      {"optimize": True, "restart_interval": DRI})):
        launches, wall, ref_s_, nbytes = islow_case(imgs16[0], "420", what,
                                                    **kw)
        islow_launches = dict(launches)
        x1 = x16[:1]
        walls_ = []
        for _ in range(3):
            t0 = time.perf_counter()
            mesh.encode_batch(x1, quality=Q, dct_method="islow",
                              device="cuda", **kw)
            walls_.append(time.perf_counter() - t0)
        islow_rows.append({"case": what, "launches": launches,
                           "first_call_s": round(wall, 4),
                           "wall_s": [round(t, 4) for t in walls_],
                           "mpix_per_s_best": round(
                               H * W / 1e6 / min(walls_), 1),
                           "bpp": same_bpp("islow " + what, round(
                               8 * nbytes / (H * W), 4)),
                           "numpy_reference_s": round(ref_s_, 2)})
    islow_zz_ms = sync_ms(lambda: plan.zz_islow(x16[:1]), 5)
    n_islow = 0
    for mode in ("420", "422", "444", "gray"):
        img_ = small_rgb[..., 1].copy() if mode == "gray" else small_rgb
        for kw in ({}, {"optimize": True}, {"restart_interval": 3},
                   {"optimize": True, "restart_interval": 7}):
            islow_case(img_, mode, f"61x130 {mode} {kw}", n_frames=2, **kw)
            n_islow += 1
    emit({"phase": "islow", "full_width": islow_rows,
          "zz_islow_ms_one_1080p_frame": round(islow_zz_ms, 4),
          "small_cases": n_islow, "bytes_equal_numpy_reference": True,
          "plain_calls": 0})

    # --- phase 18: stage_batch, the pinned side-stream upload ----------------
    t_phase = time.perf_counter()
    reset_counters()
    staged = mesh.stage_batch(imgs16, quality=Q, device="cuda")
    staged_files = mesh.encode_batch(imgs16, quality=Q, device="cuda",
                                     staged=staged)
    launches, plain = read_counters()
    if {k for k, v in launches.items() if v} != {"k1a_fused", "seg_merge"} \
            or plain:
        fail(f"stage_batch path: launches {launches}, plain calls {plain}")
    if not (len(staged[1]) == 1 and staged[1][0][0].is_cuda
            and staged[1][0][0].is_contiguous()
            and isinstance(staged[1][0][1], torch.cuda.Event)):
        fail("stage_batch did not return a device tensor and a CUDA event")
    if staged_files != files:
        fail("files encoded through stage_batch differ from (a)'s")
    stage_walls, numpy_walls = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        mesh.encode_batch(imgs16, quality=Q, device="cuda",
                          staged=mesh.stage_batch(imgs16, quality=Q,
                                                  device="cuda"))
        stage_walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        mesh.encode_batch(imgs16, quality=Q, device="cuda")
        numpy_walls.append(time.perf_counter() - t0)
    emit({"phase": "stage_batch", "frames": len(staged_files),
          "launches": launches, "plain_calls": plain,
          "files_equal_fused_path": True,
          "staged_wall_s": [round(t, 4) for t in stage_walls],
          "numpy_wall_s": [round(t, 4) for t in numpy_walls],
          "seconds": round(time.perf_counter() - t_phase, 1)})

    # --- phase 19: the CLI's batch driver over files --------------------------
    # 32 RGB 1080p PPMs and 4 gray 720p PGMs, chunks of 16: the gray chunk,
    # then two RGB chunks (one shape change), each staged while the one
    # before it encodes. The first run is `python -m jpgenc_tpu_torch batch`
    # through runpy (what -m does) with the launch counters printed at exit;
    # the second is the module itself and must skip every file.
    import os
    import tempfile

    from jpgenc_tpu_torch import io as jio

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    rgb32 = np.concatenate([imgs16, imgs16[:, :, ::-1]])
    gray4 = np.ascontiguousarray(imgs16[:4, :720, :1280, 1])
    want = dict(zip((f"rgb{i:02d}" for i in range(32)),
                    files + mesh.encode_batch(rgb32[16:], quality=Q,
                                              device="cuda")))
    want.update(zip((f"gray{i}" for i in range(4)),
                    mesh.encode_batch(gray4, quality=Q, device="cuda")))
    counted_cli = (
        "import atexit, json, runpy, sys\n"
        "from jpgenc_tpu_torch.ops.cuda import k1a_fused, seg_merge\n"
        "from jpgenc_tpu_torch.ops.cuda import k1_dct, block_pack, recon\n"
        "def report():\n"
        "    mods = (k1a_fused, seg_merge, k1_dct, block_pack, recon)\n"
        "    print('COUNTERS ' + json.dumps({\n"
        "        'k1a_fused': k1a_fused.launches,\n"
        "        'k1a_gray': k1a_fused.launches_gray,\n"
        "        'seg_merge': seg_merge.launches,\n"
        "        'other': k1_dct.launches + k1_dct.launches_gray\n"
        "                 + block_pack.launches + recon.launches,\n"
        "        'plain_calls': sum(m.plain_calls for m in mods)}),\n"
        "        file=sys.stderr)\n"
        "atexit.register(report)\n"
        "sys.argv = ['jpgenc_tpu_torch'] + sys.argv[1:]\n"
        "runpy.run_module('jpgenc_tpu_torch', run_name='__main__',\n"
        "                 alter_sys=True)\n")
    with tempfile.TemporaryDirectory() as tmp:
        src, out = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for name in want:
            idx = int(name[-2:] if name.startswith("rgb") else name[-1])
            arr = rgb32[idx] if name.startswith("rgb") else gray4[idx]
            jio.save(os.path.join(src, name + (".ppm" if arr.ndim == 3
                                               else ".pgm")), arr)
        write_s = time.perf_counter() - t_phase
        args = ["batch", src, out, "--device", "cuda", "--chunk", "16"]
        t0 = time.perf_counter()
        r1 = subprocess.run([sys.executable, "-c", counted_cli, *args],
                            cwd=root, capture_output=True, text=True,
                            timeout=600)
        batch_s = time.perf_counter() - t0
        if r1.returncode != 0:
            fail(f"cli batch exited {r1.returncode}: {r1.stderr[-2000:]}")
        cli_counts = json.loads(
            [ln for ln in r1.stderr.splitlines()
             if ln.startswith("COUNTERS ")][-1].split(" ", 1)[1])
        first = json.loads(r1.stdout.strip().splitlines()[-1])
        if (first["images"], first["done"], first["skipped"]) != (36, 36, 0):
            fail(f"cli batch summary {first}")
        if cli_counts["k1a_fused"] != 2 or cli_counts["k1a_gray"] != 1 \
                or cli_counts["seg_merge"] != 3 or cli_counts["other"] \
                or cli_counts["plain_calls"]:
            fail(f"cli batch launches {cli_counts} (expected 2 K1A, 1 gray "
                 f"K1A, 3 merge tails, nothing else)")
        for name, data in want.items():
            with open(os.path.join(out, name + ".jpg"), "rb") as f:
                if f.read() != data:
                    fail(f"cli batch file {name}.jpg != encode_batch's")
        with open(os.path.join(out, "manifest.jsonl")) as f:
            n_lines = len(f.readlines())
        if n_lines != 36:
            fail(f"manifest has {n_lines} lines, expected 36")
        t0 = time.perf_counter()
        r2 = subprocess.run([sys.executable, "-m", "jpgenc_tpu_torch", *args],
                            cwd=root, capture_output=True, text=True,
                            timeout=600)
        resume_s = time.perf_counter() - t0
        if r2.returncode != 0:
            fail(f"cli batch resume exited {r2.returncode}: "
                 f"{r2.stderr[-2000:]}")
        second = json.loads(r2.stdout.strip().splitlines()[-1])
        if (second["done"], second["skipped"]) != (0, 36):
            fail(f"cli batch resume summary {second}")
        back = os.path.join(tmp, "back.ppm")
        r3 = subprocess.run([sys.executable, "-m", "jpgenc_tpu_torch",
                             "decode", os.path.join(out, "rgb17.jpg"), back,
                             "--device", "cuda"],
                            cwd=root, capture_output=True, text=True,
                            timeout=600)
        if r3.returncode != 0:
            fail(f"cli decode exited {r3.returncode}: {r3.stderr[-2000:]}")
        if not np.array_equal(jio.load(back),
                              api.decode(want["rgb17"], device="cuda")):
            fail("cli decode pixels != api.decode's")
    emit({"phase": "cli_batch", "files": len(want), "chunks": 3,
          "launches": cli_counts, "summary": first, "resume": second,
          "files_equal_encode_batch": True, "manifest_lines": n_lines,
          "write_inputs_s": round(write_s, 1),
          "batch_s": round(batch_s, 1), "resume_s": round(resume_s, 1),
          "decode_equal_api": True,
          "seconds": round(time.perf_counter() - t_phase, 1)})

    # --- phase 20: bench_torch.py, the headline and decode rows ----------------
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rb = subprocess.run(
            [sys.executable, os.path.join(root, "bench_torch.py"), "--rows",
             "1080p_420_q75,decode_1080p,batch_sharded", "--batch", "16",
             "--detail",
             os.path.join(tmp, "detail.json")],
            cwd=root, capture_output=True, text=True, timeout=600)
    if rb.returncode != 0:
        fail(f"bench_torch.py exited {rb.returncode}: {rb.stderr[-2000:]}")
    bench_line = rb.stdout.strip().splitlines()[-1]
    bench = json.loads(bench_line)
    missing = {"metric", "value", "unit", "backend", "power_limit_w",
               "configs"} - set(bench)
    if missing or len(bench_line) >= 1900 or "vs_baseline" in bench \
            or not bench["backend"].startswith("cuda") \
            or set(bench["configs"]) != {"1080p_420_q75", "decode_1080p",
                                         "batch_sharded"} \
            or not bench["value"] > 0:
        fail(f"bench_torch.py line: {bench_line[:500]} (missing {missing})")
    emit({"phase": "bench_torch", "line_chars": len(bench_line),
          "value": bench["value"], "configs": bench["configs"],
          "seconds": round(time.perf_counter() - t_phase, 1)})

    # --- phase 21: stripe mode on one 8K frame -------------------------------
    # 4320 x 7680 RGB, Q75, 4:2:0: 270 MCU rows of 480 MCUs. 6 stripes is the
    # even case (default DRI: 45 rows x 480 MCUs), 8 the ragged one (default
    # DRI: one row, 480); each fused and with optimize. Then the luma in 7
    # stripes (540 rows of 960: ragged, gray K1A) and islow + optimize at
    # 4321 rows (not an MCU multiple: the last live stripe is re-encoded
    # under its true-height layout). A ragged optimize case counts its tail
    # stripe's histogram under the true-height layout: one more pass 1
    # (K1 rows; islow: torch ops). Each file must equal api.encode's at the
    # file's DRI byte for byte, and its scan decode the kernels'
    # coefficients exactly.
    t_phase = time.perf_counter()
    BH, BW = 4320, 7680
    big = fixtures.synth_frame(BH, BW)
    big_gray = np.ascontiguousarray(big[..., 1])
    big_islow = np.ascontiguousarray(np.concatenate([big, big[-1:]]))

    def big_zz(img, mode):
        """The unstriped encode's coefficients in raster order, from the
        kernels the file's path runs (K1A / gray K1A; islow: the integer
        pipeline)."""
        pl = engine.get_plan(img.shape[0], BW, mode, Q, "cuda")
        xb = torch.from_numpy(img).to(dev)[None]
        if mode != "gray" and img.shape[0] != BH:
            zz = pl.zz_islow(xb)[0][0, :pl.layout.n_scan]
        else:
            zz = k1a_fused.fused_pixels_to_pack(
                xb, pl.layout, pl.kdct, pl.q, pl.standard_tables, 8,
                return_zz=True)[2][0]
        return raster(zz.cpu().numpy().astype(np.int32), pl.layout)

    def big_decode_exact(data, want):
        p = parser.parse_jpeg(data)
        lay_ = make_layout(p.height, p.width, p.subsampling,
                           p.restart_interval)
        coef = native.decode_scan(
            p.scan_data, lay_, [c.dc_tab for c in p.comps],
            [c.ac_tab for c in p.comps],
            [p.dc_tables.get(i) for i in range(2)],
            [p.ac_tables.get(i) for i in range(2)])
        return coef is not None and np.array_equal(coef, want)

    striped_rows, striped_launches, striped_files = [], {}, {}
    zz_cache = {}
    for img, what, n_st, r, kw, expect in (
            (big, "rgb 6 stripes", 6, 21600, {}, {"k1a_fused": 1,
                                                  "seg_merge": 1}),
            (big, "rgb 8 stripes ragged", 8, 480, {},
             {"k1a_fused": 1, "seg_merge": 1}),
            (big, "rgb 6 stripes optimize", 6, 21600, {"optimize": True},
             {"k1_dct": 1, "block_pack": 1, "seg_merge": 1}),
            (big, "rgb 8 stripes ragged optimize", 8, 480,
             {"optimize": True}, {"k1_dct": 2, "block_pack": 1,
                                  "seg_merge": 1}),
            (big_gray, "gray 7 stripes ragged", 7, 960, {},
             {"k1a_gray": 1, "seg_merge": 1}),
            (big_islow, "islow optimize 4321 rows, 6 stripes ragged", 6,
             480, {"optimize": True, "dct_method": "islow"},
             {"block_pack": 2, "seg_merge": 2})):
        reset_counters()
        t0 = time.perf_counter()
        data = mesh.encode_striped(img, n_st, quality=Q, device="cuda", **kw)
        first_s = time.perf_counter() - t0
        launches, plain = read_counters()
        ran = {k: v for k, v in launches.items() if v}
        if ran != expect or plain:
            fail(f"encode_striped {what}: launches {launches} (expected "
                 f"{expect}), plain calls {plain}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            again = mesh.encode_striped(img, n_st, quality=Q, device="cuda",
                                        **kw)
            walls.append(time.perf_counter() - t0)
            if again != data:
                fail(f"encode_striped {what} is not deterministic")
        whole = api.encode(img, quality=Q, restart_interval=r, device="cuda",
                           **kw)
        whole_walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            api.encode(img, quality=Q, restart_interval=r, device="cuda",
                       **kw)
            whole_walls.append(round(time.perf_counter() - t0, 4))
        if data != whole:
            fail(f"encode_striped {what} != api.encode(restart_interval={r})")
        mode = "gray" if img.ndim == 2 else "420"
        key = (img.shape[0], mode)          # the DRI moves no coefficient
        if key not in zz_cache:
            zz_cache[key] = big_zz(img, mode)
        if not big_decode_exact(data, zz_cache[key]):
            fail(f"encode_striped {what}: decoded != kernel coefficients")
        px = img.shape[0] * BW
        striped_launches[what] = ran
        striped_files[what] = data
        striped_rows.append({
            "case": what, "restart_interval": r, "launches": ran,
            "first_call_s": round(first_s, 4),
            "wall_s": [round(t, 4) for t in walls],
            "mpix_per_s_median": round(
                px / 1e6 / sorted(walls)[1], 1),
            "api_encode_wall_s": whole_walls,
            "bpp": round(8 * len(data) / px, 4)})
    del zz_cache
    emit({"phase": "encode_striped", "shape": [BH, BW], "cases":
          striped_rows, "bytes_equal_api_encode": True,
          "decode_exact": True, "plain_calls": 0,
          "seconds": round(time.perf_counter() - t_phase, 1)})

    # --- phase 22: device lists on the one card ----------------------------
    # the 16 frames through encode_batch over ["cuda", "cuda"] (8 rows an
    # entry: one plan, one stream, in turn), fused and optimize, and the
    # batch-split decode; files and pixels equal the single-device ones
    t_phase = time.perf_counter()
    two = ["cuda", "cuda"]
    dl_rows = {}
    for what, kw, single, expect in (
            ("fused", {}, files, {"k1a_fused": 2, "seg_merge": 2}),
            ("optimize", {"optimize": True}, opt_files,
             {"k1_dct": 2, "block_pack": 2, "seg_merge": 2})):
        reset_counters()
        got = mesh.encode_batch(x16, quality=Q, devices=two, device="cuda",
                                **kw)
        launches, plain = read_counters()
        ran = {k: v for k, v in launches.items() if v}
        if ran != expect or plain:
            fail(f"device list {what}: launches {launches}, plain {plain}")
        if got != single:
            fail(f"device list {what} files != the single-device files")
        pair_walls = {"single": [], "list": []}
        for _ in range(3):
            for name, devs_ in (("single", None), ("list", two)):
                t0 = time.perf_counter()
                mesh.encode_batch(x16, quality=Q, devices=devs_,
                                  device="cuda", **kw)
                pair_walls[name].append(round(time.perf_counter() - t0, 4))
        dl_rows[what] = {"launches": ran, **pair_walls}
    reset_counters()
    pix = mesh.decode_batch(files, devices=two, device="cuda")
    torch.cuda.synchronize()
    launches, plain = read_counters()
    dl_decode = {k: v for k, v in launches.items() if v}
    if dl_decode != {"recon": 2} or plain:
        fail(f"device list decode: launches {launches}, plain {plain}")
    if not (len(pix) == 2 and all(p.is_cuda for p in pix) and torch.equal(
            torch.cat(pix), api.decode_batch(files, to_device=True))):
        fail("mesh.decode_batch over two entries != api.decode_batch")
    again = mesh.encode_batch(pix, quality=Q, devices=two, device="cuda")
    if again != mesh.encode_batch(torch.cat(pix), quality=Q, device="cuda"):
        fail("device-list transcode != the single-device encode")
    emit({"phase": "device_list", "entries": two, "frames": len(files),
          **dl_rows, "decode_launches": dl_decode,
          "files_equal_single_device": True, "pixels_equal_api": True,
          "seconds": round(time.perf_counter() - t_phase, 1)})

    # --- phase 23: two processes on the one card -----------------------------
    # dryrun_torch.py: two ranks over gloo, two entries each, its small cases
    # checked on every rank, plus the 16 frames split by rank and the 8K
    # frame in 6 stripes, whose SHA-256 must equal this process's files
    import hashlib
    t_phase = time.perf_counter()
    rd = subprocess.run(
        [sys.executable, os.path.join(root, "dryrun_torch.py"), "--ranks",
         "2", "--device", "cuda", "--full", "--timeout", "400"],
        cwd=root, capture_output=True, text=True, timeout=450)
    if rd.returncode != 0:
        fail(f"dryrun_torch.py exited {rd.returncode}: {rd.stderr[-3000:]}")
    ranks = [json.loads(ln.split(" ", 1)[1]) for ln in rd.stdout.splitlines()
             if ln.startswith("DRYRUN ")]
    want_sha = {"batch_16x1080p": hashlib.sha256(b"".join(files)).hexdigest(),
                "striped_8k_6": hashlib.sha256(
                    striped_files["rgb 6 stripes"]).hexdigest()}
    if len(ranks) != 2 or any(r_["sha256"] != want_sha for r_ in ranks):
        fail(f"two-rank files differ: {ranks} against {want_sha}")
    # the launches each rank's distributed calls made: its small cases run
    # every encode and decode kernel but the repack and separable K1; its
    # full cases 4 calls of 8 rows and 4 of 3 stripes, each over two
    # entries, one K1A and one merge tail an entry
    mp_small = {"k1a_fused", "k1a_gray", "seg_merge", "k1_dct", "k1_gray",
                "block_pack", "symbol_hist", "recon", "recon_gray"}
    for r_ in ranks:
        small, full = dict(r_["launches"]), dict(r_["launches_full"])
        if small.pop("plain_calls") or full.pop("plain_calls") \
                or {k for k, v in small.items() if v} != mp_small \
                or {k: v for k, v in full.items() if v} != \
                {"k1a_fused": 16, "seg_merge": 16}:
            fail(f"rank {r_['rank']}: launches {r_['launches']}, full "
                 f"{r_['launches_full']}")
    mp_launches = {k: sum(r_["launches"][k] + r_["launches_full"][k]
                          for r_ in ranks) for k in ranks[0]["launches"]}
    emit({"phase": "multiprocess", "ranks": ranks,
          "sha256_equal_this_process": True,
          "single_process_wall_s": {
              "batch_16x1080p": [round(t, 4) for t in numpy_walls],
              "striped_8k_6": striped_rows[0]["wall_s"]},
          "seconds": round(time.perf_counter() - t_phase, 1)})

    if any(m == "jax" or m.startswith(("jax.", "jpgenc_tpu."))
           or m == "jpgenc_tpu" for m in sys.modules):
        fail("jax or the JAX package was imported")

    emit({"phase": "paths", "histogram_ms": round(hist_ms, 4),
          "launches_by_path": {"fused": main_launches,
                               "optimize": opt_launches,
                               "gray": gray_launches,
                               "gray_optimize": gray_opt_launches,
                               "decode": dec_launches,
                               "decode_optimized": dec_opt_launches,
                               "decode_gray": dec_gray_launches,
                               "dri": dri_launches,
                               "dri_optimize": dri_opt_launches,
                               "gray_dri": gdri_launches,
                               "wide_optimize": wide_launches,
                               "separable_optimize": sep_launches,
                               "islow": islow_launches,
                               "striped": striped_launches,
                               "device_list": {
                                   k: v["launches"]
                                   for k, v in dl_rows.items()},
                               "device_list_decode": dl_decode,
                               "multiprocess": [
                                   {k: v for k, v in r_["launches"].items()
                                    if v} for r_ in ranks],
                               "multiprocess_full": [
                                   {k: v for k, v in
                                    r_["launches_full"].items() if v}
                                   for r_ in ranks]}})

    # bounds: each input read once and each output written once over the HBM
    # rate, against the operations the function needs over the CUDA-core
    # rate. The function is colour conversion, subsampling, an 8x8 DCT per
    # block and quantization, so its operations are counted for a separable
    # float32 form: 15 per pixel for BT.601, one add or scale per pixel
    # averaged into a chroma sample, 16 eight-point passes of 40 (Loeffler's
    # 11 multiplies and 29 adds) per block, 2 per coefficient for divide
    # and round; entropy coding
    # is counted as 6 integer operations per coefficient and merging as 4
    # per output word, at the same rate. What the port's own formulation
    # spends instead is reported beside the bound as own_flop_ms and is no
    # part of it: for K1A, K1 rows and the repack kernel the shared per-block
    # transform's 64-term product per coefficient, 2 * 64 * l_out per MCU
    # (their one operand is KDCT_ZZ, 16 KB, where the dense operator they ran
    # before was 4 * k_in * l_out bytes). The reconstruction is
    # counted likewise: per block one multiply per coefficient, the 16
    # eight-point passes and 3 per sample for + 128, round and clamp; per
    # pixel 12 for the chroma taps, 8 for the colour matrix and 6 for three
    # rounds and clamps. Its own figure is what csrc/recon.cu spends on the
    # all-nonzero input: 64 terms for each of a thread's 16 samples, every
    # thread of a tile (the own blocks' groups, the group of the left and
    # right neighbours, and two position quads of each halo-row group);
    # own_flop_ms_bench is the own blocks' products on the bench input,
    # where a warp runs only the union of its blocks' nonzero terms. The repack
    # kernel is bounded at the wide frames' shape, its main path's (the image
    # read once: the repack is the function's own intermediate); the
    # separable kernel's own figure is its 64-term luma and nb*64-term chroma
    # dot products, (nb*64 + 2*nb*64) * 64 FMAs per MCU.
    n_mcu, l_out = lay.n_mcus, lay.blocks_per_mcu * 64
    slots, gslots = n_img * lay.n_scan, n_img * glay.n_scan
    tab_b = 4 * (512 + 256 + 4)
    op_b = 4 * (64 * 64 + l_out)                   # KDCT_ZZ and q
    # the merge tail: buf and bits in; the streams' prefixes, nbits and ovf
    # out; 4 operations per output word
    seg_out_b = 4 * seg_prefix_words + 4 * n_img * lay.n_segments + n_img

    def bound(nbytes, n_ops, own_ops=None):
        by, op = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
        return {"bound_ms": round(max(by, op), 4),
                "bound_by": "bytes" if by >= op else "operations",
                "bytes_ms": round(by, 4), "operations_ms": round(op, 4),
                "own_flop_ms": None if own_ops is None else
                round(own_ops / F32_FLOP_PER_S * 1e3, 4)}

    dct_ops = 16 * 40 + 2 * 64
    px_mcu = lay.mcu_h * lay.mcu_w
    sub_ops = 2 * px_mcu if px_mcu > 64 else 0
    col_ops = float(n_img * n_mcu) * (15 * px_mcu + sub_ops
                                      + lay.blocks_per_mcu * dct_ops)
    gray_ops = float(gslots) * (64 + dct_ops)
    pack_ops, gpack_ops = 6.0 * 64 * slots, 6.0 * 64 * gslots
    col_own = 2.0 * 64 * l_out * n_mcu * n_img
    gray_dense = 2.0 * 64 * 64 * gslots
    rec_blk = 64 + 16 * 40 + 3 * 64
    rec_ops = float(n_img * n_mcu) * (lay.blocks_per_mcu * rec_blk
                                      + 26 * px_mcu)
    grec_ops = float(gslots) * (rec_blk + 3 * 64)
    tiles = n_img * lay.mcus_y * -(-lay.mcus_x // recon.TILE)
    g_top = -(-recon.TILE * lay.blocks_per_mcu // 4) + 1
    g_row = -(-2 * (recon.TILE + 2) // 4)
    rec_dense = 2.0 * 64 * 16 * tiles * (16 * g_top + 4 * g_row)
    gtiles = n_img * glay.mcus_y * -(-glay.mcus_x // recon.GRAY_TILE)
    grec_dense = 2.0 * 64 * 16 * gtiles * 4 * recon.GRAY_TILE
    mcu_ops = 15 * px_mcu + sub_ops + lay.blocks_per_mcu * dct_ops
    nb_y = lay.blocks_per_mcu - 2
    sep_b = 4 * ((1 + nb_y) * 64 * 64 + l_out)
    sep_own = 2.0 * 3 * nb_y * 64 * 64 * n_mcu * n_img
    px_tol = ("pixel |diff| <= 1 on < 1e-3 of the bytes against the plain "
              "version; <= 3 against float64")
    exact = "exact"
    ke = ("zz |diff| <= 1 on <= 1e-4 of coefficients; packed words and bits "
          "exact")
    ke_zz = "zz |diff| <= 1 on <= 1e-4 of coefficients"
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start,
                                             1)})
    kernels = [
        {"name": "k1a_fused", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1a_fused.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1a_fused.py:56",
         "launches": main_launches["k1a_fused"], "max_abs_err": k1a_err,
         "tolerance": ke, "ms": round(k1a_ms, 4),
         "plain_ms": round(k1a_plain_ms, 4),
         **bound(x16.numel() + op_b + tab_b + slots * (4 * 8 + 4),
                 col_ops + pack_ops, col_own),
         "library_ms": None},
        {"name": "seg_merge", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/seg_merge.cu",
         "replaces": "jpgenc_tpu/ops/pallas/seg_merge.py:48",
         "launches": main_launches["seg_merge"], "max_abs_err": seg_err,
         "tolerance": "exact: nbits, ovf and each image's aligned stream "
                      "prefix",
         "covers": "kernel B, the word compaction and the overflow flag "
                   "(EncodePlan.merge)",
         "ms": round(seg_ms, 4),
         "device_ms": seg_dev and seg_dev["device_ms"],
         "launches_per_call": seg_dev and seg_dev["launches_per_call"],
         "plain_ms": round(seg_plain_ms, 4),
         **bound(slots * (4 * 8 + 4) + seg_out_b, seg_prefix_words * 4.0),
         "library_ms": None},
        {"name": "k1_dct", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1_dct.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1_dct.py:140",
         "launches": opt_launches["k1_dct"], "max_abs_err": k1_err,
         "tolerance": ke_zz + ", only within 1e-4 of a float64 rounding "
                      "boundary; equal to K1A's zz exactly",
         "differing": k1_differing,
         "ms": round(k1_ms, 4), "plain_ms": round(k1_plain_ms, 4),
         **bound(x16.numel() + op_b + slots * 128, col_ops, col_own),
         "ms_422_444": sampling_ms, "library_ms": None},
        {"name": "block_pack", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/block_pack.cu",
         "replaces": "jpgenc_tpu/ops/pallas/block_pack.py:109",
         "launches": opt_launches["block_pack"], "max_abs_err": a_err,
         "tolerance": exact, "ms": round(a_ms, 4),
         "ms_all_nonzero": round(a_dense_ms, 4),
         "all_nonzero_bytes_ms": round(
             (slots * (128 + 4 + 4 * 56 + 4) + 12 * lay.n_scan + tab_b)
             / HBM_BYTES_PER_S * 1e3, 4),
         "all_nonzero_coded_bits": a_dense_bits,
         "plain_ms": round(a_plain_ms, 4),
         **bound(slots * (128 + 4 + 4 * 8 + 4) + 12 * lay.n_scan
                 + n_img * tab_b, pack_ops),
         "library_ms": None},
        {"name": "symbol_hist", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/symbol_hist.cu",
         "replaces": "no Pallas kernel: jpgenc_tpu/ops/entropy.py "
                     "symbol_histogram is XLA tensor code",
         "launches": opt_hist_launches, "differing": hist_differing,
         "tolerance": exact, "ms": round(hist_ms, 4),
         "plain_ms": round(hist_plain_ms, 4), "ptxas": hist_ptxas,
         **bound(slots * (128 + 4) + 12 * lay.n_scan + n_img * 4096, 0),
         "library_ms": None},
        {"name": "k1a_gray", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1a_gray.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1a_fused.py:364",
         "launches": gray_launches["k1a_gray"], "max_abs_err": gk1a_err,
         "tolerance": ke, "ms": round(gk1a_ms, 4),
         "plain_ms": round(gk1a_plain_ms, 4),
         **bound(g16.numel() + 4 * (4096 + 64) + tab_b
                 + gslots * (4 * 8 + 4), gray_ops + gpack_ops, gray_dense),
         "library_ms": None},
        {"name": "k1_gray", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1_dct.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1_dct.py:225",
         "launches": gray_opt_launches["k1_gray"], "max_abs_err": gk1_err,
         "tolerance": ke_zz + ", only within 1e-4 of a float64 rounding "
                      "boundary; equal to gray K1A's zz exactly",
         "differing": gk1_differing,
         "ms": round(gk1_ms, 4), "plain_ms": round(gk1_plain_ms, 4),
         **bound(g16.numel() + 4 * (4096 + 64) + gslots * 128, gray_ops,
                 gray_dense),
         "library_ms": None},
        {"name": "k1_dense_repack", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1_dct.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1_dct.py:175",
         "launches": wide_launches["k1_dense_repack"],
         "max_abs_err": rep_err,
         "tolerance": ke_zz + ", only within 1e-4 of a float64 rounding "
                      "boundary; equal to the row kernel's and K1A's zz "
                      "exactly",
         "differing": rep_differing,
         "shape": "2 x 2048 x 16384 (the wrapper: torch repack + kernel)",
         "ms": round(rep_wide_ms, 4), "plain_ms": round(rep_plain_ms, 4),
         "repack_prologue_ms": round(prologue_wide_ms, 4),
         "row_kernel_ms": round(rows_wide_ms, 4),
         "ms_16x1080p": round(rep16_ms, 4),
         "row_kernel_ms_16x1080p": round(rows16_ms, 4),
         **bound(wide_px + op_b + wide_slots * 128,
                 float(wide_mcus) * mcu_ops, 2.0 * 64 * l_out * wide_mcus),
         "library_ms": None},
        {"name": "k1_color", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1_dct.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1_dct.py:203",
         "launches": sep_launches["k1_color"], "max_abs_err": sep_err,
         "tolerance": "differs from color_plain only within 1e-4 of a "
                      "float64 rounding boundary; from K1 by |diff| <= 1 on "
                      "<= 1e-4 of coefficients",
         "ms": round(sep_ms, 4), "plain_ms": round(sep_plain_ms, 4),
         "row_kernel_ms": round(k1_again_ms, 4),
         "ms_422_444": sep_sampling_ms, "ptxas": sep_ptxas,
         **bound(x16.numel() + sep_b + slots * 128, col_ops),
         "separable_flop_ms": round(sep_own / F32_FLOP_PER_S * 1e3, 4),
         "library_ms": None},
        {"name": "recon", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/recon.cu",
         "replaces": "jpgenc_tpu/ops/pallas/recon.py:279",
         "launches": dec_launches["recon"],
         "max_abs_err": recon_err["420"], "tolerance": px_tol,
         "ms": round(recon_ms, 4), "ms_all_nonzero": round(recon_dense_ms, 4),
         "plain_ms": round(recon_plain_ms, 4),
         **bound(slots * 128 + n_img * l_out * 4 + 4 * 4096
                 + recon_out["420"].numel(), rec_ops, rec_dense),
         "own_flop_ms_bench": round(2.0 * bench_terms["420"]["fmas"]
                                    / F32_FLOP_PER_S * 1e3, 4),
         "library_ms": None},
        {"name": "recon_gray", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/recon.cu",
         "replaces": "jpgenc_tpu/ops/pallas/recon.py:246",
         "launches": dec_gray_launches["recon_gray"],
         "max_abs_err": recon_err["gray"], "tolerance": px_tol,
         "ms": round(grecon_ms, 4),
         "ms_all_nonzero": round(grecon_dense_ms, 4),
         "plain_ms": round(grecon_plain_ms, 4),
         **bound(gslots * 128 + n_img * 64 * 4 + 4 * 4096
                 + recon_out["gray"].numel(), grec_ops, grec_dense),
         "own_flop_ms_bench": round(2.0 * bench_terms["gray"]["fmas"]
                                    / F32_FLOP_PER_S * 1e3, 4),
         "library_ms": None},
    ]
    for k_ in kernels:      # what the two ranks' distributed calls launched
        k_["launches_multiprocess"] = mp_launches[k_["name"]]
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
