#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`jpgenc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from `jpgenc_tpu_torch/csrc/` with nvcc (sm_90a),
checks each kernel against its plain PyTorch version on the card, and drives
three paths through `parallel.mesh.encode_batch`, each with the launch
counters reset just before it and read just after:

  * the fused path: 16 distinct 1080p RGB frames, 4:2:0, Q75, standard tables
    (K1A -> kernel B);
  * the split path: the same frames with optimize=True, one Huffman table set
    per image (K1 -> histogram -> host tables -> kernel A -> kernel B);
  * gray: the luma of the same frames, without optimize (gray K1A -> kernel
    B) and with it (gray K1 -> ... -> kernel A -> kernel B).

Every output file is checked by the repo's own means: the C++ scan decoder,
with the file's own tables, returns the kernel's coefficients exactly, and
frame 0's scan equals the numpy reference encoder's entropy coding of those
coefficients. The fused and the split kernels must hold the same
coefficients and, with the same tables, the same packed words.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores, same sheet


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an "
             "NVIDIA GPU")
    from jpgenc_tpu_torch import engine, native
    from jpgenc_tpu_torch.container import parser
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.ops import entropy
    from jpgenc_tpu_torch.ops.cuda import (block_pack, k1_dct, k1a_fused,
                                           seg_merge)
    from jpgenc_tpu_torch.parallel import mesh
    from jpgenc_tpu_torch.ref import encoder as ref_encoder
    from jpgenc_tpu_torch.utils import fixtures

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

    def knife_edge(a, b, what):
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        mx, frac = int(d.max()), float((d > 0).double().mean())
        if mx > 1 or frac > KNIFE_EDGE_FRAC:
            fail(f"{what}: max |diff| {mx}, mismatch fraction {frac:.2e}")
        return mx, frac

    # --- phase 1: the card and the build -----------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    build.library()
    ptxas = [ln.strip() for ln in build.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print("\n".join(ptxas), file=sys.stderr)
    t0 = time.perf_counter()
    if not native.available():
        fail("the C++ scan codec did not build (no g++?): the host finalize "
             "would silently run in Python")
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": round(build.build_seconds, 3),
          "native_build_s": round(time.perf_counter() - t0, 3)})

    plan = engine.get_plan(H, W, "420", Q, "cuda")
    lay = plan.layout
    ops = (lay, plan.m, plan.bias, plan.q)
    tabs = (plan.ac_rows, plan.dc_rows, plan.misc)
    slot_plan = (plan.ac_tab, plan.dc_tab, plan.valid)
    qt = list(engine.qtables_for_quality(Q))
    dc_t, ac_t = ref_encoder.standard_tables()
    gplan = engine.get_plan(H, W, "gray", Q, "cuda")
    glay = gplan.layout
    gops = (glay, gplan.m, gplan.bias, gplan.q)
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

    # --- phase 3: kernel B against its plain version ------------------------
    buf8, bits8 = k1a_fused.fused_pixels_to_pack(x4, *ops, tabs, 8)
    n_seg = x4.shape[0] * lay.n_segments
    cap_w = engine.scan_caps(lay, Q, "tight")[0] // 4
    flat = (buf8.reshape(-1, 8), bits8.reshape(-1))
    for cap in (None, cap_w):
        sw, sb = seg_merge.fused_seg_merge(*flat, n_seg, 8, cap_words=cap)
        pw, pb = seg_merge.seg_merge_plain(*flat, n_seg, 8, cap_words=cap)
        torch.cuda.synchronize()
        if not torch.equal(sb, pb):
            fail(f"kernel B seg_bits != plain (cap={cap})")
        used = ((sb.to(torch.int64) + 31) >> 5).tolist()
        for s, u in enumerate(used):
            if not torch.equal(sw[s, :u], pw[s, :u]):
                fail(f"kernel B segment {s} != plain (cap={cap})")
        emit({"phase": "seg_merge", "cap_words": cap, "exact": True,
              "seg_bits": sb.tolist()})

    # --- phase 4: the fused path --------------------------------------------
    imgs16 = fixtures.synth_batch(H, W, 16)
    x16 = torch.from_numpy(imgs16).to(dev)
    torch.cuda.synchronize()
    counters = (k1a_fused, seg_merge, k1_dct, block_pack)

    def reset_counters():
        for mod in counters:
            for name in ("launches", "launches_gray", "plain_calls"):
                if hasattr(mod, name):
                    setattr(mod, name, 0)

    def read_counters():
        """(launches by kernel name, plain calls) since reset_counters."""
        return ({"k1a_fused": k1a_fused.launches,
                 "k1a_gray": k1a_fused.launches_gray,
                 "seg_merge": seg_merge.launches,
                 "k1_dct": k1_dct.launches,
                 "k1_gray": k1_dct.launches_gray,
                 "block_pack": block_pack.launches},
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
        it. None where the profiler reports no device time."""
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
        rows = sorted(((dev_us(e), e.key) for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and dev_us(e) > 0), reverse=True)
        total = sum(us for us, _ in rows)
        if not total:
            return None
        return {"device_ms_per_call": round(total / n_calls / 1e3, 3),
                "wall_ms_per_call": round(wall_us / n_calls / 1e3, 3),
                "busy_share": round(total / wall_us, 3),
                "top": [[k[:60], round(us / n_calls / 1e3, 3)]
                        for us, k in rows[:6]]}

    def rates(walls, n_frames):
        mpix = n_frames * H * W / 1e6
        return {"wall_s": [round(t, 4) for t in walls],
                "mpix_per_s_best": round(mpix / min(walls), 1),
                "mpix_per_s_median":
                    round(mpix / sorted(walls)[len(walls) // 2], 1)}

    def bpp(files):
        return round(float(np.mean([8 * len(f) / (H * W) for f in files])), 4)

    files, launches, plain, first_s, walls = drive(
        x16, ("k1a_fused", "seg_merge"), 3)
    main_launches = dict(launches)

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
    noise = np.random.default_rng(0).integers(0, 256, (H, W, 3), np.uint8)
    x2 = torch.from_numpy(np.stack([imgs16[0], noise])).to(dev)
    tight = plan.fetch(plan(x2, cap_w * 4, 8), cap_w * 4)
    if not tight[0][2] or tight[1][2]:
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
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4), **rates(walls, len(files)),
          "profile": busy(x16),
          "bpp": bpp(files), "noise_bpp": round(8 * len(pair[1]) / (H * W), 4),
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
    hist4 = entropy.symbol_histogram(zz_k1, dcdiff4, *slot_plan)
    t0 = time.perf_counter()
    ref_hist = ref_encoder.symbol_histogram(
        lay, raster(zz_k1[0].cpu().numpy().astype(np.int32)))
    if not np.array_equal(hist4[0].cpu().numpy(), ref_hist):
        fail("torch symbol histogram != ref.encoder.symbol_histogram, frame 0")
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
        scans = pl.entropy_scans_zz(zz, dcdiff, tb, cap, 8)
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
          "bpp": bpp(opt_files), "bpp_standard_tables": bpp(files),
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
          "profile": busy(g16), "bpp": bpp(gfiles), "decode_exact": True,
          "entropy_scan_exact": True})

    gopt_files, launches, plain, first_s, walls = drive(
        g16, ("k1_gray", "block_pack", "seg_merge"), 3, optimize=True)
    gray_opt_launches = dict(launches)
    check_optimized(gopt_files, gfiles, gzz16_np, glay, 1, "gray optimize")
    split_of_optimize(gplan, g16)                        # warm
    emit({"phase": "encode_batch_gray_optimize", "frames": len(gopt_files),
          "launches": launches, "plain_calls": plain,
          "first_call_s": round(first_s, 4),
          **rates(walls, len(gopt_files)), "bpp": bpp(gopt_files),
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

    b16, bits16, zz16_again, k1a_err = hold_pack(x16, ops, tabs, "K1A")
    if not torch.equal(zz16_again, zz16):
        fail("K1A zz differs between two launches at B=16")
    del zz16_again
    k1_err, _ = knife_edge(zz16_k1, k1_dct.pixels_to_scan_plain(x16, *ops),
                           "K1 zz vs plain, B=16")
    _, _, gzz16a, gk1a_err = hold_pack(g16, gops, gtabs, "gray K1A")
    if not torch.equal(gzz16a, gzz16):
        fail("gray K1 zz != gray K1A zz at B=16")
    del gzz16a
    gk1_err, _ = knife_edge(gzz16, k1_dct.pixels_to_scan_plain(g16, *gops),
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

    flat16 = (b16.reshape(-1, 8), bits16.reshape(-1))
    n16 = n_img * lay.n_segments
    sw, _ = seg_merge.fused_seg_merge(*flat16, n16, 8, cap_words=cap_w)
    pw, _ = seg_merge.seg_merge_plain(*flat16, n16, 8, cap_words=cap_w)
    seg_err = int((sw.to(torch.int64) - pw.to(torch.int64)).abs().max())
    if seg_err:
        fail("kernel B != seg_merge_plain at B=16")
    seg_ms = sync_ms(lambda: seg_merge.fused_seg_merge(
        *flat16, n16, 8, cap_words=cap_w), 20)
    seg_plain_ms = sync_ms(lambda: seg_merge.seg_merge_plain(
        *flat16, n16, 8, cap_words=cap_w), 5)

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
    hist_ms = sync_ms(lambda: entropy.symbol_histogram(
        zz16_k1, dcdiff16, *slot_plan), 5)
    torch.cuda.synchronize()

    if any(m == "jax" or m.startswith(("jax.", "jpgenc_tpu."))
           or m == "jpgenc_tpu" for m in sys.modules):
        fail("jax or the JAX package was imported")

    emit({"phase": "paths", "histogram_ms": round(hist_ms, 4),
          "launches_by_path": {"fused": main_launches,
                               "optimize": opt_launches,
                               "gray": gray_launches,
                               "gray_optimize": gray_opt_launches}})

    # bounds: each input read once and each output written once over the HBM
    # rate, against the operations the function needs over the CUDA-core
    # rate. The function is colour conversion, subsampling, an 8x8 DCT per
    # block and quantization, so its operations are counted for a separable
    # float32 form: 15 per pixel for BT.601, one add or scale per pixel
    # averaged into a chroma sample, 16 eight-point passes of 40 (Loeffler's
    # 11 multiplies and 29 adds) per block, 2 per coefficient for divide
    # and round; entropy coding
    # is counted as 6 integer operations per coefficient and merging as 4
    # per output word, at the same rate. What this port's dense operator
    # spends instead (2 * k_in * l_out per MCU) is reported beside the bound
    # as dense_operator_ms and is no part of it.
    n_mcu, l_out = lay.n_mcus, lay.blocks_per_mcu * 64
    k_in = 3 * lay.mcu_h * lay.mcu_w
    slots, gslots = n_img * lay.n_scan, n_img * glay.n_scan
    tab_b = 4 * (512 + 256 + 4)
    op_b = 4 * (k_in * l_out + 2 * l_out)
    seg_out_b = 4 * n16 * min(lay.blocks_per_segment * 8 + 2, cap_w)

    def bound(nbytes, n_ops, dense_ops=None):
        by, op = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOP_PER_S * 1e3
        return {"bound_ms": round(max(by, op), 4),
                "bound_by": "bytes" if by >= op else "operations",
                "bytes_ms": round(by, 4), "operations_ms": round(op, 4),
                "dense_operator_ms": None if dense_ops is None else
                round(dense_ops / F32_FLOP_PER_S * 1e3, 4)}

    dct_ops = 16 * 40 + 2 * 64
    px_mcu = lay.mcu_h * lay.mcu_w
    sub_ops = 2 * px_mcu if px_mcu > 64 else 0
    col_ops = float(n_img * n_mcu) * (15 * px_mcu + sub_ops
                                      + lay.blocks_per_mcu * dct_ops)
    gray_ops = float(gslots) * (64 + dct_ops)
    pack_ops, gpack_ops = 6.0 * 64 * slots, 6.0 * 64 * gslots
    col_dense = 2.0 * k_in * l_out * n_mcu * n_img
    gray_dense = 2.0 * 64 * 64 * gslots
    exact = "exact"
    ke = ("zz |diff| <= 1 on <= 1e-4 of coefficients; packed words and bits "
          "exact")
    ke_zz = "zz |diff| <= 1 on <= 1e-4 of coefficients"
    emit({"kernels": [
        {"name": "k1a_fused", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1a_fused.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1a_fused.py:56",
         "launches": main_launches["k1a_fused"], "max_abs_err": k1a_err,
         "tolerance": ke, "ms": round(k1a_ms, 4),
         "plain_ms": round(k1a_plain_ms, 4),
         **bound(x16.numel() + op_b + tab_b + slots * (4 * 8 + 4),
                 col_ops + pack_ops, col_dense),
         "library_ms": None},
        {"name": "seg_merge", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/seg_merge.cu",
         "replaces": "jpgenc_tpu/ops/pallas/seg_merge.py:48",
         "launches": main_launches["seg_merge"], "max_abs_err": seg_err,
         "tolerance": exact, "ms": round(seg_ms, 4),
         "plain_ms": round(seg_plain_ms, 4),
         **bound(slots * (4 * 8 + 4) + seg_out_b + 4 * n16, seg_out_b),
         "library_ms": None},
        {"name": "k1_dct", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/k1_dct.cu",
         "replaces": "jpgenc_tpu/ops/pallas/k1_dct.py:140",
         "launches": opt_launches["k1_dct"], "max_abs_err": k1_err,
         "tolerance": ke_zz + "; equal to K1A's zz exactly",
         "ms": round(k1_ms, 4), "plain_ms": round(k1_plain_ms, 4),
         **bound(x16.numel() + op_b + slots * 128, col_ops, col_dense),
         "library_ms": None},
        {"name": "block_pack", "route": "cuda",
         "source": "jpgenc_tpu_torch/csrc/block_pack.cu",
         "replaces": "jpgenc_tpu/ops/pallas/block_pack.py:109",
         "launches": opt_launches["block_pack"], "max_abs_err": a_err,
         "tolerance": exact, "ms": round(a_ms, 4),
         "plain_ms": round(a_plain_ms, 4),
         **bound(slots * (128 + 4 + 4 * 8 + 4) + 12 * lay.n_scan
                 + n_img * tab_b, pack_ops),
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
         "tolerance": ke_zz + "; equal to gray K1A's zz exactly",
         "ms": round(gk1_ms, 4), "plain_ms": round(gk1_plain_ms, 4),
         **bound(g16.numel() + 4 * (4096 + 64) + gslots * 128, gray_ops,
                 gray_dense),
         "library_ms": None},
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
