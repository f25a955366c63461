#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (`jpgenc_tpu_torch`): one JSON line on
stdout.

    python bench_torch.py                                   # on the GPU
    python bench_torch.py --device cpu --size 64x96 --batch 2   # plain versions

Headline: MPix/s of `parallel.mesh.encode_batch`, baseline JPEG at Q75, RGB
1080p 4:2:0, standard Annex K tables, on a device-resident batch of 64 made
by tiling 16 distinct frames (`fixtures.synth_batch(1080, 1920, 16)`) on
the device; the median of 10 calls after a warm-up call. Each
call ends in finished `bytes`, so the host clock around it covers the
device's work, the fetch and the host finalize.

The other rows carry the names of the reference bench's configs (bench.py)
so that the records line up: qsweep_dri (Q10-95 under DRI 120, timed
round-robin), 1080p_422_q75, 1080p_444_q75, 1080p_islow_q75,
1080p_420_q75_optimized (with a pass-1 / tables / pass-2 split),
gray512_q75, 4k_optimized, decode_1080p (to_device, download, single,
single_dri), e2e_upload (through stage_batch, beside the same batch
encoded from numpy) and batch_sharded (bench.py's c11: 3 chunks of the
frames through stage_batch / encode_batch(staged=) on every visible card,
double-buffered, e2e_mpix_per_s of the median of 5 passes). --size scales every row: the gray row
keeps 512/1080 of the height, the 4k row is twice the size in each
dimension. The headline always runs; --rows picks the others.

Per row: mpix_per_s (host clock, median), device_only_mpix_per_s (CUDA
events around the row's device stages, nothing fetched; "not measured" on
the CPU), d2h_bytes (what the fetch copied to the host per call), bpp and
psnr_db of frame 0 (decoded by this package's own decoder); pillow_bpp and
pillow_psnr_db only where Pillow imports. A link_probe block reads pageable
and pinned host <-> device MB/s at the start and the end, and a cost_model
block the analytic FLOPs / bytes of each benched layout.

Full detail goes to stderr and to a sidecar file (--detail, default
BENCH_TORCH_DETAIL.json beside this script); stdout gets one compact JSON
line under 1900 characters. Any row that raises ends the script with a
non-zero status; device "cuda" without CUDA raises. No TPU figure applies
to these numbers, so the line carries no vs_baseline.
"""
from __future__ import annotations

import argparse
import io as _io
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

ROWS = ("1080p_420_q75", "qsweep_dri", "1080p_422_q75", "1080p_444_q75",
        "1080p_islow_q75", "1080p_420_q75_optimized", "gray512_q75",
        "4k_optimized", "decode_1080p", "e2e_upload", "batch_sharded")
QSWEEP = (10, 25, 50, 75, 90, 95)
UPLOAD = 16     # distinct frames made on the host, tiled on the device
ITERS = 10      # timed calls a row; the rows report medians
LINE_MAX = 1900


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _quartiles(xs):
    s = sorted(xs)
    return [s[len(s) // 4], s[len(s) // 2], s[(3 * len(s)) // 4]]


def _card():
    """(name, power limit in W) from nvidia-smi, as it prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    line = r.stdout.strip().splitlines()[0]
    name, limit = (x.strip() for x in line.split(",", 1))
    return line, name, float(limit.split()[0])


class Bench:
    """The rows, on one device; every timing helper knows whether the
    device has a clock of its own."""

    def __init__(self, args):
        import torch

        from jpgenc_tpu_torch import api, engine
        from jpgenc_tpu_torch.parallel import mesh
        self.torch, self.api, self.engine, self.mesh = torch, api, engine, mesh
        self.dev = engine.resolve_device(args.device)
        self.cuda = self.dev.type == "cuda"
        self.h, self.w = (int(x) for x in args.size.split("x"))
        self.b = args.batch

    # --- timing --------------------------------------------------------------
    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def wall(self, fn, n):
        """Host-clock seconds of n calls of fn (each ends synchronized)."""
        out, ts = None, []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            self.sync()
            ts.append(time.perf_counter() - t0)
        return ts, out

    def events_ms(self, fn, n=10):
        """Device ms per call of fn between two CUDA events (warm call
        first); None on the CPU, which has no device clock."""
        if not self.cuda:
            return None
        torch = self.torch
        fn()
        torch.cuda.synchronize(self.dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(n):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / n

    def busy(self, fn, n=5):
        """Device time per call and busy share of n calls of fn under
        torch.profiler (kernels and copies over the window's wall)."""
        if not self.cuda:
            return "not measured"
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if not us:
            return "not measured"
        return {"device_ms_per_call": us / n / 1e3,
                "wall_ms_per_call": wall_us / n / 1e3,
                "busy_share": us / wall_us}

    def mpix(self, n_frames, h, w, sec):
        return n_frames * h * w / 1e6 / sec

    def device_only(self, fn, n_frames, h, w):
        ms = self.events_ms(fn)
        return "not measured" if ms is None else \
            self.mpix(n_frames, h, w, ms / 1e3)

    # --- quality -------------------------------------------------------------
    def quality(self, data: bytes, img: np.ndarray, quality: int,
                subsampling: str = "420", optimize: bool = False) -> dict:
        """bpp and PSNR of one file (this package's decoder), and of
        Pillow's file at the same settings where Pillow imports."""
        from jpgenc_tpu_torch.utils.metrics import psnr
        px = img.shape[0] * img.shape[1]
        dec = self.api.decode(data, device=self.dev)
        row = {"bpp": round(8 * len(data) / px, 4),
               "psnr_db": round(float(psnr(dec, img)), 2)}
        try:
            from PIL import Image
        except ImportError:
            return row
        buf = _io.BytesIO()
        kw = {"optimize": True} if optimize else {}
        if img.ndim == 3:
            kw["subsampling"] = {"444": 0, "422": 1, "420": 2}[subsampling]
        Image.fromarray(img).save(buf, "JPEG", quality=quality, **kw)
        anchor = buf.getvalue()
        adec = np.asarray(Image.open(_io.BytesIO(anchor)).convert(
            "RGB" if img.ndim == 3 else "L"))
        row["pillow_bpp"] = round(8 * len(anchor) / px, 4)
        row["pillow_psnr_db"] = round(float(psnr(adec, img)), 2)
        return row

    # --- encode rows ---------------------------------------------------------
    def encode_row(self, x, src0, n_iter, quality=75, **kw):
        """encode_batch on the device-resident batch x: median wall of
        n_iter calls after a warm call, d2h bytes a call, device-only rate of
        the device stages, bpp / PSNR of frame 0."""
        engine, mesh = self.engine, self.mesh

        def call():
            return mesh.encode_batch(x, quality=quality, device=self.dev,
                                     **kw)
        outs = call()                                        # warm / build
        engine.fetched_bytes = 0
        walls, again = self.wall(call, n_iter)
        d2h = engine.fetched_bytes // n_iter
        if again != outs:
            raise RuntimeError(f"encode_batch {kw} is not deterministic")
        h, w = x.shape[1], x.shape[2]
        row = {"frames": x.shape[0], "shape": [h, w],
               "mpix_per_s": self.mpix(x.shape[0], h, w, _median(walls)),
               "wall_ms_quartiles": [1e3 * t for t in _quartiles(walls)],
               "calls": n_iter,
               "device_only_mpix_per_s": self.device_only(
                   self.device_stages(x, quality, **kw), x.shape[0], h, w),
               "d2h_bytes": d2h,
               **self.quality(outs[0], src0, quality,
                              kw.get("subsampling", "420"),
                              kw.get("optimize", False))}
        return row, outs

    def device_stages(self, x, quality, subsampling="420",
                      restart_interval=0, optimize=False, dct_method="float"):
        """A callable that runs only the device stages of one encode_batch
        call at the tight tier (nothing fetched): K1A + the merge tail, or
        pass 1 + pass 2 with tables built once outside."""
        engine = self.engine
        mode = "gray" if x.dim() == 3 else subsampling
        plan = engine.get_plan(x.shape[1], x.shape[2], mode, quality,
                               str(self.dev), restart_interval)
        cap = engine.scan_caps(plan.layout, quality, "tight")[0]
        from jpgenc_tpu_torch.ops.pack import w_blk_for_quality
        w_blk = w_blk_for_quality(quality)
        islow = dct_method == "islow"
        if not optimize and not islow:
            return lambda: plan(x, cap, w_blk)
        tabs = plan.optimized_tables(plan.zz_and_histogram(x, islow)[2])[1] \
            if optimize else plan.standard_tables

        def stages():
            zz, dcdiff = plan.zz_and_histogram(x, islow)[:2] if optimize \
                else plan.zz_islow(x)
            return plan.entropy_from_zz(zz, dcdiff, tabs, cap, w_blk)
        return stages

    def split_of_optimize(self, x, quality=75):
        """One optimize call in three stages by host clock (StageTimer:
        pass 1 with the histogram, the host table build, pass 2 with the
        fetch and finalize) and the two passes by CUDA events."""
        from jpgenc_tpu_torch.utils.profiling import StageTimer
        engine = self.engine
        mode = "gray" if x.dim() == 3 else "420"
        plan = engine.get_plan(x.shape[1], x.shape[2], mode, quality,
                               str(self.dev))
        cap = engine.scan_caps(plan.layout, quality, "tight")[0]
        from jpgenc_tpu_torch.ops.pack import w_blk_for_quality
        w_blk = w_blk_for_quality(quality)
        st = StageTimer()
        for _ in range(2):                      # the second call is recorded
            st.records.clear()
            self.sync()
            with st.stage("pass1"):
                zz, dcdiff, hist = st.force(plan.zz_and_histogram(x))
            with st.stage("tables"):
                tabs = plan.optimized_tables(hist)[1]
            with st.stage("pass2"):
                plan.finalize(plan.fetch(
                    plan.entropy_from_zz(zz, dcdiff, tabs, cap, w_blk), cap))
        out = {f"{k}_ms": 1e3 * v for k, v in st.records.items()}
        p1 = self.events_ms(lambda: plan.zz_and_histogram(x))
        p2 = self.events_ms(
            lambda: plan.entropy_from_zz(zz, dcdiff, tabs, cap, w_blk))
        out["pass1_device_ms"] = "not measured" if p1 is None else p1
        out["pass2_device_ms"] = "not measured" if p2 is None else p2
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the CUDA kernels) or cpu (their plain "
                         "PyTorch versions)")
    ap.add_argument("--size", default="1080x1920",
                    help="HxW of the 1080p rows; the other rows scale")
    ap.add_argument("--batch", type=int, default=64,
                    help="frames a call in the batched rows")
    ap.add_argument("--seed", type=int, default=7,
                    help="seed of the first synthetic frame (frame i: "
                         "seed + i)")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="comma-separated rows (the headline always runs)")
    ap.add_argument("--detail", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "BENCH_TORCH_DETAIL.json"),
        help="path of the full-detail sidecar file")
    args = ap.parse_args(argv)
    rows = set(args.rows.split(","))
    unknown = rows - set(ROWS)
    if unknown:
        ap.error(f"unknown rows {sorted(unknown)}; rows are {ROWS}")

    bench = Bench(args)
    torch, api, engine, mesh = bench.torch, bench.api, bench.engine, bench.mesh
    from jpgenc_tpu_torch.layout import make_layout
    from jpgenc_tpu_torch.utils.fixtures import synth_frame
    from jpgenc_tpu_torch.utils.profiling import flops_bytes_estimate
    dev, H, W, B = bench.dev, bench.h, bench.w, bench.b
    n_it = ITERS
    t_start = time.perf_counter()
    if bench.cuda:
        card_line, card_name, power_w = _card()
        backend = f"cuda ({card_name})"
        _log(card_line)
    else:
        card_line, power_w, backend = "not measured", "not measured", "cpu"
    configs: dict[str, dict] = {}

    # ---- link probe (before any row) ---------------------------------------
    def link_probe():
        """Pageable and pinned host <-> device MB/s on a 64 MB buffer."""
        if not bench.cuda:
            return "not measured"
        n = 64 << 20
        host = torch.arange(n, dtype=torch.int32).to(torch.uint8)
        pinned = host.pin_memory()
        d = torch.empty(n, dtype=torch.uint8, device=dev)
        back = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        out = {"buffer_mb": n >> 20}
        for name, fn in (
                ("h2d_pageable_mb_s", lambda: d.copy_(host)),
                ("h2d_pinned_mb_s", lambda: d.copy_(pinned,
                                                    non_blocking=True)),
                ("d2h_pageable_mb_s", lambda: d.cpu()),
                ("d2h_pinned_mb_s", lambda: back.copy_(d,
                                                       non_blocking=True))):
            fn()
            ts, _ = bench.wall(fn, 5)
            out[name] = (n >> 20) / _median(ts)
        return out

    link = {"start": link_probe()}
    _log(f"link probe: {link['start']}")

    # ---- HEADLINE: 1080p RGB 4:2:0 Q75, device-resident batch ----------------
    U = min(B, UPLOAD)
    frames = np.stack([synth_frame(H, W, seed=args.seed + i)
                       for i in range(U)])
    frames_dev = torch.from_numpy(frames).to(dev).repeat(
        -(-B // U), 1, 1, 1)[:B].contiguous()
    bench.sync()
    head, outs = bench.encode_row(frames_dev, frames[0], n_it)
    head["profile"] = bench.busy(
        lambda: mesh.encode_batch(frames_dev, quality=75, device=dev))
    configs["1080p_420_q75"] = head
    headline = head["mpix_per_s"]
    _log(f"1080p_420_q75: {head}")

    # ---- qsweep_dri: Q10..95 under DRI 120, timed round-robin ----------------
    def qsweep(rounds=2, iters=4):
        built = {}
        for q in QSWEEP:                   # build, warm, quality, d2h
            row, _ = bench.encode_row(frames_dev, frames[0], 1, quality=q,
                                      restart_interval=120)
            for k in ("wall_ms_quartiles", "calls"):
                del row[k]
            built[q] = row
        samples = {q: [] for q in QSWEEP}
        for _ in range(rounds):
            for q in QSWEEP:
                ts, _ = bench.wall(lambda: mesh.encode_batch(
                    frames_dev, quality=q, restart_interval=120, device=dev),
                    iters)
                samples[q] += ts
        out = {}
        for q in QSWEEP:
            row = dict(built[q])
            row["mpix_per_s"] = bench.mpix(B, H, W, _median(samples[q]))
            row["round_robin_calls"] = len(samples[q])
            out[f"q{q}"] = row
        for lo, hi in zip(QSWEEP, QSWEEP[1:]):
            if out[f"q{hi}"]["mpix_per_s"] > \
                    out[f"q{lo}"]["mpix_per_s"] * 1.10:
                out[f"q{hi}"]["noise_flag"] = (
                    f"rate exceeds Q{lo}'s by >10%: host noise; judge "
                    f"device_only_mpix_per_s")
        return out

    def sub_row(sub):
        return bench.encode_row(frames_dev, frames[0], n_it,
                                subsampling=sub)[0]

    def islow_row():
        row, _ = bench.encode_row(frames_dev, frames[0], n_it,
                                  dct_method="islow")
        row["note"] = ("dct_method=islow: files byte-identical to "
                       "libjpeg-turbo's")
        return row

    def optimized_row():
        row, _ = bench.encode_row(frames_dev, frames[0], n_it, optimize=True)
        row["split"] = bench.split_of_optimize(frames_dev[:U])
        row["split_frames"] = U
        return row

    def gray_row():
        g = max(16, (512 * H // 1080) // 16 * 16)
        gray = np.stack([synth_frame(g, g, seed=args.seed)[:, :, 0]] * B)
        gdev = torch.from_numpy(gray).to(dev)
        return bench.encode_row(gdev, gray[0], n_it)[0]

    def big_optimized_row():
        bh, bw = 2 * H, 2 * W
        img = synth_frame(bh, bw, seed=args.seed)
        x = torch.from_numpy(img).to(dev)

        def call():
            return api.encode(x, quality=75, optimize=True, device=dev)
        data = call()
        engine.fetched_bytes = 0
        walls, again = bench.wall(call, n_it)
        d2h = engine.fetched_bytes // n_it
        if again != data:
            raise RuntimeError("4k optimize encode is not deterministic")
        up_walls, data_up = bench.wall(
            lambda: api.encode(img, quality=75, optimize=True, device=dev),
            n_it)
        if data_up != data:
            raise RuntimeError("4k: the upload path's file differs")
        return {"frames": 1, "shape": [bh, bw],
                "mpix_per_s": bench.mpix(1, bh, bw, _median(walls)),
                "calls": n_it,
                "device_only_mpix_per_s": bench.device_only(
                    bench.device_stages(x[None], 75, optimize=True),
                    1, bh, bw),
                "d2h_bytes": d2h,
                "e2e_upload_mpix_per_s": bench.mpix(1, bh, bw,
                                                    _median(up_walls)),
                "split": bench.split_of_optimize(x[None]),
                **bench.quality(data, img, 75, optimize=True)}

    def decode_row():
        from jpgenc_tpu_torch.decoder import stage_recon
        nb, ch = B, min(B, 32)
        files = [outs[i % U] for i in range(nb)]

        def to_dev():
            return api.decode_batch(files, to_device=True, chunk=ch,
                                    device=dev)
        to_dev()
        walls, _ = bench.wall(to_dev, n_it)
        run, h2d = stage_recon(files, chunk=ch, device=dev)
        dev_ms = bench.events_ms(run)
        n_dl = min(nb, 8)
        api.decode_batch(files[:n_dl], device=dev)
        dl_walls, dl = bench.wall(
            lambda: api.decode_batch(files[:n_dl], device=dev), n_it)
        api.decode(outs[0], device=dev)
        one_walls, _ = bench.wall(lambda: api.decode(outs[0], device=dev),
                                  n_it)
        dri_file = api.encode(frames[0], quality=75, restart_interval=8,
                              device=dev)
        api.decode(dri_file, device=dev)
        dri_walls, _ = bench.wall(lambda: api.decode(dri_file, device=dev),
                                  n_it)
        from jpgenc_tpu_torch.utils.metrics import psnr
        return {"frames": nb, "chunk": ch, "shape": [H, W],
                "mpix_per_s": bench.mpix(nb, H, W, _median(walls)),
                "note": "to_device (pixels stay on the device), chunked",
                "device_only_mpix_per_s": "not measured" if dev_ms is None
                else bench.mpix(nb, H, W, dev_ms / 1e3),
                "h2d_bytes": h2d,
                "download_mpix_per_s": bench.mpix(n_dl, H, W,
                                                  _median(dl_walls)),
                "d2h_bytes": int(sum(a.nbytes for a in dl)),
                "single_mpix_per_s": bench.mpix(1, H, W, _median(one_walls)),
                "single_dri_mpix_per_s": bench.mpix(1, H, W,
                                                    _median(dri_walls)),
                "bpp": round(8 * len(outs[0]) / (H * W), 4),
                "psnr_db": round(float(psnr(dl[0], frames[0])), 2)}

    def e2e_row():
        """U host frames a call: double-buffered through stage_batch (batch
        k+1 staged while batch k encodes), beside the same batch encoded
        from numpy without it."""
        def numpy_call():
            return mesh.encode_batch(frames, quality=75, device=dev)
        ref = numpy_call()
        if ref != outs[:U]:
            raise RuntimeError("numpy batch files differ from the "
                               "device-resident batch's")
        np_walls, _ = bench.wall(numpy_call, n_it)
        staged = mesh.stage_batch(frames, quality=75, device=dev)
        files = mesh.encode_batch(frames, quality=75, device=dev,
                                  staged=staged)
        if files != ref:
            raise RuntimeError("stage_batch files differ from numpy's")
        staged = mesh.stage_batch(frames, quality=75, device=dev)
        walls = []
        for k in range(n_it):
            t0 = time.perf_counter()
            cur = staged
            staged = mesh.stage_batch(frames, quality=75, device=dev)
            files = mesh.encode_batch(frames, quality=75, device=dev,
                                      staged=cur)
            walls.append(time.perf_counter() - t0)
            if files != ref:
                raise RuntimeError("stage_batch files differ from numpy's")
        return {"frames": U, "shape": [H, W],
                "e2e_upload_mpix_per_s": bench.mpix(U, H, W, _median(walls)),
                "numpy_mpix_per_s": bench.mpix(U, H, W, _median(np_walls)),
                "calls": n_it,
                "note": "stage_batch double-buffered upload; numpy_*: the "
                        "same batch from numpy without stage_batch"}

    def sharded_row(passes=5):
        """bench.py's c11: 3 chunks of the U host frames through stage_batch
        / encode_batch(staged=) over every visible card (MeshConfig()),
        chunk k+1 staged while chunk k encodes; after a warm staged call
        (every entry's pinned buffers and plans made), the median of
        `passes` such passes, host clock."""
        from jpgenc_tpu_torch.config import MeshConfig
        devices = mesh.resolve_devices(MeshConfig(), dev)

        def stage():
            return mesh.stage_batch(frames, quality=75, devices=devices,
                                    device=dev)
        ref = mesh.encode_batch(frames, quality=75, devices=devices,
                                device=dev, staged=stage())
        if ref != outs[:U]:
            raise RuntimeError("batch_sharded files differ from the "
                               "headline's")
        n_chunks, walls = 3, []
        for _ in range(passes):
            staged = stage()
            t0 = time.perf_counter()
            for k in range(n_chunks):
                cur = staged
                if k + 1 < n_chunks:
                    staged = stage()
                files = mesh.encode_batch(frames, quality=75,
                                          devices=devices, device=dev,
                                          staged=cur)
            walls.append(time.perf_counter() - t0)
            if files != ref:
                raise RuntimeError("batch_sharded staged files differ")
        return {"images": n_chunks * U, "shape": [H, W], "passes": passes,
                "devices": [str(d) for d in devices],
                "e2e_mpix_per_s": bench.mpix(n_chunks * U, H, W,
                                             _median(walls)),
                "wall_ms_quartiles": [1e3 * t for t in _quartiles(walls)],
                "note": "3 chunks a pass, double-buffered upload through "
                        "stage_batch, median pass after a warm call "
                        "(bench.py c11)"}

    for name, fn in (("qsweep_dri", qsweep),
                     ("1080p_422_q75", lambda: sub_row("422")),
                     ("1080p_444_q75", lambda: sub_row("444")),
                     ("1080p_islow_q75", islow_row),
                     ("1080p_420_q75_optimized", optimized_row),
                     ("gray512_q75", gray_row),
                     ("4k_optimized", big_optimized_row),
                     ("decode_1080p", decode_row),
                     ("e2e_upload", e2e_row),
                     ("batch_sharded", sharded_row)):
        if name in rows:
            t0 = time.perf_counter()
            configs[name] = fn()
            _log(f"{name} ({time.perf_counter() - t0:.1f} s): "
                 f"{json.dumps(configs[name])}")

    link["end"] = link_probe()
    _log(f"link probe (end): {link['end']}")

    cost_model = {}
    g = max(16, (512 * H // 1080) // 16 * 16)
    for name, (h, w, sub, dri) in (
            ("1080p_420", (H, W, "420", 0)), ("1080p_422", (H, W, "422", 0)),
            ("1080p_444", (H, W, "444", 0)),
            ("1080p_420_dri120", (H, W, "420", 120)),
            ("gray512", (g, g, "gray", 0)),
            ("4k_420", (2 * H, 2 * W, "420", 0))):
        cost_model[name] = {"shape": [h, w],
                            **flops_bytes_estimate(make_layout(h, w, sub,
                                                               dri))}

    detail = {
        "metric": "MPix/s of parallel.mesh.encode_batch, baseline JPEG at "
                  "Q75, RGB 4:2:0, standard tables, device-resident batch "
                  "(median of calls; each call ends in finished bytes)",
        "value": headline, "unit": "MPix/s", "backend": backend,
        "nvidia_smi": card_line, "power_limit_w": power_w,
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "args": vars(args), "seconds": time.perf_counter() - t_start,
        "link_probe": link, "configs": configs, "cost_model": cost_model,
    }
    with open(args.detail, "w") as f:
        json.dump(detail, f, indent=1)
    _log(f"full detail written to {args.detail}")
    _log("DETAIL " + json.dumps(detail))

    def sig(x):
        """Six significant digits for the size-guarded line (the detail
        file keeps every number as measured)."""
        return float(f"{x:.6g}") if isinstance(x, float) else x

    def compact(row):
        keep = {}
        for k in ("mpix_per_s", "bpp", "psnr_db", "e2e_upload_mpix_per_s",
                  "e2e_mpix_per_s",
                  "numpy_mpix_per_s", "download_mpix_per_s",
                  "single_mpix_per_s", "single_dri_mpix_per_s"):
            if k in row:
                keep[k] = sig(row[k])
        dev_only = row.get("device_only_mpix_per_s")
        if isinstance(dev_only, float):         # short key: the line is
            keep["dev"] = sig(dev_only)         # size-guarded
        if "noise_flag" in row:
            keep["noise"] = 1
        return keep

    compact_configs = {
        name: ({q: compact(r) for q, r in row.items()}
               if name == "qsweep_dri" else compact(row))
        for name, row in configs.items()}
    line_obj = {
        "metric": "MPix/s encode_batch Q75 1080p RGB 4:2:0, device-resident",
        "value": sig(headline), "unit": "MPix/s", "backend": backend,
        "power_limit_w": power_w, "configs": compact_configs,
        "detail": os.path.basename(args.detail)}
    line = json.dumps(line_obj, separators=(",", ":"))
    if len(line) > LINE_MAX:
        line_obj["configs"] = {
            name: row.get("mpix_per_s", row.get(
                "e2e_upload_mpix_per_s", row.get("e2e_mpix_per_s")))
            for name, row in compact_configs.items() if name != "qsweep_dri"}
        line_obj["qsweep"] = {
            q: [r.get("mpix_per_s"), r.get("dev")]
            for q, r in compact_configs.get("qsweep_dri", {}).items()}
        line = json.dumps(line_obj, separators=(",", ":"))
    if len(line) > LINE_MAX:
        raise RuntimeError(f"result line of {len(line)} characters")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
