#!/usr/bin/env python3
"""Multi-process dry run of the port's distribution layer (the counterpart
of `__graft_entry__.dryrun_multichip`): N ranks joined through
`jpgenc_tpu_torch.parallel.multihost` (torch.distributed, gloo), on the CPU
or on the cards (rank i on card i modulo the count, so all on one card
where there is one).

    python dryrun_torch.py --ranks 2 --device cpu
    python dryrun_torch.py --ranks 2 --full

The device is the card unless --device cpu is given. The launcher starts
N copies of this script (--rank i), each with two device entries of
--device, waits for them under --timeout seconds (gloo waits without end
for a peer that died) and prints each rank's line, one JSON object after
the word DRYRUN. Every rank runs:

  * encode_batch split over the ranks and their entries: fused, optimize
    and islow, and the device-resident transcode (mesh.decode_batch's
    per-entry tensors straight back into encode_batch);
  * a colour encode_striped, even and ragged (fused and optimize), a
    ragged gray one, again with optimize and a pure-padding stripe, and an
    islow + optimize stripe lane at a non-MCU height;
  * mesh.decode_batch of the batch files and of the striped file, and its
    to_device=False, which raises under several processes;

and asserts that each file equals the single-process port's (api.encode on
the rank itself), each of its own decoded rows api.decode's pixels, and
that neither JAX nor the JAX package was imported. The line carries the
kernel launches and plain-version calls that the rank's distributed calls
made (`launches`; those of the api.encode / api.decode references are not
counted): on the card every plain count is 0, on the CPU every launch is.
With --full it also encodes 16 x 1080p frames (fixtures.synth_batch) split
by rank and one 4320 x 7680 frame in 6 stripes, a warm call and three
timed calls each, the ranks starting each call together, and prints their
launches (`launches_full`), their SHA-256 for the caller to compare with
its own files, the wall of each timed call (host clock, the exchange
included), and two parts of the batch call timed alone: the upload of the
rank's own rows and the exchange. Exits non-zero when a rank fails or the
timeout passes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args) -> int:
    """Start the ranks, wait for them all under the timeout, print their
    lines; kill every rank still running at the end (exact pids)."""
    port = _free_port()
    cmd = [sys.executable, os.path.abspath(__file__), "--ranks",
           str(args.ranks), "--device", args.device, "--port", str(port)]
    if args.full:
        cmd.append("--full")
    procs = [subprocess.Popen(cmd + ["--rank", str(i)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(args.ranks)]
    deadline = time.monotonic() + args.timeout
    outs, rc = [], 0
    try:
        for i, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"dryrun: rank {i} passed the {args.timeout} s "
                      "timeout", file=sys.stderr)
                return 1
            outs.append(out)
            if p.returncode != 0:
                print(f"dryrun: rank {i} exited {p.returncode}:\n"
                      f"{err[-3000:]}", file=sys.stderr)
                rc = 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = [ln for out in outs for ln in out.splitlines()
             if ln.startswith("DRYRUN ")]
    if rc == 0 and len(lines) != args.ranks:
        print(f"dryrun: {len(lines)} rank lines, expected {args.ranks}",
              file=sys.stderr)
        rc = 1
    for ln in lines:
        print(ln, flush=True)
    return rc


#: kernel name -> (module under jpgenc_tpu_torch.ops.cuda, its counter)
KERNEL_COUNTERS = {
    "k1a_fused": ("k1a_fused", "launches"),
    "k1a_gray": ("k1a_fused", "launches_gray"),
    "seg_merge": ("seg_merge", "launches"),
    "k1_dct": ("k1_dct", "launches"),
    "k1_dense_repack": ("k1_dct", "launches_repack"),
    "k1_color": ("k1_dct", "launches_color"),
    "k1_gray": ("k1_dct", "launches_gray"),
    "block_pack": ("block_pack", "launches"),
    "symbol_hist": ("symbol_hist", "launches"),
    "recon": ("recon", "launches"),
    "recon_gray": ("recon", "launches_gray"),
}


def read_counters() -> dict[str, int]:
    """Every kernel wrapper's launch count, and `plain_calls` summed over
    the wrappers (the calls that took the plain version: CPU tensors)."""
    import importlib
    mods = {m: importlib.import_module(f"jpgenc_tpu_torch.ops.cuda.{m}")
            for m, _ in KERNEL_COUNTERS.values()}
    counts = {k: getattr(mods[m], a) for k, (m, a) in KERNEL_COUNTERS.items()}
    counts["plain_calls"] = sum(m.plain_calls for m in mods.values())
    return counts


def rank_main(args) -> int:
    """One rank: join the group, run every case, print one line."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from jpgenc_tpu_torch import api
    from jpgenc_tpu_torch.parallel import mesh, multihost
    from jpgenc_tpu_torch.utils.fixtures import synth_batch, synth_frame

    t0 = time.perf_counter()
    torch.set_num_threads(1 if args.device == "cpu" else 4)
    multihost.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                         num_processes=args.ranks, process_id=args.rank)
    if multihost.process_count() != args.ranks:
        raise RuntimeError("the process group did not form")
    # each rank on its own card where there are enough, else sharing them
    dev = args.device if args.device == "cpu" else \
        f"cuda:{args.rank % max(1, torch.cuda.device_count())}"
    entries = [dev, dev]
    cases = 0
    tally = dict.fromkeys(read_counters(), 0)

    def counted(fn, *a, into=tally, **kw):
        """Call one of mesh's distributed entry points and add the launches
        and plain calls it made to `into`."""
        before = read_counters()
        out = fn(*a, **kw)
        for k, v in read_counters().items():
            into[k] += v - before[k]
        return out

    def check(ok, what):
        nonlocal cases
        if not ok:
            raise AssertionError(f"rank {args.rank}: {what}")
        cases += 1

    # the batch path: uneven over ranks x entries
    n_img = 2 * args.ranks + 1
    imgs = np.stack([synth_frame(32, 48, seed=40 + i) for i in range(n_img)])
    for kw in ({}, {"optimize": True}, {"dct_method": "islow"}):
        outs = counted(mesh.encode_batch, imgs, quality=75, devices=entries,
                       device=dev, **kw)
        check(len(outs) == n_img and all(
            outs[i] == api.encode(imgs[i], quality=75, device=dev, **kw)
            for i in range(n_img)), f"encode_batch {kw}")
    files = counted(mesh.encode_batch, imgs, quality=75, devices=entries,
                    device=dev)

    # the batch-split decode: this rank's rows, per entry
    own = multihost.owned_indices(n_img)
    pix = counted(mesh.decode_batch, files, devices=entries, device=dev)
    rows = torch.cat([p.cpu() for p in pix]).numpy()
    check(len(rows) == len(own) and all(
        np.array_equal(rows[k], api.decode(files[i], device=dev))
        for k, i in enumerate(own)), "decode_batch of the batch files")
    if args.ranks > 1:
        try:
            mesh.decode_batch(files, devices=entries, to_device=False,
                              device=dev)
        except ValueError:
            check(True, "to_device=False raises under processes")
        else:
            check(False, "to_device=False must raise under processes")
    # the device-resident transcode: per-entry tensors back into the encode
    again = counted(mesh.encode_batch, pix, quality=75, devices=entries,
                    device=dev)
    host = np.stack([api.decode(f, device=dev) for f in files])
    check(again == mesh.encode_batch(host, quality=75, device=dev),
          "device-resident transcode")

    # stripes: colour even and ragged (7 MCU rows over 4 stripes, fused
    # and optimize), ragged gray with a pure-padding stripe, and an islow +
    # optimize lane at a non-MCU height
    img_c = synth_frame(64, 48, seed=50)
    check(counted(mesh.encode_striped, img_c, 4, devices=entries,
                  device=dev)
          == api.encode(img_c, restart_interval=3, device=dev),
          "colour striped")
    img_cr = synth_frame(112, 48, seed=53)
    for optimize in (False, True):
        check(counted(mesh.encode_striped, img_cr, 4, restart_interval=3,
                      optimize=optimize, devices=entries, device=dev)
              == api.encode(img_cr, restart_interval=3, optimize=optimize,
                            device=dev),
              f"ragged colour striped, optimize={optimize}")
    img_r = synth_frame(56, 64, seed=51)[:, :, 0].copy()   # 7 MCU rows
    for ns, optimize in ((3, False), (5, True)):
        striped = counted(mesh.encode_striped, img_r, ns, restart_interval=8,
                          optimize=optimize, devices=entries, device=dev)
        check(striped == api.encode(img_r, restart_interval=8,
                                    optimize=optimize, device=dev),
              f"ragged gray striped, {ns} stripes, optimize={optimize}")
    img_o = synth_frame(56, 48, seed=52)                   # 3.5 MCU rows
    check(counted(mesh.encode_striped, img_o, 2, optimize=True,
                  dct_method="islow", devices=entries, device=dev)
          == api.encode(img_o, restart_interval=6, optimize=True,
                        dct_method="islow", device=dev),
          "islow + optimize stripe lane")
    pix_s = counted(mesh.decode_batch, [striped] * n_img, devices=entries,
                    device=dev)
    want = api.decode(striped, device=dev)
    check(all(np.array_equal(p.cpu().numpy()[k], want)
              for p in pix_s for k in range(p.shape[0])),
          "decode_batch of the striped file")

    if any(m.split(".")[0] in ("jax", "jaxlib", "jpgenc_tpu")
           for m in sys.modules):
        raise RuntimeError("jax or the JAX package was imported")
    line = {"rank": args.rank, "ranks": args.ranks, "device": dev,
            "entries": len(entries), "cases": cases, "own_rows": len(own),
            "launches": tally}
    if args.full:
        frames = synth_batch(1080, 1920, 16)
        frame8k = synth_frame(4320, 7680)
        walls = {"batch_16x1080p": [], "striped_8k_6": []}
        tally_full = dict.fromkeys(tally, 0)
        for k in range(4):            # call 0 builds the plans, untimed
            multihost.gather_bytes(b"")         # the ranks start together
            t1 = time.perf_counter()
            batch = counted(mesh.encode_batch, frames, quality=75,
                            devices=entries, device=dev, into=tally_full)
            t2 = time.perf_counter()
            multihost.gather_bytes(b"")
            t3 = time.perf_counter()
            striped8k = counted(mesh.encode_striped, frame8k, 6, quality=75,
                                devices=entries, device=dev,
                                into=tally_full)
            t4 = time.perf_counter()
            if k:
                walls["batch_16x1080p"].append(t2 - t1)
                walls["striped_8k_6"].append(t4 - t3)
        line["launches_full"] = tally_full
        line["sha256"] = {
            "batch_16x1080p": hashlib.sha256(b"".join(batch)).hexdigest(),
            "striped_8k_6": hashlib.sha256(striped8k).hexdigest()}
        line["wall_s"] = {k: [round(t, 4) for t in v]
                          for k, v in walls.items()}
        # two parts of the batch call, each alone after the ranks meet:
        # this rank's rows uploaded from numpy (pageable, as the call does)
        # and the exchange of the whole list's bytes
        own = multihost.owned_indices(len(frames))
        parts = {"upload_own_rows": [], "exchange_16_files": []}
        blob = {i: batch[i] for i in own}
        for _ in range(3):
            multihost.gather_bytes(b"")
            t1 = time.perf_counter()
            if len(own):
                torch.from_numpy(frames[own.start:own.stop]).to(dev)
            if dev != "cpu":
                torch.cuda.synchronize(dev)
            parts["upload_own_rows"].append(time.perf_counter() - t1)
            multihost.gather_bytes(b"")
            t1 = time.perf_counter()
            mesh._exchange_rows(blob)
            parts["exchange_16_files"].append(time.perf_counter() - t1)
        line["part_s"] = {k: [round(t, 4) for t in v]
                          for k, v in parts.items()}
    line["seconds"] = round(time.perf_counter() - t0, 3)
    print("DRYRUN " + json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--full", action="store_true",
                    help="add the 16 x 1080p batch and the 8K striped frame")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds the launcher waits for every rank")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.ranks < 1:
        ap.error("--ranks must be at least 1")
    return launch(args) if args.rank is None else rank_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
