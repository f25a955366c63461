"""Distribution layer (counterpart of jpgenc_tpu/parallel/mesh.py): batched
encode and decode over a list of devices and over processes, and stripe
mode, one large image cut into MCU-row stripes.

- **Device lists.** A batch of same-shape images splits into contiguous
  runs of rows, one per device entry; a list may name one device more than
  once (entries on one device share its cached plan and run in order on
  its stream). Every entry's kernels are enqueued before any entry's
  results are fetched, so entry k+1's kernels run while entry k's bytes
  cross and are finalized (the reference's `_fetch_scan_rows` phases).
- **Stripes.** One image's MCU rows split into stripes whose boundaries
  are restart boundaries: each stripe's entropy segments are byte-aligned
  and DC-reset, so the stripes encode as one batch of independent
  sub-images and their segments join into ONE scan with RSTn numbered by
  the global segment index. The file equals the unstriped encode's at the
  same restart interval, byte for byte.
- **Processes.** Under `parallel.multihost` each process encodes (decodes)
  the rows or stripes of `owned_indices` on its own entries; the finished
  bytes are exchanged on the host, so every process returns the whole list
  or file, and striped optimize sums its symbol counts across processes.
  Nothing crosses between devices but what the host holds already, so no
  device collective is needed.
"""
from __future__ import annotations

import pickle
import threading

import numpy as np
import torch

from jpgenc_tpu_torch import config, decoder
from jpgenc_tpu_torch.container.parser import parse_jpeg
from jpgenc_tpu_torch.engine import (EOI, EncodeJob, as_device_batch,
                                     get_plan, jfif_headers,
                                     luts_from_tables, resolve_device,
                                     tables_from_freq, to_host_async)
from jpgenc_tpu_torch.layout import make_layout
from jpgenc_tpu_torch.ops.cuda.block_pack import packed_tables
from jpgenc_tpu_torch.parallel import multihost
from jpgenc_tpu_torch.utils.profiling import span


def resolve_devices(devices=None, device="cuda") -> list[torch.device]:
    """The device entries of a call (the counterpart of make_mesh,
    mesh.py:56-75). None gives [device]; a list gives its entries, each
    through engine.resolve_device (one device may appear more than once); a
    MeshConfig gives batch x stripe entries, batch-major, taken from the
    visible CUDA devices when device is "cuda" and raising as make_mesh
    does when it asks for more than exist, or `device` repeated when that is
    the CPU, which has no count (batch=0 then means one)."""
    if devices is None:
        return [resolve_device(device)]
    if isinstance(devices, config.MeshConfig):
        dev = resolve_device(device)
        b, s = devices.batch, devices.stripe
        if dev.type == "cpu":
            return [dev] * ((b or 1) * s)
        n = torch.cuda.device_count()
        if s > n:
            raise ValueError(f"stripe={s} exceeds {n} available devices")
        if b == 0:
            b = n // s
        if b * s > n:
            raise ValueError(f"mesh {b}x{s} exceeds {n} available devices")
        return [torch.device("cuda", i) for i in range(b * s)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("the device list is empty")
    return devs


def _split(n: int, k: int) -> list[range]:
    """range(n) in k contiguous runs of ceil(n / k) (the last ones shorter
    or empty)."""
    per = -(-n // k)
    return [range(min(i * per, n), min((i + 1) * per, n)) for i in range(k)]


def _owned_split(n_items: int, devs: list) -> list[tuple]:
    """(device, item indices) per entry: this process's items
    (multihost.owned_indices) split contiguously over its entries. An entry
    may get none."""
    own = multihost.owned_indices(n_items)
    return [(d, range(own.start + r.start, own.start + r.stop))
            for d, r in zip(devs, _split(len(own), len(devs)))]


def _exchange_rows(rows: dict[int, bytes]) -> dict[int, bytes]:
    """All-gather per-row host byte blobs across processes (mesh.py:160-170):
    every process gets every row. The blobs are pickles this program wrote."""
    if multihost.process_count() == 1:
        return rows
    merged: dict[int, bytes] = {}
    for blob in multihost.gather_bytes(pickle.dumps(rows)):
        merged.update(pickle.loads(blob))
    return merged


_upload_streams: dict[torch.device, torch.cuda.Stream] = {}
_upload_lock = threading.Lock()


def _upload_stream(dev: torch.device):
    """The side stream stage_batch uploads on, one per device."""
    with _upload_lock:
        if dev not in _upload_streams:
            _upload_streams[dev] = torch.cuda.Stream(dev)
        return _upload_streams[dev]


def stage_batch(imgs, quality: int = 75, subsampling: str = "420",
                restart_interval: int = 0, device="cuda", devices=None):
    """Start the host -> device upload of a [B, H, W(, 3)] uint8 batch and
    return the staged handle for encode_batch(..., staged=...):
    (imgs, [(tensor, event)] with one pair per device entry, in the order
    of resolve_devices(devices, device)), each holding the entry's rows of
    this process's share.

    On CUDA this process's rows are copied into pinned memory once, and
    each entry's rows are uploaded from it with non_blocking=True on that
    device's side stream, with an event recorded behind the copy, so the
    call returns while the bytes cross:
    staging batch k+1 while batch k encodes overlaps upload with compute
    (the double-buffered input of batch.run_batch). On the CPU the tensor
    is the rows themselves and the event is None. The plans for the batch's
    geometry are built here too, as the reference's _batch_setup does. The
    pinned copy is the span `jpgenc.stage.pin`."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              restart_interval=restart_interval)
    devs = resolve_devices(devices, device)
    imgs = np.ascontiguousarray(imgs)
    host = as_device_batch(imgs, torch.device("cpu"))
    mode = "gray" if host.dim() == 3 else cfg.subsampling
    own = multihost.owned_indices(len(imgs))
    pinned = None
    if any(d.type == "cuda" for d in devs) and len(own):
        with span("jpgenc.stage.pin"):
            pinned = host[own.start:own.stop].pin_memory()
    handles = []
    for dev, rows in _owned_split(len(imgs), devs):
        get_plan(host.shape[1], host.shape[2], mode, cfg.quality, str(dev),
                 cfg.restart_interval)
        if dev.type != "cuda" or not len(rows):
            handles.append((host[rows.start:rows.stop], None))
            continue
        stream = _upload_stream(dev)
        with torch.cuda.stream(stream):
            t = pinned[rows.start - own.start:rows.stop - own.start].to(
                dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        handles.append((t, event))
    return imgs, handles


def _staged_tensor(staged, dev: torch.device) -> torch.Tensor:
    """The device batch of one stage_batch pair, made safe to use on the
    current stream: the stream waits for the upload's event, and the tensor
    is marked as used there, so the caching allocator does not hand its
    memory out while the current stream's kernels still read it."""
    t, event = staged
    if t.device != dev:
        raise ValueError(f"staged batch lives on {t.device}, not on {dev}")
    if event is not None:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(event)
        t.record_stream(stream)
    return t


def _batch_parts(imgs, staged, devs) -> tuple[int, list[tuple]]:
    """(B, [(device, global rows, device tensor)] for each entry with rows)
    from any of encode_batch's input forms."""
    if staged is not None:
        imgs, handles = staged
        split = _owned_split(len(imgs), devs)
        if len(handles) != len(split):
            raise ValueError(f"staged for {len(handles)} device entries, "
                             f"encoding on {len(split)}")
        return len(imgs), [(d, r, as_device_batch(_staged_tensor(h, d), d))
                           for (d, r), h in zip(split, handles) if len(r)]
    if isinstance(imgs, (list, tuple)) and imgs \
            and all(isinstance(t, torch.Tensor) for t in imgs):
        # per-entry tensors, as mesh.decode_batch(to_device=True, devices=)
        # returns them: this process's rows, already split
        if len(imgs) != len(devs):
            raise ValueError(f"{len(imgs)} per-entry tensors for "
                             f"{len(devs)} device entries")
        counts = [int(t.shape[0]) for t in imgs]
        b = int(multihost.sum_array(np.array([sum(counts)]))[0])
        own = multihost.owned_indices(b)
        if len(own) != sum(counts):
            raise ValueError(f"{sum(counts)} rows given where this process "
                             f"owns {len(own)} of {b}")
        starts = own.start + np.cumsum([0] + counts)
        return b, [(d, range(int(starts[k]), int(starts[k + 1])),
                    as_device_batch(t, d))
                   for k, (d, t) in enumerate(zip(devs, imgs)) if counts[k]]
    if isinstance(imgs, torch.Tensor):
        b, n = imgs.shape[0], len(devs) * multihost.process_count()
        if n > 1 and b % n:
            raise ValueError(
                f"device-resident batch of {b} must be a multiple of the "
                f"{n} device entries (host batches split unevenly)")
        if all(imgs.device != d for d in devs):
            raise ValueError(f"tensor input lives on {imgs.device}, not on "
                             f"{sorted({str(d) for d in devs})}")
        return b, [(d, r, as_device_batch(
            imgs[r.start:r.stop].to(d, non_blocking=True), d))
            for d, r in _owned_split(b, devs) if len(r)]
    imgs = np.ascontiguousarray(imgs)
    return len(imgs), [(d, r, as_device_batch(imgs[r.start:r.stop], d))
                       for d, r in _owned_split(len(imgs), devs) if len(r)]


def _retry(job, j: int) -> bytes:
    """Row j of a job alone at the worst tier (w_blk 56, which cannot
    overflow): the span `jpgenc.retry`, and inside it one span of why the
    row overflowed tiers[0] (job.causes): `jpgenc.retry.block` or
    `jpgenc.retry.stream`."""
    with span("jpgenc.retry"), span("jpgenc.retry." + job.causes[j]):
        return job.climb(j, job.tiers[-1:])


def encode_batch(imgs, quality: int = 75, subsampling: str = "420",
                 restart_interval: int = 0, optimize: bool = False,
                 dct_method: str = "float", device="cuda", staged=None,
                 devices=None) -> list[bytes]:
    """Encode a [B, H, W, 3] RGB or [B, H, W] gray uint8 batch; one JFIF
    bytestring per image, identical to per-image `api.encode`, with every
    mode it takes (restart_interval, optimize, dct_method).

    devices: None (one entry, `device`), a list of devices, or a
    config.MeshConfig (resolve_devices). The rows split contiguously over
    the entries; each entry's rows are one engine.EncodeJob on its
    device's plan, every entry's kernels are enqueued before any result is
    fetched, and the files come back in row order. Under several processes
    (parallel.multihost) each encodes the rows of owned_indices(B) on its
    own entries and every process returns the whole list.

    imgs is a numpy array (each entry's rows uploaded once), a uint8 tensor
    on one of the entries' devices (the device-resident producer interface,
    mesh.py:382-386; the other entries' rows cross with non_blocking
    copies, and B must be a multiple of the entries, as the reference's
    mesh requires), or the list of per-entry tensors that
    decode_batch(to_device=True, devices=...) returns (the device-resident
    transcode). The whole batch runs at the tight tier; an image that
    overflows it is re-encoded alone at the worst tier (w_blk=56), which
    cannot overflow (mesh.py:446-469). With optimize=True every image gets
    its own Huffman tables (mesh.py:403-416): pass 1 is K1 (islow: the
    integer pipeline) + per-image histograms, the host builds the tables,
    pass 2 codes the cached coefficients with per-image tables. With islow
    and the standard tables pass 2 codes them with the shared tables
    (mesh.py:420-422). Whenever coefficients are cached the worst-tier
    retry reuses them.

    staged takes the result of stage_batch(imgs, ..., devices=) to use an
    upload already in flight (its batch replaces imgs); the files are the
    same bytes as without it."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              restart_interval=restart_interval,
                              optimize_huffman=optimize, dct_method=dct_method)
    devs = resolve_devices(devices, device)
    b, parts = _batch_parts(imgs, staged, devs)
    local: dict[int, bytes] = {}
    mode = "gray" if parts and parts[0][2].dim() == 3 else cfg.subsampling
    jobs = [(rows, EncodeJob(get_plan(x.shape[1], x.shape[2], mode,
                                      cfg.quality, str(d),
                                      cfg.restart_interval), cfg, x))
            for d, rows, x in parts]
    for _, job in jobs:
        job.first_pass()
    for _, job in jobs:
        job.second_pass()
    for rows, job in jobs:
        for j, (i, f) in enumerate(zip(rows, job.finish())):
            local[i] = f if f is not None else _retry(job, j)
    full = _exchange_rows(local)
    return [full[i] for i in range(b)]


# ---------------------------------------------------------------------------
# Stripe mode: one large image as a batch of MCU-row stripes
# ---------------------------------------------------------------------------

def _stripe_geometry(layout_h: int, mcu_h: int, n_stripes: int) -> int:
    """Rows of MCUs per stripe (ceil — the tail stripe may be ragged)."""
    mcu_rows = layout_h // mcu_h
    if n_stripes > mcu_rows:
        raise ValueError(
            f"{n_stripes} stripes exceed the image's {mcu_rows} MCU rows")
    return -(-mcu_rows // n_stripes)


def _stripe_devices(devices, device, n_stripes: int) -> list[torch.device]:
    """encode_striped's entries: a MeshConfig gives its stripe count of
    devices, or the most devices (at most n_stripes) when stripe is 1, cut
    down to a divisor of n_stripes (mesh.py:533-539); otherwise as
    resolve_devices."""
    if not isinstance(devices, config.MeshConfig):
        return resolve_devices(devices, device)
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else n_stripes
    ns = devices.stripe if devices.stripe > 1 else min(n, n_stripes)
    while n_stripes % ns:
        ns -= 1
    return resolve_devices(config.MeshConfig(batch=1, stripe=ns), device)


def _stripe_batch(img: np.ndarray, rows: range, stripe_h: int,
                  dev: torch.device) -> torch.Tensor:
    """Stripes rows.start..rows.stop of the frame as [n, stripe_h, W(, 3)]
    on dev: the frame's own pixel rows uploaded as they are, and the rows
    below the image (the ragged tail, a stripe past the image) the last
    row repeated — the reference's host edge pad (mesh.py:576-586), made
    on the device instead of in a host copy of the whole frame."""
    h = img.shape[0]
    a, b = rows.start * stripe_h, rows.stop * stripe_h
    parts = [torch.from_numpy(img[a:min(b, h)]).to(dev)] if a < h else []
    if b > max(a, h):
        last = torch.from_numpy(img[h - 1:h]).to(dev)
        parts.append(last.expand((b - max(a, h),) + img.shape[1:]))
    x = torch.cat(parts) if len(parts) > 1 else parts[0]
    return as_device_batch(x.reshape((len(rows), stripe_h) + img.shape[1:]),
                           dev)


def encode_striped(img, n_stripes: int, quality: int = 75,
                   subsampling: str = "420", restart_interval: int = 0,
                   optimize: bool = False, devices=None,
                   dct_method: str = "float", device="cuda") -> bytes:
    """Encode ONE [H, W, 3] RGB or [H, W] gray uint8 image as n_stripes
    MCU-row stripes; the file equals api.encode(img, restart_interval=r)
    byte for byte, r being the interval the file carries.

    The file carries restart markers at (at least) stripe boundaries:
    `restart_interval` of 0 selects one segment per stripe, i.e. DRI = MCUs
    per stripe; otherwise `restart_interval` must divide the MCU count of a
    stripe. When the MCU rows do not divide evenly into n_stripes (the
    RAGGED case) every stripe still gets the same padded sub-image shape,
    the tail stripe's padding-row segments are dropped from the scan (a
    stripe past the image is dropped whole), and the default DRI becomes one
    MCU row; an explicit `restart_interval` must then divide the MCUs per
    row.

    The stripes are one batch of sub-images under one plan, an
    engine.EncodeJob an entry (K1A and the merge tail; optimize or islow:
    pass 1, then kernel A with ONE shared table set). With optimize the per-stripe histograms are summed on the
    host, with the stripes that hold padding rows (and the islow tail)
    counted under their true-height layout instead, so the tables equal the
    unstriped encode's. With dct_method="islow" the last live stripe is
    re-encoded under its true-height layout when the image height is not an
    MCU multiple (libjpeg's dummy rows exist only at the true bottom edge).

    devices (None, a list, or a config.MeshConfig, whose stripe count picks
    the entries as the reference's does) splits the stripes into contiguous
    runs, one per entry; under several processes each owns the stripes of
    owned_indices(n_stripes), sums the histogram with the others and
    exchanges its stripes' bytes."""
    cfg = config.EncodeConfig(quality=quality, subsampling=subsampling,
                              optimize_huffman=optimize, dct_method=dct_method)
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError("image must be uint8")
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"expected [H, W, 3] RGB or [H, W] gray, got "
                         f"{img.shape}")
    if n_stripes < 1:
        raise ValueError(f"n_stripes must be at least 1, got {n_stripes}")
    devs = _stripe_devices(devices, device, n_stripes)
    q, islow = cfg.quality, cfg.dct_method == "islow"
    mode = "gray" if img.ndim == 2 else cfg.subsampling
    h, w = img.shape[0], img.shape[1]
    full = make_layout(h, w, mode)     # probe for MCU geometry/padding
    mcu_h = full.mcu_h
    mcu_rows = full.comps[0].plane_h // mcu_h
    rows_per_stripe = _stripe_geometry(full.comps[0].plane_h, mcu_h,
                                       n_stripes)
    mcus_per_stripe = rows_per_stripe * full.mcus_x
    if mcu_rows % n_stripes:
        # kept segments must cover whole REAL MCU rows so the tail stripe's
        # padding rows form droppable whole segments
        r = restart_interval or full.mcus_x
        if full.mcus_x % r:
            raise ValueError(
                "ragged stripe split: restart_interval must divide the "
                f"{full.mcus_x} MCUs per row")
    else:
        r = restart_interval or mcus_per_stripe
        if mcus_per_stripe % r:
            raise ValueError("restart_interval must divide MCUs per stripe")
    # real MCU rows covered by stripe s (the ragged tail keeps fewer; a
    # stripe past the image keeps none and is dropped entirely)
    rows_kept = [min(rows_per_stripe, max(0, mcu_rows - s * rows_per_stripe))
                 for s in range(n_stripes)]
    segs_kept = [rk * full.mcus_x // r for rk in rows_kept]
    seg_off = np.concatenate([[0], np.cumsum(segs_kept)]).astype(int)
    last_live = max(s for s in range(n_stripes) if segs_kept[s] > 0)
    # the n-th stripe's RSTn count: one after every kept segment but the
    # scan's last
    rst = [(int(seg_off[s]), segs_kept[s] - (s == last_live), segs_kept[s])
           for s in range(n_stripes)]

    # the frame, edge-padded out to the equal-stripe height, is a batch of
    # stripe sub-images (_stripe_batch). Width stays the TRUE image width:
    # each stripe's layout applies api.encode's horizontal edge rule (for
    # islow, libjpeg's dummy columns) instead of seeing pre-padded pixels.
    stripe_h = rows_per_stripe * mcu_h
    stripe_layout = make_layout(stripe_h, w, mode, r)
    assert stripe_layout.n_segments == mcus_per_stripe // r
    # libjpeg's vertical dummy-row geometry exists only where the TRUE
    # bottom edge sits mid-MCU, in the last live stripe: islow re-encodes
    # it under its true-height layout (the float path's edge replication
    # equals api.encode's as it is)
    tail_fix = islow and h % mcu_h != 0
    tail_h = h - last_live * stripe_h
    tail_img = img[last_live * stripe_h:h]
    if tail_fix:
        assert make_layout(tail_h, w, mode, r).n_segments \
            == segs_kept[last_live]
    jobs = [(rows, EncodeJob(get_plan(stripe_h, w, mode, q, str(d), r), cfg,
                             _stripe_batch(img, rows, stripe_h, d),
                             rst=[rst[s] for s in rows]))
            for d, rows in _owned_split(n_stripes, devs) if len(rows)]
    for _, job in jobs:
        job.first_pass()

    def true_tail(dev):
        """The last live stripe under its true-height layout on `dev`, its
        pass 1 enqueued."""
        job = EncodeJob(get_plan(tail_h, w, mode, q, str(dev), r), cfg,
                        as_device_batch(tail_img[None], dev),
                        rst=[rst[last_live]])
        job.first_pass()
        return job

    tail = shared = dc_tables = ac_tables = None
    if optimize:
        # the stripes' histograms summed on the host (the reference's psum),
        # a stripe that holds padding rows (or the islow tail) counted under
        # its true-height layout instead; then over the processes
        fix = {s for s in range(n_stripes) if rows_kept[s] < rows_per_stripe}
        if tail_fix:
            fix.add(last_live)
        freq = np.zeros((2, 2, 256), np.int64)
        for rows, job in jobs:
            hist = to_host_async(job.hist).wait()
            for j, s in enumerate(rows):
                if s not in fix:
                    freq += hist[j]
                elif rows_kept[s]:
                    tail = true_tail(job.x.device)
                    freq += to_host_async(tail.hist).wait()[0]
        freq = multihost.sum_array(freq)
        dc_tables, ac_tables = tables_from_freq(
            freq, 1 if stripe_layout.is_gray else 2)
        shared = packed_tables(luts_from_tables(dc_tables, ac_tables))
    for _, job in jobs:
        job.second_pass(shared)

    local: dict[int, bytes] = {}
    for rows, job in jobs:
        scans = job.finish()
        for j, s in enumerate(rows):
            if segs_kept[s] == 0:
                local[s] = b""        # pure-padding stripe past the image
            elif s == last_live and tail_fix:
                tail = tail or true_tail(job.x.device)
                tail.tables(job.tabs)
                local[s] = tail.climb(0, tail.tiers[-1:])
            else:
                local[s] = scans[j] if scans[j] is not None \
                    else _retry(job, j)
    full_rows = _exchange_rows(local)
    scan = b"".join(full_rows[s] for s in range(n_stripes))

    # headers describe the WHOLE image with DRI = r
    file_layout = make_layout(h, w, mode, r)
    assert file_layout.n_segments == int(seg_off[-1]), \
        "stripe segment accounting disagrees with the file layout"
    return jfif_headers(file_layout, q, dc_tables, ac_tables) + scan + EOI


# ---------------------------------------------------------------------------
# Batch decode over device entries (the inverse of encode_batch)
# ---------------------------------------------------------------------------

def decode_batch(datas: list[bytes], devices=None, to_device: bool = True,
                 device="cuda"):
    """Decode same-geometry baseline JPEGs split over device entries
    (mesh.py:741-955, over decoder._recon_jobs: host entropy decode, the
    smallest upload form, the reconstruction kernel), each entry's rows
    contiguous, each image decoded once. Under several processes each
    process decodes only the rows of owned_indices(B). Mixed geometry
    (height, width, subsampling, restart interval) raises ValueError.

    to_device=True returns the pixels on the devices: with devices=None one
    [rows, H, W(, 3)] uint8 tensor, as api.decode_batch(to_device=True)
    does; with a device list the list of per-entry tensors in entry order
    (an entry without rows gets an empty one), which encode_batch takes as
    it is. to_device=False returns one numpy array per image, in a single
    process only: pixels are never gathered across processes."""
    if not datas:
        return []
    devs = resolve_devices(devices, device)
    if not to_device and multihost.process_count() > 1:
        raise ValueError("to_device=False under several processes: pixels "
                         "are not gathered across processes — use "
                         "to_device=True and read this process's rows")
    parsed = [parse_jpeg(d) for d in datas]
    if not decoder.same_geometry(parsed):
        raise ValueError("decode_batch requires same-geometry inputs "
                         "(height, width, subsampling, restart interval)")
    p0 = parsed[0]
    shape = (p0.height, p0.width) + (() if len(p0.comps) == 1 else (3,))
    outs = []
    for d, rows in _owned_split(len(datas), devs):
        if not len(rows):
            outs.append(torch.empty((0,) + shape, dtype=torch.uint8,
                                    device=d))
            continue
        layout, jobs = decoder._recon_jobs(parsed[rows.start:rows.stop],
                                           None)
        outs.append(decoder._run(layout, jobs[0](), d))
    if to_device:
        return outs[0] if devices is None else outs
    return [a[i] for o in outs for a in (o.cpu().numpy(),)
            for i in range(a.shape[0])]
