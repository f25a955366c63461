"""Checkpointed batch encode driver (copy of jpgenc_tpu/batch.py, with
`device=` and `devices=` in place of `mesh=`).

Encodes a list of images to files in fixed-size chunks through
`parallel.mesh.encode_batch`, appending one manifest line per finished
image. On restart, finished images (keyed by index + output path) are
skipped, so a killed run resumes idempotently (a failed host means relaunch
from the manifest).
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from jpgenc_tpu_torch import io as _io
from jpgenc_tpu_torch.engine import resolve_device
from jpgenc_tpu_torch.parallel import mesh


@dataclass
class BatchResult:
    done: int          # images finished in this run
    skipped: int       # images already in the manifest
    mpix_per_s: float


def _end_torn_line(path: str) -> None:
    """A run killed in the middle of a manifest write leaves a last line
    without its newline; end it, so the next record starts a line of its
    own instead of being glued to the torn one (which would make the
    following resume redo that image a second time)."""
    if os.path.exists(path) and os.path.getsize(path):
        with open(path, "rb+") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                f.write(b"\n")


def _load_manifest(path: str) -> dict[int, str]:
    done: dict[int, str] = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done[int(rec["index"])] = rec["output"]
                except (ValueError, KeyError):
                    continue   # torn write from a crashed run: redo that image
    return done


def run_batch(images: Sequence[np.ndarray | str] | np.ndarray,
              output_paths: Sequence[str],
              manifest_path: str,
              quality: int = 75,
              subsampling: str = "420",
              restart_interval: int = 0,
              optimize: bool = False,
              chunk_size: int = 16,
              device="cuda",
              dct_method: str = "float",
              encode_chunk: Callable | None = None,
              devices=None) -> BatchResult:
    """Encode images[i] -> output_paths[i] on `device` (or the entries of
    `devices`, as parallel.mesh.resolve_devices takes them: a list or a
    config.MeshConfig) with resume via the manifest. Under several
    processes (parallel.multihost) every process runs the same call: each
    chunk's rows split over the processes, every process writes every file.

    `images` entries may be uint8 arrays or file paths (loaded lazily, one
    chunk at a time, via jpgenc_tpu_torch.io — a large set is never held in
    memory whole). Mixed shapes are grouped so every chunk is a stackable
    same-shape batch. `encode_chunk(imgs, ...)` defaults to
    parallel.mesh.encode_batch, with parallel.mesh.stage_batch starting
    chunk k+1's upload while chunk k encodes; override it for tests / fault
    injection (it is then called without staging).
    """
    if len(images) != len(output_paths):
        raise ValueError("images and output_paths length mismatch")
    dev = resolve_device(device)
    prefetch = encode_chunk is None
    if encode_chunk is None:
        encode_chunk = mesh.encode_batch

    _shapes: dict[int, tuple] = {}

    def _shape_of(i):
        if i not in _shapes:
            item = images[i]
            if isinstance(item, str):
                h, w, ch = _io.probe(item)
                _shapes[i] = (h, w) if ch == 1 else (h, w, ch)
            else:
                _shapes[i] = np.asarray(item).shape
        return _shapes[i]

    def _load(i):
        item = images[i]
        if isinstance(item, str):
            return _io.load(item)
        return np.asarray(item)

    done = _load_manifest(manifest_path)
    todo = [i for i in range(len(images))
            if done.get(i) != output_paths[i]]
    skipped = len(images) - len(todo)
    # group by shape (stable within a group) so chunks stack cleanly
    todo.sort(key=lambda i: (_shape_of(i), i))

    # split chunk boundaries at shape changes
    chunks: list[list[int]] = []
    for i in todo:
        if (chunks and len(chunks[-1]) < chunk_size
                and _shape_of(chunks[-1][0]) == _shape_of(i)):
            chunks[-1].append(i)
        else:
            chunks.append([i])

    def _stage(idxs):
        """Load a chunk and (for the default encoder) start its upload so the
        next chunk's host->device transfer overlaps this chunk's encode.
        File loads run through a thread pool whenever the chunk holds a
        path — image decoding releases the GIL for long stretches."""
        if len(idxs) > 1 and any(isinstance(images[i], str) for i in idxs):
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=min(4, len(idxs))) as ex:
                chunk = np.stack(list(ex.map(_load, idxs)))
        else:
            chunk = np.stack([_load(i) for i in idxs])
        if not prefetch:
            return chunk, None
        return chunk, mesh.stage_batch(chunk, quality=quality,
                                       subsampling=subsampling,
                                       restart_interval=restart_interval,
                                       device=dev, devices=devices)

    px_done = 0
    t0 = time.perf_counter()
    staged_next = _stage(chunks[0]) if chunks else None
    _end_torn_line(manifest_path)
    with open(manifest_path, "a") as mf:
        for ci, idxs in enumerate(chunks):
            chunk, staged = staged_next
            if ci + 1 < len(chunks):
                staged_next = _stage(chunks[ci + 1])
            kwargs = {"staged": staged} if staged is not None else {}
            if dct_method != "float":
                kwargs["dct_method"] = dct_method
            outs = encode_chunk(chunk, quality=quality,
                                subsampling=subsampling,
                                restart_interval=restart_interval,
                                optimize=optimize, device=dev,
                                devices=devices, **kwargs)
            for i, data in zip(idxs, outs):
                with open(output_paths[i], "wb") as f:
                    f.write(data)
                mf.write(json.dumps({"index": i, "output": output_paths[i],
                                     "bytes": len(data)}) + "\n")
                mf.flush()       # manifest line lands only after the file does
                px_done += chunk.shape[1] * chunk.shape[2]
    dt = max(time.perf_counter() - t0, 1e-9)
    return BatchResult(done=len(todo), skipped=skipped,
                       mpix_per_s=px_done / dt / 1e6)
