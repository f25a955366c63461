"""Tracing and profiling utilities (counterpart of
jpgenc_tpu/utils/profiling.py).

- `span(name)` marks a stretch of the port's host work (names start with
  `jpgenc.`) as a range of the running `torch.profiler`, on the same clock
  as the cards' kernels and copies; with no profiler running it is one
  shared no-op context, so a span costs one check.
- `trace(dir)` is a `torch.profiler.profile` context over CPU and CUDA
  activity; it exports a Chrome trace (Perfetto, chrome://tracing) into the
  directory.
- `StageTimer` gives per-stage wall times that cover the device's work: a
  stage ends with a `torch.cuda.synchronize` on the device of the output
  registered with `force` (on the CPU nothing is pending, so it only reads
  the clock).
- `flops_bytes_estimate(layout)` is the roofline-style cost model of one
  encode of the given frame layout (a copy of the reference's, numpy only).
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler range over the `with` block while a profiler runs, else a
    no-op. The range is a function-scope RecordFunction: the profiler keeps
    it among the calling thread's host operations (a `record_function`
    range is a user annotation instead) and gives it no copy on a card's
    timeline. The range type is private to torch, so it is
    imported only while a profiler runs: without it the port still imports
    and encodes, and only tracing fails."""
    if torch.autograd._profiler_enabled():
        from torch._C._profiler import _RecordFunctionFast
        return _RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a CPU + CUDA trace; writes `log_dir/trace.json` on exit."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(out):
    """The first tensor found in a (nested) tuple / list / dict, or None."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for item in out:
            t = _first_tensor(item)
            if t is not None:
                return t
    return None


@dataclass
class StageTimer:
    """Forced-completion stage timing: `with t.stage("name"): out = f()`.

    A stage whose output was registered with `t.force(out)` ends with a
    synchronize of that output's CUDA device, so the recorded time covers
    the device's execution, not only the enqueue.
    """
    records: dict[str, float] = field(default_factory=dict)
    _out: object = None

    def force(self, out):
        self._out = out
        return out

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        self._out = None
        yield self
        t = _first_tensor(self._out)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
        self.records[name] = self.records.get(name, 0.0) + \
            (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.records.values()) or 1.0
        lines = [f"{k:32s} {v * 1e3:9.2f} ms  {100 * v / total:5.1f}%"
                 for k, v in self.records.items()]
        return "\n".join(lines)


def flops_bytes_estimate(layout) -> dict:
    """Analytic cost model for one encode (SURVEY.md section 7 feasibility)."""
    n_blocks = sum(c.n_blocks for c in layout.comps)
    px = sum(c.plane_h * c.plane_w for c in layout.comps)
    return {
        "pixels": px,
        "blocks": n_blocks,
        "dct_flops": n_blocks * 64 * 64 * 2,        # [n,64]@[64,64]
        "color_flops": layout.height * layout.width * 12,
        "hbm_bytes_min": px * (1 + 4 + 4 + 4),      # u8 in, f32, i32 zz, out
        "entropy_slots": n_blocks * 64,
    }
