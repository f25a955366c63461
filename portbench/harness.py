"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file found by its name in `BENCHMARK.json`:

    <root>/BENCHMARK.json                      the cells and the metrics
    <root>/<configs[].file>                    a configuration
    portbench/traffic/<traffic>.json           a traffic mix (traffic.py)
    portbench/limits/<cell>.json               the cell's limits (judge.py)
    portbench/layer_metrics/<metric>.py        a per-layer metric's reader,
                                               by the name before its first
                                               dot: read(ctx) -> value | None;
                                               the metric lists its cells
                                               under `workloads`

The end-to-end metrics are measured here, on the host's clock; a traced
run (trace=True) reports the cell's per-layer metrics instead, from
`torch.profiler` around the same window.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "jpgenc_tpu")
WARMUP_CALLS = 2     # the first builds the plans, the second runs as the rest


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


class Registry:
    """The cells of a BENCHMARK.json and the files that belong to them."""

    def __init__(self, root: Path = ROOT, spec: dict | None = None):
        """spec: the cells and metrics in place of BENCHMARK.json's."""
        self.root = Path(root)
        self.base = self.root / HERE.name
        if spec is None:
            with open(self.root / "BENCHMARK.json") as f:
                spec = json.load(f)
        self.spec = spec

    def _load(self, path: Path) -> dict:
        with open(path) as f:
            return json.load(f)

    def cell(self, name: str) -> SimpleNamespace:
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        entry = next(c for c in self.spec["configs"]
                     if c["name"] == w["config"])
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        layer = [m for m in self.spec["per_layer"] if name in m["workloads"]]
        return SimpleNamespace(
            name=name, chips=int(w["chips"]),
            config=self._load(self.root / entry["file"]),
            traffic=self._load(self.base / "traffic" / f"{w['traffic']}.json"),
            limits=self._load(self.base / "limits" / f"{name}.json"),
            end_to_end=e2e, per_layer=layer)

    def reader(self, metric: str):
        """The `read(ctx)` of a per-layer metric's module."""
        base = metric.split(".", 1)[0]
        path = self.base / "layer_metrics" / f"{base}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_layer_{base}", path)
        if spec is None:
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def port_modules() -> SimpleNamespace:
    """The system under test: the entries the traffic drives, and the
    modules whose counters the run reads."""
    from jpgenc_tpu_torch import api, engine, native
    from jpgenc_tpu_torch.kernels import build
    from jpgenc_tpu_torch.ops.cuda import (block_pack, k1_dct, k1a_fused,
                                           recon, seg_merge)
    from jpgenc_tpu_torch.parallel import mesh
    return SimpleNamespace(api=api, mesh=mesh, engine=engine, native=native,
                           build=build,
                           kernels={"k1a_fused": k1a_fused, "k1_dct": k1_dct,
                                    "block_pack": block_pack,
                                    "seg_merge": seg_merge, "recon": recon})


def plain_calls(port) -> dict:
    return {k: int(m.plain_calls) for k, m in port.kernels.items()}


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _scan_bytes(files) -> int:
    """Entropy-coded bytes of JFIF files: each file from the end of its SOS
    segment to its EOI."""
    n = 0
    for f in files:
        if isinstance(f, bytes):
            sos = f.find(b"\xff\xda")
            if sos >= 0:
                n += len(f) - (sos + 2 + int.from_bytes(f[sos + 2:sos + 4],
                                                        "big")) - 2
    return n


class Tally:
    """What the window's calls left behind: each call's latency and start,
    the images attempted and well formed, the coded bytes (traced runs),
    the first errors, and a sample drawn from the seed: Algorithm R over
    the calls, then one image of each kept call."""

    def __init__(self, drv, seed: int, trace: bool):
        self.drv, self.trace = drv, trace
        self.rng = np.random.default_rng(seed)
        self.k = int(drv.mix["sample_images"])
        self.kept: list = []        # (call index, image index, its output)
        self.lat: list = []
        self.starts: list = []
        self.attempted = self.good = self.scan = 0
        self.errors: list = []

    def __call__(self, i, call) -> None:
        drv = self.drv
        self.lat.append(call.end - call.start)
        self.starts.append(call.start)
        self.attempted += drv.images_per_call
        self.good += drv.well_formed(call.outputs)
        if call.error and len(self.errors) < 3:
            self.errors.append(call.error)
        if self.trace and drv.mix["entry"] != "decode_batch":
            self.scan += _scan_bytes(call.outputs or [])
        r = len(self.kept) if len(self.kept) < self.k else \
            int(self.rng.integers(0, i + 1))
        if r < self.k:
            j = int(self.rng.integers(0, drv.images_per_call))
            self.kept[r:r + 1] = [(i, j, drv.output(call.outputs, j))]

    def summary(self, t0: float, window_s: float) -> str:
        q = statistics.quantiles(self.lat, n=4) if len(self.lat) > 1 \
            else self.lat * 3
        first = sum(1 for c in self.starts if c < t0 + window_s / 2)
        return (f"window {window_s:.3f} s, {len(self.lat)} calls, "
                f"{self.attempted} images; latency quartiles ms "
                f"{[round(x * 1e3, 3) for x in q]}, max "
                f"{max(self.lat) * 1e3:.3f}; calls in the window's halves "
                f"{first}, {len(self.starts) - first}")


def _setup(cell, seed: int, device: str, port):
    """Build, make the inputs from the seed, warm up with the cell's calls:
    WARMUP_CALLS or one on each distinct input, whichever is more."""
    import torch

    from portbench import traffic
    if device == "cuda":
        port.build.library()
        if not port.native.available():
            raise RuntimeError("the port's C++ scan codec did not build: the "
                               "host finalize would run in Python")
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
    drv = traffic.Driver(cell.config, cell.traffic, seed, device, port)
    drv.make_inputs()
    # every distinct input once, so that each size its content brings
    # (a retry's, a fetch's) has been met before the window
    for i in range(-max(WARMUP_CALLS, drv.distinct), 0):
        drv.call(i)
    drv.sync()
    gc.collect()                # set-up's garbage is not collected inside
    return drv


def _judge(cell, drv, tally) -> dict:
    """The reference's readings of the sampled outputs."""
    from portbench import judge
    picks = sorted(tally.kept, key=lambda x: x[0])
    if drv.mix["entry"] == "decode_batch":
        readings = judge.judge_decode(
            [(drv.file(i, j), None if out is None else out.cpu().numpy())
             for i, j, out in picks])
        inputs = judge.judge_encode(
            [(drv.frame(i, j), drv.file(i, j)) for i, j, _ in picks],
            cell.config)
        readings.update((f"input_{k}", v) for k, v in inputs.items())
        return readings
    return judge.judge_encode(
        [(drv.frame(i, j), out if isinstance(out, bytes) else b"")
         for i, j, out in picks], cell.config)


def _end_to_end(cell, drv, tally, setup_s, window_s, unlike) -> dict:
    metrics = {}
    for m in cell.end_to_end:
        name = m["name"]
        if name == "setup_s":
            value = setup_s
        elif name in ("encode_mpix_per_s", "decode_mpix_per_s"):
            value = (tally.good - unlike) * drv.pixels_per_image / \
                window_s / 1e6
        elif name.endswith("_p95_ms"):
            value = float(np.percentile(tally.lat, 95)) * 1e3
        else:
            raise KeyError(f"end-to-end metric {name!r} is not measured "
                           "by this harness")
        metrics[name] = {"value": value, "unit": m["unit"]}
    return metrics


def run_cell(cell, seed: int, seconds: float, trace: bool, t_start: float,
             device: str = "cuda", port=None, registry=None) -> dict:
    """One run: set-up, the window, the check; the result line's object."""
    import torch

    from portbench import judge, traffic
    port = port or port_modules()
    cuda = device == "cuda"
    drv = _setup(cell, seed, device, port)
    tally = Tally(drv, seed, trace)
    port.engine.fetched_bytes = 0
    plain0 = plain_calls(port)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        prof = profile(activities=[ProfilerActivity.CPU] +
                       ([ProfilerActivity.CUDA] if cuda else []))
        inner = drv.call

        def traced_call(i):
            with record_function("portbench.call"):
                return inner(i)
        drv.call = traced_call
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    t0, t1, _ = traffic.run_window(drv, seconds, tally)
    drv.finish()
    if prof is not None:
        prof.__exit__(None, None, None)
        drv.call = inner
    window_s = t1 - t0
    counters = {"fetched_bytes": int(port.engine.fetched_bytes),
                "plain_calls": {n: c - plain0[n]
                                for n, c in plain_calls(port).items()}}
    log(f"counters: {json.dumps(counters)}")
    for e in tally.errors:
        log(f"a call failed: {e}")
    devs = sorted({torch.device(d) for d in drv.devices}, key=str)
    peak = max(torch.cuda.max_memory_allocated(d) for d in devs) \
        if cuda else 0

    t_check = time.perf_counter()
    readings = _judge(cell, drv, tally)
    log(f"check of {len(tally.kept)} sampled images took "
        f"{time.perf_counter() - t_check:.1f} s (window {window_s:.1f} s); "
        f"readings {json.dumps(readings)}")
    checks = judge.held(readings, cell.limits)
    malformed = tally.attempted - tally.good
    checks["missing_or_malformed_images"] = {"value": malformed, "limit": 0}
    unlike = readings.get("files_unlike_reference_coding", 0)

    result = {"correct": judge.passes(checks) and tally.attempted > 0,
              "attempted": tally.attempted, "failed": malformed + unlike,
              "metrics": {},
              "device": {"platform": "gpu" if cuda else device,
                         "kind": torch.cuda.get_device_name(devs[0])
                         if cuda else device,
                         "count": len(devs), "memory_peak_bytes": int(peak)}}
    if trace:
        metrics, device_times, breakdown = _per_layer(
            cell, registry, prof, devs, tally, counters)
        result["metrics"] = metrics
        result["device"].update(device_times)
        result["breakdown"] = breakdown
    else:
        result["metrics"] = _end_to_end(cell, drv, tally, setup_s, window_s,
                                        unlike)
    log(tally.summary(t0, window_s))
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    result["checks"] = checks
    return result


def _per_layer(cell, registry, prof, devs, tally, counters) -> tuple:
    """(per-layer metrics, busy_s and window_s, breakdown) of a traced run."""
    from portbench.tracing import Context, Trace
    tr = Trace(prof)
    cards = sorted({d.index or 0 for d in devs})
    ctx = Context(tr, cards, cell.config, cell.traffic, len(tally.lat),
                  tally.attempted, tally.scan, counters)
    metrics = {}
    for m in cell.per_layer:
        value = registry.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    busy = sum(tr.busy_s(c) for c in cards) / len(cards)
    return (metrics, {"busy_s": busy, "window_s": tr.window_s},
            {"device_ops": tr.device_ops(cards),
             "idle_gaps": tr.idle_gaps(cards)})


def main(t_start: float, argv=None) -> int:
    """`run.py`'s entry: t_start is the clock when the process began."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = HERE / "out" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    registry = Registry()
    cell = registry.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " (no CPU fallback)")
        return 2
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          t_start, registry=registry)
    except Exception:        # noqa: BLE001  (no result line after a crash)
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: the benchmark may load "
            "neither JAX nor the JAX package")
        return 3
    print(json.dumps(result), flush=True)
    return 0
