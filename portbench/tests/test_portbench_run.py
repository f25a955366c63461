"""A run end to end on the CPU at a small size: the result line, the refusal
without a card, and `correct` coming out false under a broken timed path
and under the control."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import control, harness
from portbench.tests.cells import BENCHMARK_CELLS, CELLS, registry

ROOT = Path(harness.ROOT)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _cli(cwd, workload=BENCHMARK_CELLS[0]):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Here torch sees no CUDA device: the run fails and prints nothing."""
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CPU fallback" in out.stderr


def test_benchmark_alone_fails(tmp_path):
    """A directory with BENCHMARK.json and portbench/ only: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / harness.HERE.name,
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct_and_keeps_to_the_keys(cell, small_cell, run_small):
    c = small_cell(cell)
    r = run_small(c)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in c.end_to_end}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(r["device"])
    assert all(set(v) == {"value", "limit"} for v in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_every_seed_gets_the_same_content_levels(cell, small_cell):
    """Each call holds each content level equally where its frames are a
    multiple of the levels, every seed the same set in all, in another
    order."""
    from portbench import frames
    c = small_cell(cell)
    per_call = 1 if c.traffic["entry"] == "encode" else \
        c.traffic["frames_per_call"]
    a, b = (frames.levels(c.config, c.traffic.get("distinct", 1), per_call,
                          seed) for seed in (2**31 + 1, 2**31 + 2))
    if c.config["content"]["kind"] == "fixture":
        assert a is None and b is None
        return
    assert sorted(sum(a, [])) == sorted(sum(b, [])) and a != b
    if per_call % len(c.config["content"]["amplitude"]) == 0:
        assert len({tuple(sorted(row)) for row in a + b}) == 1


def test_a_traced_run_has_the_trace_keys(small_cell, run_small):
    r = run_small(small_cell(CELLS[0]), trace=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert r["metrics"]["d2h_bytes_per_image"]["value"] > 0


# --- faults of the timed path ----------------------------------------------

def _half(files):                      # half of the batch left out
    return files[:len(files) // 2]


def _alter(files):                     # an answer altered where it is made
    out = []
    for f in files:
        b = bytearray(f)
        b[(b.index(b"\xff\xda") + len(b)) // 2] ^= 0x24
        out.append(bytes(b))
    return out


def _broken_encode_batch(real, fault):
    def encode_batch(*args, **kw):
        return fault(real(*args, **kw))
    return encode_batch


def _exchange_left_out(real):
    """Each card but the first encodes and returns nothing of its rows."""
    def encode_batch(*args, **kw):
        files = real(*args, **kw)
        n = len(kw.get("devices") or [None])
        keep = len(files) // n
        return files[:keep] + [b""] * (len(files) - keep)
    return encode_batch


ENCODE_FAULTS = {"half_batch": _half, "answer_altered": _alter}


@pytest.mark.parametrize("fault", sorted(ENCODE_FAULTS))
@pytest.mark.parametrize("cell", [c for c in CELLS if "decode" not in c])
def test_encode_faults_are_not_correct(cell, fault, small_cell, run_small,
                                       monkeypatch):
    from jpgenc_tpu_torch import api
    from jpgenc_tpu_torch.parallel import mesh
    c = small_cell(cell)
    if c.traffic["entry"] == "encode":      # a batch of one image
        real = api.encode
        broken = (lambda *a, **k: b"") if fault == "half_batch" else \
            (lambda *a, **k: _alter([real(*a, **k)])[0])
        monkeypatch.setattr(api, "encode", broken)
    else:
        monkeypatch.setattr(mesh, "encode_batch", _broken_encode_batch(
            mesh.encode_batch, ENCODE_FAULTS[fault]))
    r = run_small(c)
    assert not r["correct"]


def test_sharded_exchange_left_out_is_not_correct(small_cell, run_small,
                                                  monkeypatch):
    from jpgenc_tpu_torch.parallel import mesh
    cell = next(c for c in CELLS if "sharded" in c)
    monkeypatch.setattr(mesh, "encode_batch",
                        _exchange_left_out(mesh.encode_batch))
    r = run_small(small_cell(cell))
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered",
                                   "input_altered"])
def test_decode_faults_are_not_correct(fault, small_cell, run_small,
                                       monkeypatch):
    from jpgenc_tpu_torch import api
    from jpgenc_tpu_torch.parallel import mesh
    real = api.decode_batch
    if fault == "input_altered":
        # set-up's encoder makes a file that decodes, with a wrong quantizer
        def wrong_quantizer(files):
            out = []
            for f in files:
                b = bytearray(f)
                b[b.index(b"\xff\xdb") + 6] ^= 0x01
                out.append(bytes(b))
            return out
        monkeypatch.setattr(mesh, "encode_batch", _broken_encode_batch(
            mesh.encode_batch, wrong_quantizer))
        r = run_small(small_cell(next(c for c in CELLS if "decode" in c)))
        assert not r["correct"]
        assert r["checks"]["input_files_unlike_reference_coding"]["value"]
        return

    def decode_batch(*args, **kw):
        out = real(*args, **kw)
        if fault == "half_batch":
            return [t[:t.shape[0] // 2] for t in out]
        out = [t.clone() for t in out]
        for t in out:
            t[:, :8, :8] ^= 0x40
        return out
    monkeypatch.setattr(api, "decode_batch", decode_batch)
    r = run_small(small_cell(next(c for c in CELLS if "decode" in c)))
    assert not r["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, small_cell):
    """The reference in TF32 in the program's place, under the cell's own
    limits (on the card the same script reads the cells' full sizes)."""
    c = small_cell(cell)
    c.config = dict(c.config, height=128, width=192)
    out = control.control_readings(c, 2**31 + 3, device="cpu")
    assert not out["correct"]


@pytest.mark.gpu
def test_a_run_on_the_card(cuda, small_cell, run_small):
    """Every cell's entry through the kernels at a small size."""
    import time
    for cell in CELLS:
        c = small_cell(cell)
        if c.traffic.get("devices", 1) > 1:
            import torch
            if torch.cuda.device_count() < c.traffic["devices"]:
                continue
        r = harness.run_cell(c, 2**31 + 5, 0.5, False, time.perf_counter(),
                             device=cuda, registry=registry())
        assert r["correct"], (cell, r["checks"])


def test_cli_help_runs():
    out = subprocess.run([sys.executable, "portbench/run.py", "--help"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ))
    assert out.returncode == 0 and "--workload" in out.stdout
