"""bench_torch.py on the CPU, the port's profiling utilities, and the eager
host fetch of the encode engine.

The bench walks every row on the plain versions at a tiny size and must
print one parseable line under 1900 characters. The fetch tests pin what
the pinned asynchronous copy must keep: a fetch's arrays are views of a
buffer of its own, so a later fetch (the next chunk of a batch, a worst-tier
retry) never overwrites them, and the prefix guess shared through the plan
cache stays consistent under threads.
"""
import json
import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from jpgenc_tpu_torch import engine
from jpgenc_tpu_torch.utils import fixtures, profiling

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROWS = ("1080p_420_q75", "qsweep_dri", "1080p_422_q75", "1080p_444_q75",
        "1080p_islow_q75", "1080p_420_q75_optimized", "gray512_q75",
        "4k_optimized", "decode_1080p", "e2e_upload", "batch_sharded")


def _env():
    """The subprocess's environment: no PYTHONPATH, one thread a process
    (the tests share the machine with other test workers)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    return env


def test_bench_cpu_walks_every_row(tmp_path):
    env = _env()
    detail = tmp_path / "detail.json"
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                        "--device", "cpu", "--size", "64x96", "--batch", "2",
                        "--detail", str(detail)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    assert len(last) < 1900
    line = json.loads(last)
    assert {"metric", "value", "unit", "backend", "power_limit_w",
            "configs"} <= set(line)
    assert "vs_baseline" not in line and line["backend"] == "cpu"
    assert line["value"] > 0 and line["unit"] == "MPix/s"
    assert tuple(line["configs"]) == ROWS
    full = json.loads(detail.read_text())
    assert tuple(full["configs"]) == ROWS
    assert line["value"] == float(f"{full['value']:.6g}")
    assert {"link_probe", "cost_model"} <= set(full)
    assert set(full["cost_model"]) == {"1080p_420", "1080p_422", "1080p_444",
                                       "1080p_420_dri120", "gray512",
                                       "4k_420"}
    rows = [row for name, row in full["configs"].items()
            if name != "qsweep_dri"]
    rows += list(full["configs"]["qsweep_dri"].values())
    assert len(rows) == len(ROWS) - 1 + 6
    for row in rows:
        assert "error" not in row
        assert row.get("mpix_per_s", row.get(
            "e2e_upload_mpix_per_s", row.get("e2e_mpix_per_s"))) > 0
        for k, v in row.items():
            assert v is not None, k
    for name in ROWS:
        if name in ("e2e_upload", "qsweep_dri", "batch_sharded"):
            continue
        row = full["configs"][name]
        assert {"device_only_mpix_per_s", "d2h_bytes", "bpp",
                "psnr_db"} <= set(row), name
        assert row["device_only_mpix_per_s"] == "not measured"
        assert row["d2h_bytes"] > 0 and row["psnr_db"] > 20, name
    split = full["configs"]["1080p_420_q75_optimized"]["split"]
    assert {"pass1_ms", "tables_ms", "pass2_ms"} <= set(split)
    e2e = full["configs"]["e2e_upload"]
    assert e2e["e2e_upload_mpix_per_s"] > 0 and e2e["numpy_mpix_per_s"] > 0


def test_bench_batch_sharded_row(tmp_path):
    """bench.py's c11 row alone: 3 double-buffered chunks through
    stage_batch / encode_batch(staged=) over MeshConfig()'s entries."""
    detail = tmp_path / "detail.json"
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                        "--device", "cpu", "--size", "64x96", "--batch", "2",
                        "--rows", "batch_sharded", "--detail", str(detail)],
                       cwd=tmp_path, env=_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert tuple(line["configs"]) == ("1080p_420_q75", "batch_sharded")
    assert line["configs"]["batch_sharded"]["e2e_mpix_per_s"] > 0
    row = json.loads(detail.read_text())["configs"]["batch_sharded"]
    assert row["images"] == 6 and row["devices"] == ["cpu"]
    assert row["passes"] == 5 and len(row["wall_ms_quartiles"]) == 3
    assert row["shape"] == [64, 96]


def test_bench_refuses_cuda_without_cuda(tmp_path):
    env = _env()
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py"),
                        "--size", "16x16", "--batch", "1",
                        "--detail", str(tmp_path / "d.json")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "is_available() is False" in r.stderr
    assert r.stdout.strip() == "" and not (tmp_path / "d.json").exists()


def test_stage_timer_records_every_stage():
    t = profiling.StageTimer()
    x = torch.arange(6)
    for _ in range(2):
        with t.stage("a"):
            t.force((x * 2, {"k": x}))
        with t.stage("b"):
            pass
        with t.stage("c"):
            t.force([None, [x + 1]])
    assert list(t.records) == ["a", "b", "c"]
    assert all(v >= 0 for v in t.records.values())
    rep = t.report().splitlines()
    assert len(rep) == 3 and rep[0].startswith("a ")
    assert profiling._first_tensor(([1, {"z": x}],)) is x
    assert profiling._first_tensor((1, "s")) is None


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    out = tmp_path / "tr" / "trace.json"
    assert out.stat().st_size > 0
    json.loads(out.read_text())


def _plan_and_outs(seed):
    imgs = np.stack([fixtures.synth_frame(32, 48, seed=seed + i)
                     for i in range(2)])
    plan = engine.get_plan(32, 48, "420", 75, "cpu")
    cap = engine.scan_caps(plan.layout, 75, "worst")[0]
    return plan, cap, plan(torch.from_numpy(imgs), cap, 56)


def test_two_fetches_in_a_row_leave_the_first_unchanged():
    plan, cap, outs_a = _plan_and_outs(3)
    _, _, outs_b = _plan_and_outs(50)
    first = plan.fetch(outs_a, cap)
    kept = [(u.copy(), n.copy(), ok) for u, n, ok in first]
    second = plan.fetch(outs_b, cap)
    assert any(not np.array_equal(a[0][:len(b[0])], b[0][:len(a[0])])
               for a, b in zip(first, second))
    for (u, n, ok), (u0, n0, ok0) in zip(first, kept):
        np.testing.assert_array_equal(u, u0)
        np.testing.assert_array_equal(n, n0)
        assert ok == ok0
    # the same through the lowest layer: two combined fetches
    w = torch.arange(80, dtype=torch.int32).reshape(2, 40)
    h1, k = engine.combined_fetch(w, torch.ones(2, 1, dtype=torch.int32),
                                  torch.zeros(2, dtype=torch.bool), 8)
    a1 = h1.wait()
    snap = a1.copy()
    h2, _ = engine.combined_fetch(w + 1000, torch.ones(2, 1, dtype=torch.int32),
                                  torch.ones(2, dtype=torch.bool), 8)
    h2.wait()
    np.testing.assert_array_equal(a1, snap)


def test_fetch_counts_the_bytes_it_copies():
    plan, cap, outs = _plan_and_outs(9)
    wstream, nbits, _ = outs
    for guess, refetch in ((1024, False), (1, True)):
        with plan._guess_lock:
            plan.prefix_guess = guess
        engine.fetched_bytes = 0
        res = plan.fetch(outs, cap)
        assert all(cause is None for _, _, cause in res)
        k = min(guess, wstream.shape[-1])
        want = 4 * 2 * (k + nbits.shape[-1] + 1)
        if refetch:
            want += 4 * 2 * max(len(u) for u, _, _ in res)
        assert engine.fetched_bytes == want


def test_prefix_guess_under_threads():
    """Threads fetching through one cached plan (as run_batch's prefetch or
    a pool would) get the same words as a lone fetch; the shared guess is
    read and written under the plan's lock."""
    plan, cap, outs = _plan_and_outs(11)
    want = [(u.copy(), n.copy(), ok) for u, n, ok in plan.fetch(outs, cap)]
    errors = []

    def worker():
        try:
            for _ in range(20):
                with plan._guess_lock:
                    plan.prefix_guess = 1    # force the refetch path
                for (u, n, ok), (u0, n0, ok0) in zip(plan.fetch(outs, cap),
                                                     want):
                    assert ok == ok0 and np.array_equal(n, n0)
                    m = min(len(u), len(u0))
                    assert np.array_equal(u[:m], u0[:m])
        except AssertionError as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker)
                   for _ in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert plan.prefix_guess >= 1024


@pytest.mark.parametrize("gray", [False, True])
def test_optimized_tables_fetch_the_histogram(gray):
    imgs = np.stack([fixtures.synth_frame(24, 40, seed=60 + i)
                     for i in range(2)])
    if gray:
        imgs = imgs[..., 0].copy()
    plan = engine.get_plan(24, 40, "gray" if gray else "420", 75, "cpu")
    _, _, hist = plan.zz_and_histogram(torch.from_numpy(imgs))
    n_tabs = 1 if gray else 2
    per_img, tabs = plan.optimized_tables(hist)
    assert len(per_img) == 2
    for f, (dc, ac) in zip(hist.numpy(), per_img):
        want = engine.tables_from_freq(f, n_tabs)
        for ours, theirs in ((dc, want[0]), (ac, want[1])):
            assert len(ours) == len(theirs) == n_tabs
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a.code, b.code)
                np.testing.assert_array_equal(a.length, b.length)
    assert tabs[0].shape[0] == 2
