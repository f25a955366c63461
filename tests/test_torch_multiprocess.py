"""Two-process gloo jobs of the port on the CPU (the counterparts of
tests/test_multiprocess.py), and the port's dry run.

Each worker is a fresh interpreter joined through
jpgenc_tpu_torch.parallel.multihost with two CPU device entries of its own:
this exercises the owned rows and stripes, the summed histogram and the
host exchange that a single process never runs. Every wait has a timeout,
since gloo waits for a dead peer.
"""
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
_WORKER = str(ROOT / "tests" / "_torch_mp_worker.py")
_FAULT = str(ROOT / "tests" / "_torch_mp_fault_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _launch(script, args_of):
    port = _free_port()
    return [subprocess.Popen([sys.executable, script, str(i), "2", str(port),
                              *args_of(i)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=_env(), text=True)
            for i in range(2)]


def _finish(procs, timeout=120):
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()                    # exact pid, never a pattern
                p.communicate(timeout=60)
    return outs


def test_two_process_distributed_encode():
    """Batches (fused, optimize, islow), even and ragged stripes (with and
    without optimize), the batch-split decode and the transcode over two
    processes equal the single-process port on every process. On the CPU
    every wrapper takes its plain version: no launch is counted."""
    procs = _launch(_WORKER, lambda i: [])
    outs = _finish(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"worker {i} failed:\n{tail}"
        assert f"MP_WORKER_OK {i}" in out, f"worker {i} incomplete:\n{tail}"
        line = json.loads([ln for ln in out.splitlines()
                           if ln.startswith("DRYRUN ")][0].split(" ", 1)[1])
        counts = line["launches"]
        assert counts.pop("plain_calls") > 0
        assert line["rank"] == i and not any(counts.values()), counts


def test_kill_one_process_resume(tmp_path):
    """Worker 1 SIGKILLs itself mid-`run_batch` (after chunk 1 of 3 is
    flushed), the survivor is torn down, and the relaunched job resumes from
    both manifests: every file byte-correct, the finished work skipped."""
    outdir = str(tmp_path)
    procs = _launch(_FAULT, lambda i: [outdir] + (["1"] if i == 1 else []))
    try:
        out1, _ = procs[1].communicate(timeout=120)
        assert procs[1].returncode == -9, \
            f"worker 1 should die by SIGKILL, got {procs[1].returncode}:" \
            f"\n{out1[-2000:]}"
        # the survivor fails or blocks in the dead peer's exchange: give it
        # a moment to prove it does NOT finish
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20 and procs[0].poll() is None:
            time.sleep(0.2)
        assert procs[0].poll() is None or procs[0].returncode != 0, \
            "worker 0 completed despite its peer dying mid-batch"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate(timeout=60)
    for i in range(2):
        mpath = os.path.join(outdir, f"manifest_p{i}.jsonl")
        assert os.path.exists(mpath), f"no manifest from worker {i}"
        assert sum(1 for _ in open(mpath)) >= 1

    procs = _launch(_FAULT, lambda i: [outdir])
    outs = _finish(procs)
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"relaunched worker {i} failed:\n{tail}"
        assert f"MP_FAULT_OK {i}" in out, f"worker {i} incomplete:\n{tail}"
    # worker 1 finished chunk 1 (4 images) before dying: the relaunch must
    # have SKIPPED at least those, proving resume rather than redo
    skipped1 = int(re.search(r"MP_FAULT_OK 1 done=\d+ skipped=(\d+)",
                             outs[1]).group(1))
    assert skipped1 >= 4, f"worker 1 resumed nothing (skipped={skipped1})"


def test_dryrun_two_ranks_on_the_cpu():
    r = subprocess.run([sys.executable, str(ROOT / "dryrun_torch.py"),
                        "--ranks", "2", "--device", "cpu",
                        "--timeout", "150"],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=200)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(ln.split(" ", 1)[1]) for ln in r.stdout.splitlines()
             if ln.startswith("DRYRUN ")]
    assert [d["rank"] for d in lines] == [0, 1]
    assert all(d["cases"] == lines[0]["cases"] >= 10 for d in lines)
    assert sum(d["own_rows"] for d in lines) == 5
    assert all(d["entries"] == 2 and d["device"] == "cpu" for d in lines)


def test_dryrun_fails_when_a_rank_fails():
    """device cuda without CUDA: every rank raises, the launcher exits
    non-zero and prints no rank line."""
    r = subprocess.run([sys.executable, str(ROOT / "dryrun_torch.py"),
                        "--ranks", "2", "--device", "cuda",
                        "--timeout", "150"],
                       cwd=ROOT, env=_env(), capture_output=True, text=True,
                       timeout=200)
    assert r.returncode != 0
    assert "is_available() is False" in r.stderr
    assert "DRYRUN" not in r.stdout
