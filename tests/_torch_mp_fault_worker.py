"""Worker for the port's kill-one-process test (run as a script): the
counterpart of tests/_mp_fault_worker.py.

A dead process means the job is torn down and relaunched, and the batch
driver's manifest makes the relaunch resume instead of redo. This worker
runs `batch.run_batch` in a two-process gloo job; with die_after_chunk=N
it SIGKILLs ITSELF (its own pid) at the start of its (N+1)-th chunk — after
chunk N's files and manifest lines are flushed. The surviving peer fails
or blocks in the next chunk's exchange and is killed by the test.

Usage: python tests/_torch_mp_fault_worker.py <pid> <nproc> <port> <outdir>
           [die_after_chunk]
"""
import json
import os
import signal
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_IMAGES = 12
CHUNK = 4


def make_images():
    import numpy as np
    rng = np.random.default_rng(1234)
    return np.stack([
        np.clip(rng.normal(128, 40, (32, 48, 3)), 0, 255).astype(np.uint8)
        for _ in range(N_IMAGES)])


def main() -> int:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    outdir = sys.argv[4]
    die_after = int(sys.argv[5]) if len(sys.argv) > 5 else 0

    import torch
    torch.set_num_threads(1)

    from jpgenc_tpu_torch.parallel import multihost
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid)
    assert multihost.process_count() == nproc, "distributed init failed"

    from jpgenc_tpu_torch.batch import run_batch
    from jpgenc_tpu_torch.parallel.mesh import encode_batch

    imgs = make_images()
    # per-process output paths and manifest: each host has its own disk;
    # here it also proves BOTH processes' manifests resume
    paths = [os.path.join(outdir, f"out_p{pid}_{i:02d}.jpg")
             for i in range(N_IMAGES)]
    manifest = os.path.join(outdir, f"manifest_p{pid}.jsonl")
    calls = {"n": 0}

    def chunky(chunk, **kw):
        calls["n"] += 1
        if die_after and calls["n"] > die_after:
            # the previous chunk's files and manifest lines are on disk,
            # this chunk's are not; SIGKILL leaves no cleanup handler a
            # chance, like a machine loss
            os.kill(os.getpid(), signal.SIGKILL)
        return encode_batch(chunk, **kw)

    res = run_batch(imgs, paths, manifest, quality=75, subsampling="420",
                    chunk_size=CHUNK, encode_chunk=chunky, device="cpu",
                    devices=["cpu", "cpu"])

    from jpgenc_tpu_torch.api import encode
    for i in range(N_IMAGES):
        with open(paths[i], "rb") as f:
            data = f.read()
        ref = encode(imgs[i], quality=75, subsampling="420", device="cpu")
        assert data == ref, f"proc {pid}: image {i} bytes differ after resume"
    seen = [json.loads(ln)["index"] for ln in open(manifest)]
    assert sorted(set(seen)) == list(range(N_IMAGES))

    print(f"MP_FAULT_OK {pid} done={res.done} skipped={res.skipped}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
