"""The benchmark cell `rgb4k_420_q75_optimized_batch.batch16_device`'s path
on the CPU at a small size: `mesh.encode_batch(optimize=True)` on a batch of
the benchmark's photographic frames (`portbench/frames.py`, one frame of
each of the configuration's eight detail levels), which the tight tier
holds, and one uniform-noise frame, which overflows it and is retried alone
with its own tables.

Each batch is held to the benchmark's own reference (`portbench/judge.py`:
every file exactly the reference's coding of its coefficients with tables
built from their histogram, the coefficients within the cell's limits of
the float32 reference's) and to `api.encode` frame by frame.
"""
import json
from pathlib import Path

import pytest
import torch

from jpgenc_tpu_torch import api, engine
from jpgenc_tpu_torch.parallel import mesh
from portbench import frames, judge

ROOT = Path(__file__).resolve().parent.parent
CELL = "rgb4k_420_q75_optimized_batch.batch16_device"
CONFIG = json.loads((ROOT / "portbench" / "configs" /
                     "rgb4k_420_q75_optimized_batch.json").read_text())
LIMITS = json.loads((ROOT / "portbench" / "limits" /
                     f"{CELL}.json").read_text())
H, W = 256, 384          # whole 4:2:0 MCUs
SEEDS = (2**31 + 18, 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_optimize_batch_holds_the_benchmark_reference(seed, monkeypatch):
    amps = CONFIG["content"]["amplitude"]
    gen = frames.generator(seed, "cpu")
    x = frames.frames(len(amps), H, W, CONFIG["channels"], gen, "cpu", amps)
    noise = torch.randint(0, 256, (1, H, W, CONFIG["channels"]),
                          generator=gen, dtype=torch.uint8)
    x = torch.cat([x, noise])
    kw = dict(quality=CONFIG["quality"], subsampling=CONFIG["subsampling"],
              restart_interval=CONFIG["restart_interval"],
              optimize=CONFIG["optimize"], dct_method=CONFIG["dct_method"])
    retried = []
    real_recode = engine.EncodeJob.recode

    def recode(self, j, *args, **kwargs):
        retried.append(j)
        return real_recode(self, j, *args, **kwargs)

    monkeypatch.setattr(engine.EncodeJob, "recode", recode)
    files = mesh.encode_batch(x, device="cpu", **kw)
    assert retried == [len(amps)]      # the noise frame alone
    readings = judge.judge_encode(
        [(x[i].numpy(), f) for i, f in enumerate(files)], CONFIG)
    checks = judge.held(readings, LIMITS)
    assert set(checks) == set(LIMITS) and judge.passes(checks), readings
    assert files == [api.encode(x[i], device="cpu", **kw)
                     for i in range(len(files))]
