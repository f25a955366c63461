#!/usr/bin/env python3
"""The control of a cell's comparison: the reference put in the program's
place, with its matrix products in TF32 (operands rounded to 10 mantissa
bits, float32 sums), the step below the float32 with TF32 off that the
configurations state. It must come out as not correct under the cell's
limits; its readings set each limit's upper end.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13

For each seed the cell's inputs are made as a run makes them (on the card,
from the seed), as many images as a run checks are drawn from them, the
TF32 reference produces their files (encode) or pixels (decode; and, in
place of the set-up's encoder, the files it decodes), and the run's judge
reads them. Prints one JSON line per seed. Not part of a run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from portbench import harness, judge  # noqa: E402
from portbench import traffic as traffic_mod  # noqa: E402
from portbench.reference import decoder as ref_dec  # noqa: E402
from portbench.reference import encoder as ref_enc  # noqa: E402


def control_readings(cell, seed: int, device: str = "cuda", port=None
                     ) -> dict:
    drv = traffic_mod.Driver(cell.config, cell.traffic, seed, device,
                             port or harness.port_modules())
    drv.make_inputs()
    rng = np.random.default_rng(seed)
    picks = [(int(rng.integers(0, drv.distinct)),
              int(rng.integers(0, drv.images_per_call)))
             for _ in range(int(cell.traffic["sample_images"]))]
    cfg = cell.config
    encoded = [(drv.frame(i, j), ref_enc.encode(
        drv.frame(i, j), cfg["quality"], cfg["subsampling"],
        cfg["restart_interval"], cfg["optimize"], matmul="tf32"))
        for i, j in picks]
    readings = judge.judge_encode(encoded, cfg)
    if drv.mix["entry"] == "decode_batch":
        # the decoder's control on the program's files, the encoder's on
        # the files the decode cell's set-up makes
        readings = dict(judge.judge_decode(
            [(drv.file(i, j), ref_dec.decode(drv.file(i, j), "tf32"))
             for i, j in picks]),
            **{f"input_{k}": v for k, v in readings.items()})
    checks = judge.held(readings, cell.limits)
    return {"seed": seed, "readings": readings, "checks": checks,
            "correct": judge.passes(checks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    cell = harness.Registry().cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_readings(cell, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
