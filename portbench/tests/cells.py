"""The cells the tests drive: BENCHMARK.json's, and those that
`portbench/left_out.json` keeps. Those were measured and left out of
BENCHMARK.json (PERF.md says why); their files stay, and the tests still
drive them, so that a later PR can list them again by adding their entries
to BENCHMARK.json alone."""
import json

from portbench import harness


def spec() -> dict:
    """BENCHMARK.json with the entries of `left_out.json` added: its cells
    and configurations, its per-layer metrics, and its cells under each
    end-to-end metric that they report."""
    out = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    left = json.loads((harness.HERE / "left_out.json").read_text())
    for key in ("configs", "workloads", "per_layer"):
        out[key] = out[key] + left[key]
    have = {m["name"]: m for m in out["end_to_end"]}
    for m in left["end_to_end"]:
        if m["name"] in have:
            have[m["name"]]["workloads"] = (have[m["name"]]["workloads"] +
                                            m["workloads"])
        else:
            out["end_to_end"].append(m)
    return out


def registry() -> harness.Registry:
    return harness.Registry(spec=spec())


BENCHMARK_CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS = [w["name"] for w in spec()["workloads"]]
