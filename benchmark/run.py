"""Run one cell of the port's benchmark and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The cell is BENCHMARK.json's workload of
that name; its file benchmark/workloads/<name>.json names the
configuration (benchmark/configs/<config>.json), the traffic parameters
and the traffic generator (benchmark/traffic/<generator>.py), which sets
up the program, drives the window and checks what it produced.  With
--trace 0 the line carries the cell's end-to-end metrics, with --trace 1
its per-layer metrics, each read by benchmark/metrics/<metric>.py from
the traced window.  The compared numbers and their limits are the last lines on
standard error and the line's last key.  Exits non-zero, printing no
result, without enough CUDA cards or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path.insert(0, BENCH)
sys.path.insert(1, ROOT)

from harness import imports, stats  # noqa: E402


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def end_to_end(res: dict) -> dict:
    """The end-to-end metrics any generator's window gives."""
    done = res["batches"]
    return dict(
        throughput_mbase_per_s=stats.rate(sum(b["bases"] for b in done)
                                          / 1e6, res["window_s"]),
        batch_p95_ms=1e3 * stats.percentile([b["latency_s"] for b in done],
                                            95),
        setup_s=res["setup_s"])


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 3
    workload = load_json(BENCH, "workloads", args.workload + ".json")
    config = load_json(BENCH, "configs", workload["config"] + ".json")
    generator = importlib.import_module("traffic." + workload["generator"])
    ctx = SimpleNamespace(config=config, traffic=workload["traffic"],
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device="cuda",
                          t_start=T_START)
    res = generator.run(ctx)

    found = imports.loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"],
                  memory_peak_bytes=res["memory_peak_bytes"],
                  power_limit=power_limit())
    line = dict(correct=None, attempted=res["attempted"],
                failed=res["failed"])
    metrics = {}
    if args.trace:
        tr = res["traced"]
        device.update(busy_s=tr["trace"].busy_s(),
                      window_s=tr["trace"].window_s)
        for m in spec["per_layer"]:
            if applies(m, args.workload):
                v = reader(m["name"])(tr)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
        line["breakdown"] = dict(device_ops=tr["trace"].top_ops(),
                                 idle_gaps=tr["trace"].idle_gaps())
    else:
        values = end_to_end(res)
        for m in spec["end_to_end"]:
            if applies(m, args.workload):
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    checks = {name: dict(value=v, limit=res["limits"][name])
              for name, v in res["checks"].items()}
    line["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    line.update(metrics=metrics, device=device, info=res["info"],
                checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
