"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m port_bench.run --workload pesr_x4.batch_int8 --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout, on a machine with the card(s) the cell
asks for.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (the window under torch.profiler).  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace
1``), then ``checks``: each number compared, with its limit, which the
last lines of standard error repeat.

Without CUDA, or with fewer cards than the cell asks for, it exits 2
and prints no result.  ``--rehearse`` runs the cell on the CPU instead,
at the configuration's ``rehearsal`` sizes with every HR size divided by
8, on the kernels' plain versions: a check of the harness, whose
numbers are the CPU's and carry no device metric.

A cell is found by name: its configuration's ``file``, the mix
``mixes/<traffic>.json`` (whose ``runner`` names ``runners/<runner>.py``),
the limits ``checks/<cell>.json`` and each per-layer metric's reader
``metrics/<family>.py``, the family being the name up to its first dot.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pesr_tpu")
REHEARSAL_SHRINK = 8


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, name: str):
    """``(cell, model, mix, check)`` of the workload ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r} "
                         f"(known: {sorted(cells)})")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    model = load_json(ROOT / config["file"])
    mix = load_json(HERE / "mixes" / f"{cell['traffic']}.json")
    check = load_json(HERE / "checks" / f"{name}.json")
    return cell, model, mix, check


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell``
    reports."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def per_layer(bench: dict, cell: str, ctx) -> dict:
    out = {}
    for m in metrics_of(bench, cell, "per_layer"):
        family, _, suffix = m["name"].partition(".")
        reader = importlib.import_module(f"port_bench.metrics.{family}")
        value = reader.read(ctx, suffix)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        raise SystemExit("--seed must be >= 0 and --seconds > 0")
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, model, mix, check = find_cell(bench, args.workload)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".port_bench_cache" / sub)
    import torch
    if args.rehearse:
        device = torch.device("cpu")
        model = {**model, **model["rehearsal"]}
        shrink = REHEARSAL_SHRINK
    else:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print(f"[port_bench] {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        shrink = 1
        print(f"[port_bench] card: {card_line(device)}", file=sys.stderr)

    runner = importlib.import_module(f"port_bench.runners.{mix['runner']}")
    out = runner.run(cell, model, mix, check, args, device, T_START, shrink)

    from port_bench.metrics._common import Context
    if args.trace:
        ctx = Context(model, mix, out["requests"], out["window_s"],
                      out["launches"], out["trace"])
        metrics = per_layer(bench, args.workload, ctx)
    else:
        metrics = {}
        for m in metrics_of(bench, args.workload, "end_to_end"):
            value, unit = out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}

    limits = check["limits"]
    checks = {name: {"value": out["numbers"][name], "limit": limit}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"[port_bench] forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell["chips"], "memory_peak_bytes": out["peak"]}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    trace = out["trace"]
    if args.trace and trace is not None:
        dev["busy_s"] = trace.busy_us() * 1e-6
        dev["window_s"] = trace.window_us * 1e-6
        line["breakdown"] = {"device_ops": trace.top_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["checks"] = checks
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[port_bench] check {name} {c['value']:.6g} <= "
              f"{c['limit']:.6g}: {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
