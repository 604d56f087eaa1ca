"""Shared helpers of the benchmark's tests."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``port_bench/`` copied into ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", dest / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dest


def run_cli(args, cwd, pythonpath, timeout=300):
    """``python3 -m port_bench.run ARGS`` in ``cwd``."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(map(str, pythonpath))}
    return subprocess.run([sys.executable, "-m", "port_bench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
