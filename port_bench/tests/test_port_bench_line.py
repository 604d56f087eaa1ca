"""The result line and the run's refusals."""

import pytest

from port_bench import run
from port_bench.tests.helpers import ROOT, copy_benchmark, last_json, run_cli

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device",
             "checks"]


@pytest.mark.parametrize("trace", [0, 1])
def test_line_has_the_contract_keys(trace):
    r = run_cli(["--workload", "pesr_x4.single_photo", "--seed",
                 "3000000019", "--seconds", "0.5", "--trace", str(trace),
                 "--rehearse"], ROOT, [ROOT])
    assert r.returncode == 0, r.stderr[-2000:]
    line = last_json(r.stdout)
    assert list(line) == LINE_KEYS      # no breakdown without a card
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["platform"] == "cpu"
    names = set(line["metrics"])
    if trace:
        # only what the CPU can count: no device metric without a card
        assert names == {"tiled_px_ratio.latency"}
    else:
        assert names == {"latency_p50_ms", "latency_p95_ms", "setup_s"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name} " in r.stderr
    assert line["attempted"] > 0 and line["failed"] == 0


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = run_cli(["--workload", "pesr_x4.batch_int8", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], ROOT, [ROOT])
    assert r.returncode == 2 and r.stdout == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    root = copy_benchmark(tmp_path)
    r = run_cli(["--workload", "pesr_x4.batch_int8", "--seed", "1",
                 "--seconds", "1", "--trace", "0", "--rehearse"], root,
                [root])
    assert r.returncode != 0 and r.stdout == ""


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
