"""The readers of the program's spans on a made-up trace: two requests
of a 1 x 2 grid with known gaps, the device's clock offset from the
host's and drifting, the window cutting off an upload or a copy, and
every way the spans can disagree with the requests."""

import pytest

from port_bench.metrics import download_ms, enqueue_ms, request_idle_ms
from port_bench.metrics._common import Context, Request
from port_bench.trace import Trace

READERS = (request_idle_ms, enqueue_ms, download_ms)


def _x(cat, name, ts, end, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 1 if tid == 7 else 0, "tid": tid}


def _host(name, ts, end):
    cat = ("user_annotation" if name.startswith("pesr.")
           else "cuda_runtime" if name.startswith("cuda") else "cpu_op")
    return _x(cat, name, ts, end)


# Per request: its range, upload range and copy call, first launch
# after the upload, forwards, download range and copy call; its device
# operations (host-clock times, before the skew).
REQUESTS = [
    dict(span=(1000.0, 3000.0), upload=(1010.0, 1060.0),
         up_call=(1020.0, 1050.0), launch=(1100.0, 1105.0),
         forwards=[(1100.0, 1300.0), (1400.0, 1500.0)],
         download=(2500.0, 2950.0), down_call=(2550.0, 2930.0),
         device=[("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1030.0,
                  1045.0),
                 ("kernel", "void resblock_kernel<256>()", 1110.0, 1600.0),
                 ("kernel", "void resblock_kernel<256>()", 1700.0, 2000.0),
                 ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2600.0,
                  2900.0)]),
    dict(span=(5000.0, 6000.0), upload=(5010.0, 5040.0),
         up_call=(5015.0, 5035.0), launch=(5100.0, 5104.0),
         forwards=[(5100.0, 5200.0), (5300.0, 5350.0)],
         download=(5700.0, 5990.0), down_call=(5750.0, 5960.0),
         device=[("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 5020.0,
                  5030.0),
                 ("kernel", "void resblock_kernel<256>()", 5110.0, 5400.0),
                 ("gpu_memset", "Memset (Device)", 5380.0, 5450.0),
                 ("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 5800.0,
                  5950.0)]),
]


def _events(requests=2, forwards=2, d2h=True, spans=True, skew=0.0,
            rate=0.0, drop=()):
    """``skew`` + ``rate`` x host time: the device clock's offset;
    ``drop``: (request, name part) of device operations left out."""
    ev = [_x("user_annotation", "port_bench.window", 0.0, 10000.0)]
    for r in (REQUESTS + [dict(REQUESTS[1], span=(7000.0, 7100.0))])[
            :requests]:
        if spans:
            ev.append(_host("pesr.request", *r["span"]))
            ev.append(_host("pesr.upload", *r["upload"]))
            ev += [_host("pesr.forward", *f) for f in r["forwards"][:forwards]]
            ev.append(_host("pesr.download", *r["download"]))
        ev += [_host("cudaMemcpyAsync", *r["up_call"]),
               _host("cudaLaunchKernel", *r["launch"]),
               _host("cudaMemcpyAsync", *r["down_call"])]
        if requests > 2 and r is not REQUESTS[0] and r is not REQUESTS[1]:
            continue
        k = REQUESTS.index(r)
        for cat, name, a, b in r["device"]:
            if ("DtoH" in name and not d2h
                    or any(k == j and part in name for j, part in drop)):
                continue
            ev.append(_x(cat, name, a + skew + rate * a,
                         b + skew + rate * b, tid=1))
    return ev


def _ctx(trace, requests=2, grid=(1, 2, 5, 5)):
    reqs = [Request((10, 10), 1, grid, (8, 8), 0.0, 0.001)
            for _ in range(requests)]
    return Context({}, {"path": "bf16"}, reqs, 0.01, {}, trace)


@pytest.mark.parametrize("skew", [0.0, -1000.0, 700.0])
def test_readings_worked_out_by_hand(skew):
    ctx = _ctx(Trace(_events(skew=skew)))
    _hand_readings(ctx)


def _hand_readings(ctx, rel=1e-6):
    # idle: 2000 - (15 + 490 + 300 + 300), 1000 - (10 + 340 + 150) us
    assert request_idle_ms.read(ctx, "mps") == pytest.approx(0.6975, rel=rel)
    # forwards: 200 + 100 and 100 + 50 us
    assert enqueue_ms.read(ctx, "mps") == pytest.approx(0.225)
    # the first kernel after the upload starts 10 us after its launch,
    # so each copy counts from 10 us before its device stamp: 2950 -
    # 2590 and 5990 - 5790 us
    assert download_ms.read(ctx, "latency") == pytest.approx(0.28, rel=rel)


def test_a_drifting_device_clock_moves_the_readings_little():
    """1.6 ms a second, the fastest drift seen on the card: each edge
    is placed by the offset at the nearest upload."""
    _hand_readings(_ctx(Trace(_events(skew=-500.0, rate=1.6e-3))),
                   rel=1e-2)


@pytest.mark.parametrize("events,ctx_kw", [
    (dict(requests=3), {}),                 # a request range too many
    (dict(), dict(requests=3)),             # a request without its range
    (dict(forwards=1), {}),                 # a forward missing
    (dict(), dict(grid=(2, 2, 5, 5))),      # the grid has four positions
    (dict(spans=False), {}),                # a program without spans
], ids=["extra-request", "missing-request", "missing-forward",
        "grid-disagrees", "no-spans"])
def test_counts_that_disagree_give_none(events, ctx_kw, capsys):
    ctx = _ctx(Trace(_events(**events)), **ctx_kw)
    assert [r.read(ctx, "mps") for r in READERS] == [None] * 3
    assert capsys.readouterr().err.count("no reading") == 3


def test_no_copies_give_no_device_reading(capsys):
    ctx = _ctx(Trace(_events(d2h=False)))
    assert request_idle_ms.read(ctx, "mps") is None
    assert download_ms.read(ctx, "mps") is None
    assert enqueue_ms.read(ctx, "mps") == pytest.approx(0.225)
    assert capsys.readouterr().err.count("no reading") == 2


@pytest.mark.parametrize("drop,idle,down", [
    ([(0, "HtoD")], 0.5, 0.2),      # the window cut off the first upload
    ([(1, "DtoH")], 0.895, 0.36),   # ... or the last copy
], ids=["first-upload", "last-copy"])
def test_a_request_cut_off_by_the_window_is_left_out(drop, idle, down,
                                                       capsys):
    ctx = _ctx(Trace(_events(drop=drop)))
    assert request_idle_ms.read(ctx, "mps") == pytest.approx(idle)
    assert download_ms.read(ctx, "mps") == pytest.approx(down)
    assert capsys.readouterr().err.count("1 of 2 requests left out") == 2


def test_no_trace_gives_none():
    assert [r.read(_ctx(None), "mps") for r in READERS] == [None] * 3
