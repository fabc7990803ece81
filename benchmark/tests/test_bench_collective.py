"""The collectives' readers (`collective.device_ms`, `collective.busbw_pct`,
`collective.calls`) and their yardstick (`benchmark/roofline_collective.py`),
each given a synthetic traced slice and synthetic program counters: the
value, 100% exactly at the link's peak, and nothing on a one-card record
or where the program counts no collectives."""

import pytest

from acas2d_tpu_torch.utils import profiling
from benchmark import roofline_collective, spec, tracing

BASE = 1_000_000.0          # the slice's start on the host clock, us
NCCL_AR = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
NCCL_AG = "ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage)"


def _trace(device, calls=((0.0, 1000.0),), world=4, iterations=2):
    """A slice [0, 1000] us after BASE holding `device` (name, start,
    end) and `bench.call` spans `calls`."""
    return tracing.Trace(
        BASE, BASE + 1000.0,
        [tracing.Event(n, BASE + a, b - a) for n, a, b in device],
        [tracing.Event("bench.call", BASE + a, b - a) for a, b in calls],
        {"iterations": iterations, "world": world})


@pytest.fixture
def counters(monkeypatch):
    def put(c):
        monkeypatch.setattr(profiling, "counters", lambda: dict(c))
    return put


def read(name, trace):
    return spec.reader(name).read({"trace": trace})


def _counts(ar=4, ar_bytes=0, ag=2, ag_bytes=0):
    return {"collective.all_reduce": ar, "collective.all_reduce.bytes":
            ar_bytes, "collective.all_gather": ag,
            "collective.all_gather.bytes": ag_bytes}


def test_device_ms_is_the_nccl_kernels_union_inside_the_calls(counters):
    """Two overlapping NCCL kernels (100-300, 200-400: 300 us), one more
    (600-700), a gradient kernel and an NCCL kernel outside the calls left
    out: 0.4 ms over 2 iterations."""
    tr = _trace([(NCCL_AR, 100, 300), (NCCL_AG, 200, 400),
                 ("grad_partials_tf32x3", 300, 500), (NCCL_AR, 600, 700),
                 (NCCL_AR, 950, 990)], calls=((0, 900),))
    assert read("collective.device_ms", tr) == pytest.approx(0.2)
    assert read("collective.device_ms",
                _trace([("grad_partials_tf32x3", 0, 10)])) is None


def test_busbw_is_the_least_bytes_over_the_nccl_time(counters):
    """4 ranks: 3/4 of 400 KB of all-reduced buffers and 3.6 MB of gathered
    output is 3 MB, over 100 us of NCCL time: 30 GB/s, 6.667% of 450."""
    counters(_counts(ar_bytes=400e3, ag_bytes=3.6e6))
    tr = _trace([(NCCL_AR, 100, 150), (NCCL_AG, 150, 200)])
    assert read("collective.busbw_pct", tr) == pytest.approx(
        100 * 30e9 / 450e9)


def test_busbw_reads_100_at_the_links_peak(counters):
    """The least bytes taking exactly the time they take at 450 GB/s."""
    ar, ag = 1.2e6, 8.0e6
    least_us = roofline_collective.least_seconds(4, ar, ag) * 1e6
    assert least_us == pytest.approx(0.75 * 9.2e6 / 450e9 * 1e6)
    counters(_counts(ar_bytes=ar, ag_bytes=ag))
    tr = _trace([(NCCL_AG, 100, 100 + least_us)])
    assert read("collective.busbw_pct", tr) == pytest.approx(100.0)


def test_nothing_on_a_one_card_record_or_without_counters(counters):
    counters(_counts(ar_bytes=1e6, ag_bytes=1e6))
    one = _trace([(NCCL_AR, 100, 200)], world=1)
    assert read("collective.busbw_pct", one) is None
    del one.work["world"]
    assert read("collective.busbw_pct", one) is None
    counters({})                      # a program without the counters
    tr = _trace([(NCCL_AR, 100, 200)])
    assert read("collective.busbw_pct", tr) is None
    assert read("collective.calls", tr) is None
    assert read("collective.calls", None) is None
    assert read("collective.device_ms", None) is None


def test_calls_are_the_counted_collectives_an_iteration(counters):
    counters(_counts(ar=1282, ag=2))
    assert read("collective.calls", _trace([])) == 642.0
