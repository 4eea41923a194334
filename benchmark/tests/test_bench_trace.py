"""The reduction of a profiled window: busy time as the union of device
intervals, idle gaps named by what the host was doing."""

import types

import pytest
from torch.autograd import DeviceType

from benchmark.core import trace


def _ev(name, start, end, device=False, annotation=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_union_gaps_and_names():
    events = [
        _ev("bench/window", 0, 1000),
        _ev("bench/fit", 100, 1000),
        _ev("bench/job_init", 0, 100),
        _ev("cudaGraphLaunch", 300, 500),
        _ev("k1", 50, 150, device=True),
        _ev("k2", 120, 200, device=True),      # overlaps k1
        _ev("k3", 210, 300, device=True),      # 10 us gap: between ops
        _ev("k4", 400, 900, device=True),      # 100 us gap while launching
        _ev("Optimizer.step", 0, 1000, device=True, annotation=True),
    ]
    out = trace.reduce(events, wall_s=1e-3)
    assert out["busy_s"] == pytest.approx((150 + 90 + 500) * 1e-6)
    gaps = out["idle_gaps"]
    assert gaps["between_ops"] == pytest.approx(10e-6)
    assert gaps["fit/cudaGraphLaunch"] == pytest.approx(100e-6)
    assert gaps["job_init/python"] == pytest.approx(50e-6)
    assert gaps["fit/python"] == pytest.approx(100e-6)
    assert out["op_seconds"]["k4"] == pytest.approx(500e-6)
    assert "Optimizer.step" not in out["op_seconds"]
    b = trace.breakdown(out)
    assert b["device_ops"][0][0] == "k4" and len(b["idle_gaps"]) == 4


def test_a_window_is_required():
    with pytest.raises(RuntimeError):
        trace.reduce([_ev("k", 0, 1, device=True)], wall_s=1.0)
