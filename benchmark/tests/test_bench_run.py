"""A run's result line, and `correct` coming out false when the timed path
is broken underneath (each fault a cell can have) or replaced by the
control: the harness's look for a card skipped, the rest of a run driven
on the CPU at a size a test can hold."""

import json
import time

import pytest
import torch

from benchmark import run
from benchmark.drivers import fit, flow
from benchmark.tests import small

torch.set_num_threads(4)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 21


def _fake_out(trace):
    out = {"e2e": {"fit_its": 380.5}, "setup_s": 17.25, "attempted": 2,
           "failed": 0, "memory_peak_bytes": 123,
           "window": {"seconds": 30.1, "spans": [(0, 10001), (0, 1200)],
                      "videos": 1, "video_steps": 11201},
           "checks": {"loss_gap": 1e-4, "grad_gap": 1e-3, "update_gap": 1e-3}}
    if trace:
        out["trace"] = {"window_s": 0.5, "busy_s": 0.4, "spans": [(4951, 5051)],
                        "ops": [("void chain_fwd_kernel<false, true>(x)", 0.2),
                                ("elementwise", 0.1)],
                        "op_seconds": {"void chain_fwd_kernel<false, true>(x)": 0.2,
                                       "elementwise": 0.1},
                        "idle_gaps": {"between_ops": 0.05, "fit/python": 0.05}}
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(capsys, monkeypatch, trace):
    from benchmark.core import manifest
    from deflicker_torch.utils import trace as program_trace

    # the program's counters are the process's: what earlier tests counted
    # is not this fake run's
    monkeypatch.setattr(program_trace, "counters", dict)
    cell = manifest.cell("single-fit", run.ROOT)
    assert run.report(cell, _fake_out(trace), trace, device_name="cpu") == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "update_gap"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if trace:
        assert set(line["metrics"]) == {"mfu.fit", "chain_roofline_share.fit",
                                        "loss_device_ms_per_step.fit",
                                        "device_idle_share.fit"}
        assert line["device"]["busy_s"] == 0.4 and line["device"]["window_s"] == 0.5
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["metrics"]["device_idle_share.fit"]["value"] == pytest.approx(20.0)
    else:
        assert set(line["metrics"]) == {"fit_its", "setup_s"}
        assert line["metrics"]["fit_its"] == {"value": 380.5, "unit": "video-it/s"}


def test_a_forbidden_module_means_no_result(capsys, monkeypatch):
    from benchmark.core import manifest

    cell = manifest.cell("single-fit", run.ROOT)
    monkeypatch.setitem(__import__("sys").modules, "jax", json)
    assert run.report(cell, _fake_out(False), False, device_name="cpu") != 0
    assert capsys.readouterr().out == ""


def _fit(cell, seconds=0.2):
    return fit.measure(cell, SEED, seconds, False, CPU, time.perf_counter())


@pytest.mark.parametrize("fault", sorted(fit.faults(small.fit_cell())))
def test_a_fit_fault_is_not_correct(fault):
    cell = small.fit_cell()
    with fit.faults(cell)[fault]():
        out = _fit(cell)
    assert run.judge(cell, out)[0] is False


def test_the_fit_control_is_not_correct():
    cell = small.fit_cell()
    readings, _ = fit.control(cell, SEED, CPU)
    assert run.judge(cell, {"checks": readings, "failed": 0})[0] is False


@pytest.mark.parametrize("fault", sorted(flow.faults(small.flow_cell())))
def test_a_flow_fault_is_not_correct(fault):
    cell = small.flow_cell()
    with flow.faults(cell)[fault]():
        out = flow.measure(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert run.judge(cell, out)[0] is False


def test_the_flow_control_is_not_correct():
    cell = small.flow_cell()
    readings, _ = flow.control(cell, SEED, CPU)
    assert run.judge(cell, {"checks": readings, "failed": 0})[0] is False


@pytest.mark.parametrize("kind", ["fit", "flow"])
def test_a_traced_run_reduces_its_window(kind, monkeypatch):
    """The traced path end to end on the CPU: the profiled window closes,
    and the readers that find nothing to read (no device here) return
    nothing."""
    if kind == "fit":
        cell = small.fit_cell()
        cell.config["atlas"].update(stop_global_rigidity=30, iters_num=60)
        monkeypatch.setattr(fit, "PROFILE_SPAN", 10)
        out = fit.measure(cell, SEED, 0.2, True, CPU, time.perf_counter())
        assert out["trace"]["spans"] == [(21, 41)]
    else:
        cell = small.flow_cell()
        out = flow.measure(cell, SEED, 0.2, True, CPU, time.perf_counter())
        assert out["trace"]["batches"] == [4, 2]
    assert out["trace"]["window_s"] > 0 and out["trace"]["ops"] == []
    from benchmark.core import manifest

    cell.per_layer = manifest.cell("single-fit" if kind == "fit" else "single-flow",
                                   run.ROOT).per_layer
    metrics = run.per_layer(cell, out)
    assert set(metrics) == {f"mfu.{kind}"}
