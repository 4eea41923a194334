"""A second flow model is new files: a module under `benchmark/flowmodels/`
that a configuration names, reached by the flow driver, its calibration
and the flow readers without an edit to any of them."""

import sys
import time
import types
from unittest import mock

import pytest
import torch

from benchmark import calibrate, flowmodels, run
from benchmark.core import manifest
from benchmark.counts import peaks
from benchmark.drivers import flow
from benchmark.flowmodels import raft as raft_model
from benchmark.tests import small

torch.set_num_threads(4)
CPU = torch.device("cpu")
SEED = 2 ** 31 + 41
FLOPS = 3.0e11          # the stand-in's FLOPs a direction


@pytest.fixture
def standin(monkeypatch):
    """RAFT under another name, with a fault of its own and its own count,
    as `benchmark.flowmodels.standin`; the list records the fault's calls."""
    entered = []
    module = types.ModuleType("benchmark.flowmodels.standin")
    module.__dict__.update({k: getattr(raft_model, k) for k in flowmodels.API})

    def state_unchanged():
        from deflicker_torch.models import raft

        def frozen(self, net, inp, corr, flow):
            entered.append(1)
            return net, torch.zeros_like(flow)
        return mock.patch.object(raft.BasicUpdateBlock, "forward", frozen)

    module.faults = lambda: {"state_unchanged": state_unchanged}
    module.direction_flops = lambda config: FLOPS
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return entered


def _cell():
    cell = small.flow_cell()
    cell.config["flow_model"] = "standin"
    return cell


def test_a_configuration_without_a_model_runs_raft():
    assert flowmodels.of(small.flow_cell().config) is raft_model
    assert all(callable(getattr(raft_model, k)) for k in flowmodels.API)


def test_a_stand_in_model_runs_through_the_driver_and_mfu(standin):
    cell = _cell()
    out = flow.measure(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert run.judge(cell, out)[0] is True
    assert not standin
    w = out["window"]
    reading = manifest.metric_reader(run.ROOT, "mfu.flow").read(
        types.SimpleNamespace(config=cell.config, window=w))
    assert reading == pytest.approx(
        100.0 * FLOPS * w["directions"] / (w["seconds"] * peaks.BF16_FLOPS))


def test_a_stand_in_model_is_calibrated_with_its_own_fault(standin):
    cell = _cell()
    rows = list(calibrate.rows(cell, CPU, [SEED], [SEED + 1], [SEED + 2], 0.2))
    assert [r["what"] for r in rows] == ["program", "control", "fault:state_unchanged",
                                         "fault:half_batch", "fault:answer_altered"]
    assert standin                      # the stand-in's fault, not RAFT's
    for row in rows:
        correct, _ = run.judge(cell, {"checks": row["readings"],
                                      "failed": row.get("failed", 0)})
        assert correct is (row["what"] == "program"), row
    summary = calibrate.summary(rows)
    assert summary["program/flow_epe"] < cell.limits["flow_epe"] < summary["control/flow_epe"]
