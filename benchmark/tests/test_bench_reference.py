"""Each plain reference holds the port's CPU path at small widths: run in
float32, the port and the reference compute the same function."""

import time

import numpy as np
import pytest
import torch

from benchmark.drivers import fit, flow
from benchmark.reference import raft as reference
from benchmark.tests import small

torch.set_num_threads(4)


@pytest.mark.parametrize("dual,videos", [(False, 1), (True, 1), (False, 2)])
def test_fit_reference_follows_the_port_in_float32(dual, videos):
    cell = small.fit_cell(dual=dual, videos=videos)
    cell.config["atlas"]["fit_precision"] = "highest"
    out = fit.measure(cell, 2 ** 31 + 11, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert out["failed"] == 0
    # float32 on both sides: the sums differ in order only
    assert out["checks"]["loss_gap"] < 1e-5
    assert out["checks"]["grad_gap"] < 1e-3
    assert out["checks"]["update_gap"] < 1e-3


def test_raft_reference_follows_the_port_in_float32():
    from deflicker_torch.models.raft import RAFT, raft_flow

    cpu = torch.device("cpu")
    weights = flow.make_weights(3, cpu, torch.float32)
    with torch.device("meta"):
        model = RAFT()
    model.load_state_dict(weights, strict=True, assign=True)
    gen = torch.Generator().manual_seed(4)
    a = torch.rand((2, 128, 128, 3), generator=gen) * 255
    b = torch.roll(a, shifts=(3, -2), dims=(1, 2))
    got = raft_flow(model, a, b, iters=4, corr_mode="materialized")[1]
    want = reference.flow(reference.Model(weights), a, b, iters=4)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) < 1e-3 * max(scale, 1.0)


def test_flow_gap_is_the_worst_directions_mean_endpoint_error():
    want = np.zeros((2, 4, 4, 2))
    got = want.copy()
    got[1, ..., 0] = 3.0
    got[1, ..., 1] = 4.0
    assert flow.flow_gap(got, want) == pytest.approx(5.0)
