"""Each plain reference holds the port's CPU path at small widths: run in
float32, the port and the reference compute the same function."""

import time

import numpy as np
import pytest
import torch

from benchmark.data.clips import frames_uint_levels
from benchmark.drivers import fit, flow
from benchmark.flowmodels import raft as raft_model
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
    weights = raft_model.make_weights(3, cpu, torch.float32)
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


def test_the_reference_solved_a_direction_at_a_time_is_the_batched_solve():
    """The flow check solves a batch one direction at a time, so that the
    device holds one direction's all-pairs volume: the same flows as the
    whole batch at once."""
    cpu = torch.device("cpu")
    cell = small.flow_cell()
    config = cell.config
    frames = frames_uint_levels(config["clip"], 3, config["frame_size"],
                                2 ** 31 + 13, cpu).numpy()
    weights = raft_model.make_weights(2 ** 31 + 13, cpu, torch.float32)
    plain = raft_model.reference(weights)
    a, b = flow.stacked(frames, [0, 1])
    batched = raft_model.reference_flow(plain, torch.from_numpy(a),
                                        torch.from_numpy(b), config).numpy()
    one = flow.solved(raft_model, plain, frames, [0, 1], config, cpu)
    assert one.shape == batched.shape == (4, 128, 128, 2)
    assert float(np.abs(batched).max()) > 0.1
    assert flow.flow_gap(one, batched) < 1e-5


def test_flow_gap_is_the_worst_directions_mean_endpoint_error():
    want = np.zeros((2, 4, 4, 2))
    got = want.copy()
    got[1, ..., 0] = 3.0
    got[1, ..., 1] = 4.0
    assert flow.flow_gap(got, want) == pytest.approx(5.0)
