"""The sample-sharded fit's step as a captured step (deflicker_torch/atlas
/graphs.py, `run_fit_schedule` with a mesh) on the CPU: the gate that
captures it under NCCL and keeps it eager under gloo, and two gloo ranks
whose sharded steps go through a stand-in for `torch.cuda.CUDAGraph` with
the gate lifted (tests/parallel_ranks.py `_RankGraphs`: the capture
launches nothing, a replay runs the step) against the same ranks run
eagerly."""

import dataclasses

import numpy as np
import pytest
import torch

from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas.data import VideoData
from deflicker_torch.atlas.graphs import FitGraphs
from deflicker_torch.config import AtlasConfig
from deflicker_torch.parallel import launch
from deflicker_torch.utils.checkpoint import to_host

from tests import parallel_ranks
from tests.test_torch_parallel import NARROW, TIMEOUT, video_arrays

torch.set_num_threads(2)

CARD = torch.device("cuda", 0)     # a device object only: nothing runs on it


@pytest.mark.parametrize("backend,captured", [(None, True), ("nccl", True),
                                              ("gloo", False)])
def test_the_gate_captures_the_sharded_fit_under_nccl(capsys, backend,
                                                      captured):
    """On the card a fit without a collective and the sample-sharded fit
    under NCCL are captured, silently; under gloo the sharded fit runs
    eagerly and says so, and why, on one line to stderr."""
    assert FitGraphs().capturing(CARD, "fit", backend) is captured
    err = capsys.readouterr().err.splitlines()
    if captured:
        assert err == []
    else:
        assert err == ["[deflicker_torch] fit steps run uncaptured: gloo "
                       "stages the sample-sharded fit's gradient all-reduce "
                       "through the host"]


def test_the_gate_keeps_the_cpu_anomaly_mode_and_eager_uncaptured(capsys):
    """The CPU, anomaly mode and `eager=True` keep even an NCCL sharded
    fit eager, each with its line."""
    cpu = torch.device("cpu")
    assert not FitGraphs().capturing(cpu, "fit", "nccl")
    with torch.autograd.set_detect_anomaly(True):
        assert not FitGraphs().capturing(CARD, "fit", "nccl")
    assert not FitGraphs(eager=True).capturing(CARD, "fit", "nccl")
    err = capsys.readouterr().err.splitlines()
    assert err == [
        "[deflicker_torch] fit steps run uncaptured: the CPU has no CUDA "
        "graphs",
        "[deflicker_torch] fit steps run uncaptured: autograd's anomaly "
        "mode (DEFLICKER_DEBUG_NANS) syncs at every node of the backward",
        "[deflicker_torch] fit steps run uncaptured: the caller asked for it"]


ITERS, PER_CALL, GLOBAL = 10, 3, 4


@pytest.fixture(scope="module")
def graph_fit_out():
    cfg = dataclasses.replace(AtlasConfig(), **NARROW, iters_num=ITERS,
                              steps_per_call=PER_CALL,
                              stop_global_rigidity=GLOBAL,
                              evaluate_every=ITERS + 1)
    host = to_host(teng.init_models(teng.build_specs(cfg),
                                    torch.Generator().manual_seed(0)))
    return launch(parallel_ranks.graph_fit, 2, "cpu",
                  (host, cfg, VideoData(*video_arrays())), timeout=TIMEOUT)


def test_captured_sharded_fit_equals_eager_on_two_ranks(graph_fit_out):
    """Two gloo ranks, 10 sharded steps in two loss phases, through the
    stand-in graphs and eagerly: params and logs bit-equal across the two
    routes and the two ranks; one capture a loss phase, after its two
    warm-up steps."""
    ref = graph_fit_out[0]["eager"]
    for out in graph_fit_out:
        for route in ("captured", "eager"):
            np.testing.assert_array_equal(out[route]["params"], ref["params"])
            assert out[route]["logs"] == ref["logs"]
        assert out["captured"]["captured"] == 2
        assert out["eager"]["captured"] == 0
        assert out["backends"] == ["gloo"]


def test_each_replay_runs_the_all_reduce_once(graph_fit_out):
    """Every replay of the sharded step runs one all-reduce (its
    gradients'); a run's count is one a step plus one a chunk (the chunk
    sums at its host sync), captured or eager."""
    for out in graph_fit_out:
        assert out["per_replay"] == [1] * (ITERS - 2 * 2)
        chunks = len(out["eager"]["logs"])
        for route in ("captured", "eager"):
            assert out[route]["all_reduces"] == ITERS + chunks
