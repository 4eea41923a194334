"""GMA, the second flow model: its module resolves with the whole API, its
counts agree with hand formulas at 1080p, the flow check holds the program
at a small size and fails the control and each fault, and the attention
readers read a synthetic trace."""

import copy
import importlib.util
import json
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import flowmodels, run
from benchmark.core.manifest import Cell
from benchmark.counts import gma as counts
from benchmark.counts import peaks, raft
from benchmark.drivers import flow
from benchmark.flowmodels import gma as gma_model

torch.set_num_threads(4)
ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 61


def _config() -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / "deflicker-gma-1080p.json")
                      .read_text())


def small_cell() -> Cell:
    """gma-flow-1080p at 128 x 192 frames (16 x 24 positions), batches of 2
    pairs: the published widths and 20 iterations, its own limits."""
    config = copy.deepcopy(_config())
    config["frame_size"] = [128, 192]
    config["gma"].update(pair_batch=2)
    return Cell(name="gma-flow-1080p", root=ROOT, config=config,
                traffic={"kind": "flow", "frames": 4}, chips=1,
                limits=json.loads((ROOT / "benchmark" / "limits" / "gma-flow-1080p.json")
                                  .read_text()),
                end_to_end=[], per_layer=[])


def test_the_configuration_names_gma_with_the_whole_api():
    model = flowmodels.of(_config())
    assert model is gma_model
    assert all(callable(getattr(model, k)) for k in flowmodels.API)
    assert callable(model.attention_bound_s) and model.ATTENTION_KERNELS
    assert set(model.faults()) == {"state_unchanged", "aggregate_dropped", "keys_rolled"}
    assert model.settings(_config())["dim_head"] == 128


def test_the_weights_load_strictly_into_the_port_and_the_reference():
    from deflicker_torch.models.gma import GMA

    weights = gma_model.make_weights(SEED, CPU, torch.float32)
    with torch.device("meta"):
        model = GMA()
    model.load_state_dict(weights, strict=True, assign=True)
    assert float(weights["update_block.aggregator.gamma"]) == gma_model.GAMMA != 0
    qk = weights["att.to_qk.weight"]
    conv = weights["update_block.aggregator.to_v.weight"]
    # to_qk's rows sum to zero over the input channels, and it is drawn
    # wider than the plain convolutions, by the gain found for the seed;
    # the flow head's output taps sum to zero for each (output, input)
    assert float(qk.sum(dim=1).abs().max()) < 1e-4 * float(qk.abs().max())
    assert 1.0 < float(qk.std()) / float(conv.std()) < gma_model.QK_GAIN_MAX
    head = weights[gma_model.HEAD]
    assert float(head.sum(dim=(2, 3)).abs().max()) < 1e-4 * float(head.abs().max())
    again = gma_model.make_weights(SEED, CPU, torch.float32)
    assert all(torch.equal(weights[k], again[k]) for k in weights)


def test_counts_by_hand_at_1080p():
    H, W, iters = 1080, 1920, 20
    N = 135 * 240
    build = 2 * N * N * 128
    assert build == pytest.approx(268.7e9, rel=1e-3)
    gru = 6 * 2 * 128 * 5 * 128 * N               # 128 more input channels a conv
    to_v = 2 * 128 * 128 * N
    to_qk = 2 * 128 * 256 * N
    want = raft.direction_flops(H, W, iters) + to_qk + build + iters * (build + gru + to_v)
    got = counts.direction_flops(H, W, iters)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(10.78e12, rel=1e-3)
    assert raft.direction_flops(H, W, iters) == pytest.approx(4.475e12, rel=1e-3)
    assert (gru + to_v) == pytest.approx(32.9e9, rel=1e-3)
    share = (build * (1 + iters)) / got
    assert 0.51 < share < 0.53
    # the bound: the same work whatever implements it, products bound it
    one = counts.attention_bound_s(1, 135, 240, iters)
    assert one == pytest.approx(21 * build / peaks.BF16_FLOPS, rel=1e-12)
    assert one == pytest.approx(5.7e-3, rel=0.01)
    assert counts.attention_bound_s(8, 135, 240, iters) == pytest.approx(8 * one)
    nbytes = 8 * 2.0 * N * 128 * (2 + 2 * iters)
    assert nbytes / peaks.HBM_BYTES < 8 * one


def test_the_small_cell_is_correct_and_reports_its_counts():
    cell = small_cell()
    out = flow.measure(cell, SEED, 0.2, False, CPU, time.perf_counter())
    correct, checks = run.judge(cell, out)
    assert correct is True, checks
    assert out["window"]["directions"] > 0


@pytest.mark.parametrize("fault", sorted(flow.faults(small_cell())))
def test_a_gma_fault_is_not_correct(fault):
    cell = small_cell()
    with flow.faults(cell)[fault]():
        out = flow.measure(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert run.judge(cell, out)[0] is False, out["checks"]


def test_the_gma_control_is_not_correct():
    cell = small_cell()
    readings, _ = flow.control(cell, SEED, CPU)
    assert run.judge(cell, {"checks": readings, "failed": 0})[0] is False, readings


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(config, trace):
    return types.SimpleNamespace(config=config, trace=trace)


def _trace():
    """Two profiled batches, 8 and 6 directions: 105 ms in the attention
    kernels, beside a convolution and a lookup."""
    return {"batches": [8, 6],
            "ops": [("void (anonymous namespace)::gma_attn_build_kernel<false>(x)", 0.004),
                    ("void (anonymous namespace)::gma_attn_build_kernel<true>(x)", 0.006),
                    ("void (anonymous namespace)::gma_attn_aggregate_kernel<bf16>(x)", 0.095),
                    ("sm90_xmma_fprop_implicit_gemm_bf16", 0.3),
                    ("corr_lookup_kernel<256>", 0.1)]}


def test_the_attention_readers_on_a_synthetic_trace():
    config = _config()
    share = _reader("attn_roofline_share.flow").read(_run(config, _trace()))
    bound = counts.attention_bound_s(14, 135, 240, 20)
    assert share == pytest.approx(100.0 * bound / 0.105)
    ms = _reader("attn_ms_per_batch.flow").read(_run(config, _trace()))
    assert ms == pytest.approx(1e3 * 0.105 / 2)


@pytest.mark.parametrize("name", ["attn_roofline_share.flow", "attn_ms_per_batch.flow"])
def test_the_attention_readers_read_nothing_without_attention(name):
    reader = _reader(name)
    raft_config = json.loads((ROOT / "benchmark" / "configs" / "deflicker-single.json")
                             .read_text())
    assert reader.read(_run(raft_config, _trace())) is None     # RAFT has none
    assert reader.read(_run(_config(), None)) is None
    no_attention = dict(_trace(), ops=[("corr_lookup_kernel<256>", 0.1)])
    assert reader.read(_run(_config(), no_attention)) is None
