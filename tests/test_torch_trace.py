"""The port's spans and counters (deflicker_torch/utils/trace.py) on the
CPU: off, a span is one flag test and enters no profiler range; on, it is
a `deflicker/<name>` range of the profiler's trace at the logged times,
nested under its parent; and the fit loop, the flow batch, stage 2 and the
graphs log and count what they say they do."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deflicker_torch.atlas import engine as teng
from deflicker_torch.utils import trace

from tests.test_torch_fit_graph import FakeGraphs, setup, video_dir  # noqa: F401
from tests.test_torch_infer_graph import (FakeInferenceGraphs, _engine,
                                          _pairs, _raft, _write_frames)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def fresh_log():
    trace.clear()
    yield
    trace.clear()


def _names(spans):
    return [s[0] for s in spans]


def test_a_span_off_is_shared_and_enters_no_range(monkeypatch):
    """With no profiler and no `recording()`, every span is the one shared
    no-op context: `record_function` is never called and nothing is
    logged."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        with trace.span("b"):
            pass
    assert entered == [] and trace.spans() == []


def test_a_span_entered_before_the_profiler_records_nothing():
    """Whether a span records is decided when it is entered: one entered
    before the profiler starts makes no `deflicker/` event and no log
    entry; one entered inside the profile does."""
    with trace.span("before"):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with trace.span("inside"):
                pass
    names = [ev.name for ev in prof.events()]
    assert "deflicker/inside" in names
    assert not any(n == "deflicker/before" for n in names)
    assert _names(trace.spans()) == ["inside"]


def _profiled_spans():
    """(the logged spans, their `deflicker/` events by name as (start,
    end) Unix ns) of a CPU profile.  The block runs twice in the profile
    and only the second pass is logged: a profile's first ranges pay its
    lazy set-up between the profiler's stamp and the log's."""
    def block():
        for _ in range(3):
            with trace.span("outer"):
                torch.ones(256).sum()
                with trace.span("inner"):
                    torch.ones(256).cumsum(0)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        block()
        trace.clear()
        block()
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(trace.PREFIX):
            events.setdefault(ev.name()[len(trace.PREFIX):], []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return trace.spans(), events


def test_spans_are_profiler_ranges_on_its_clock():
    """Under a CPU profiler every logged span has its `deflicker/<name>`
    event, whose start and end agree with the log's times (read on the
    profiler's clock through `clock_offset_ns`) within 100 us.  The host
    may be preempted between the two stamps, so a profile where a span
    reads off is made again, up to three times in all."""
    for _ in range(3):
        logged, events = _profiled_spans()
        assert sorted(_names(logged)) == 3 * ["inner"] + 3 * ["outer"]
        assert {n: len(e) for n, e in events.items()} == {"inner": 6,
                                                          "outer": 6}
        off = trace.clock_offset_ns()
        worst = 0
        for name, _, t0, t1 in logged:
            start, end = min(events[name], key=lambda e: abs(e[0] - t0 - off))
            worst = max(worst, abs(t0 + off - start), abs(t1 + off - end))
        if worst < 100_000:
            return
    pytest.fail(f"a span's log and event differ by {worst} ns")


def test_parents_nest():
    with trace.recording():
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
            with trace.span("d"):
                pass
        with trace.span("e"):
            pass
    logged = {s[0]: s for s in trace.spans()}
    assert {n: s[1] for n, s in logged.items()} == {
        "a": None, "b": "a", "c": "b", "d": "a", "e": None}
    for child in "bcd":
        parent = logged[logged[child][1]]
        assert parent[2] <= logged[child][2] <= logged[child][3] <= parent[3]
    assert not trace.enabled()


def test_counters_are_always_on_and_clear_resets():
    trace.count("x")
    trace.count("x", 4)
    trace.add_seconds("s", 0.25)
    trace.add_seconds("s", 0.5)
    assert trace.counters() == {"x": 5, "s": 0.75}
    trace.clear()
    assert trace.counters() == {} and trace.spans() == []


def test_fit_logs_each_chunk_and_counts_its_graphs(setup):  # noqa: F811
    """A fit through the stand-in graphs, 4 chunks over two loss phases
    (ends 4, 6, 10, 11; an eval at 10): one `fit/start` and `fit/end`, a
    `fit/chunk` a chunk around its replay, sync, check, store and log, the
    eval's span once; the step's spans inside the replays; the warm-ups'
    and captures' seconds and the fit's start counted, once the start's
    state is made."""
    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=12, steps_per_call=5,
                            stop_global_rigidity=6, evaluate_every=10)
    p = {k: [{kk: t.detach().clone().requires_grad_() for kk, t in l.items()}
             for l in v] for k, v in params.items()}
    fake = FakeGraphs(keep=True)
    with trace.recording():
        teng.fit_atlas(p, specs, data, c, torch.Generator().manual_seed(0),
                       graphs=fake)
    logged = trace.spans()
    fit = [s for s in logged if s[0].startswith("fit/")]
    parents = {(n, par) for n, par, _, _ in fit}
    assert parents == {("fit/start", None), ("fit/end", None),
                       ("fit/chunk", None)} | {
        (f"fit/{part}", "fit/chunk")
        for part in ("replay", "sync", "check", "store", "log", "eval")}
    names = _names(fit)
    assert names.count("fit/start") == names.count("fit/end") == 1
    for part in ("chunk", "replay", "sync", "check", "store", "log"):
        assert names.count(f"fit/{part}") == 4, part
    assert names.count("fit/eval") == 1
    for part in ("loss", "backward", "adam"):
        assert {par for n, par, _, _ in logged
                if n == f"step/{part}"} == {"fit/replay"}
    # within a chunk: replay, sync, check, store, log in that order
    chunks = [s for s in fit if s[0] == "fit/chunk"]
    for _, _, c0, c1 in chunks:
        inside = [s for s in fit if s[1] == "fit/chunk" and c0 <= s[2] <= c1]
        order = [n for n in _names(inside) if n != "fit/eval"]
        assert order == ["fit/replay", "fit/sync", "fit/check", "fit/store",
                         "fit/log"]
    (st,) = fake.states.values()
    assert sum(step.warm for step in st.steps.values()) == 4
    assert fake.captured == 2
    counts = trace.counters()
    assert set(counts) == {"graphs.state_made", "graphs.warmup_s",
                           "graphs.capture_s", "fit.start_s"}
    assert counts["graphs.state_made"] == 1
    assert counts["graphs.warmup_s"] > 0 and counts["graphs.capture_s"] > 0
    start = [t1 - t0 for n, _, t0, t1 in logged if n == "fit/start"]
    assert 0 < 1e9 * counts["fit.start_s"] - start[0] < 1e6


def test_pretrain_is_one_span(setup):  # noqa: F811
    cfg, data, specs, params = setup
    mapping = [{k: t.detach().clone().requires_grad_() for k, t in l.items()}
               for l in params["mapping1"]]
    with trace.recording():
        teng.pretrain_mapping(mapping, specs.mapping1,
                              torch.Generator().manual_seed(1), 4, 24, 32, 0.8,
                              pretrain_iters=1, batch=32)
    assert [(n, par) for n, par, _, _ in trace.spans()] == [
        ("fit/pretrain", None)]


def test_flow_batch_logs_its_parts_and_returns_the_same_flows():
    """`compute_batch` through the stand-in graphs: off, nothing is
    logged; on, each batch logs `flow/upload`, `flow/solve`, `flow/wait`
    and `flow/download` once, in that order, inside `flow/batch`, and the
    flows equal the ones solved with tracing off bit for bit.  The
    solve's key is made once and loaded after."""
    off, on = _raft(capture=True), _raft(capture=True)
    batches = [_pairs(2, s) for s in range(3)]
    want = [off.compute_batch(a, b) for a, b in batches]
    assert trace.spans() == []
    trace.clear()
    with trace.recording():
        got = [on.compute_batch(a, b) for a, b in batches]
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    logged = trace.spans()
    assert _names(logged) == 3 * ["flow/upload", "flow/solve", "flow/wait",
                                  "flow/download", "flow/batch"]
    assert {par for n, par, _, _ in logged if n != "flow/batch"} == {
        "flow/batch"}
    counts = trace.counters()
    assert on.graphs.captured == 1
    assert (counts["graphs.state_made"], counts["graphs.state_loaded"]) == (1, 2)


def test_flow_batch_off_takes_no_wait(monkeypatch):
    """Off, a batch takes no `flow/wait` (on the card a stream sync, which
    only a traced batch makes) and logs nothing; on, it takes the wait
    once and returns the same flows."""
    eng = _raft(capture=False)
    waits = []
    real = trace.span
    monkeypatch.setattr(trace, "span", lambda name: (
        waits.append(name) if name == "flow/wait" else None) or real(name))
    flows = eng.compute_batch(*_pairs(1, 0))
    assert waits == [] and trace.spans() == [] and trace.counters() == {}
    with trace.recording():
        np.testing.assert_array_equal(eng.compute_batch(*_pairs(1, 0)), flows)
    assert waits == ["flow/wait"]
    assert _names(trace.spans()).count("flow/wait") == 1


def test_filter_run_logs_the_six_stage2_parts(tmp_path):
    """`FilterEngine.run` over 7 frames in spans of 3 logs its six parts:
    a read wait, a U-Net and a refinement a span, the device-to-host
    copies, the writer waits and the encodes once."""
    content = _write_frames(tmp_path / "c", 0, 7)
    style = _write_frames(tmp_path / "s", 1, 7)
    eng = _engine(capture=False, span=3)
    assert not hasattr(eng, "timer")
    with trace.recording():
        eng.run(content, style, tmp_path / "r", save_concat=False)
    names = _names(trace.spans())
    parts = {n for n in names if n.startswith("stage2/")}
    assert parts == {f"stage2/{p}" for p in ("read_wait", "unet", "refine",
                                             "d2h", "write_wait", "encode")}
    for part, n in (("read_wait", 3), ("unet", 3), ("refine", 3),
                    ("encode", 1)):
        assert names.count(f"stage2/{part}") == n, part
    assert {par for n, par, _, _ in trace.spans() if n in parts} == {None}


def test_inference_keys_count_made_loaded_and_evicted():
    """Past `MAX_KEYS` (4) keys the least recently used entry goes."""
    g = FakeInferenceGraphs()
    for k in (0, 1, 2, 3, 1, 4):
        g.entry((k,), object)
    assert trace.counters() == {"graphs.state_made": 5,
                                "graphs.state_loaded": 1,
                                "graphs.evicted": 1}


def test_a_profile_trace_holds_the_fit_ranges(setup, tmp_path,  # noqa: F811
                                              monkeypatch):
    """`DEFLICKER_PROFILE`'s Chrome trace of a fit holds the fit's
    `deflicker/fit/...` ranges with no switch of their own."""
    import json

    from deflicker_torch.cli.pipeline import fit_profiler

    cfg, data, specs, params = setup
    c = dataclasses.replace(cfg, iters_num=4, steps_per_call=2)
    p = {k: [{kk: t.detach().clone().requires_grad_() for kk, t in l.items()}
             for l in v] for k, v in params.items()}
    monkeypatch.setenv("DEFLICKER_PROFILE", str(tmp_path))
    with fit_profiler(torch.device("cpu")):
        teng.fit_atlas(p, specs, data, c, torch.Generator().manual_seed(0))
    (path,) = tmp_path.glob("*.json")
    names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]
    for part in ("start", "chunk", "replay", "sync", "end"):
        assert f"deflicker/fit/{part}" in names, part
    assert names.count("deflicker/fit/chunk") == 2
    assert not trace.enabled()


def test_a_served_job_reports_its_graph_counts():
    """`cli.serve.handle_job` adds to each result the job's growth of the
    `graphs.*` counters, and nothing of other counters or earlier jobs."""
    from deflicker_torch.cli.serve import handle_job

    class Warm:
        def process(self, **job):
            trace.count("graphs.state_made", job["seed"])
            trace.count("graphs.state_loaded")
            trace.add_seconds("graphs.capture_s", 0.25)
            trace.add_seconds("fit.start_s", 1.0)
            return {"psnr": 30.0}

    trace.count("graphs.state_made", 7)
    first = handle_job(Warm(), {"seed": 2})
    again = handle_job(Warm(), {"seed": 0})
    assert first["graphs"] == {"state_made": 2, "state_loaded": 1,
                               "capture_s": 0.25}
    assert again["graphs"] == {"state_loaded": 1, "capture_s": 0.25}
    assert first["ok"] and first["psnr"] == 30.0


def _gma(capture):
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.models.gma import gma_init

    model = gma_init(torch.Generator().manual_seed(0), gamma=1.0)
    eng = RAFTFlow(model=model, iters=2, dtype=torch.float32, device="cpu",
                   corr_mode="kernel", capture=False)
    if capture:
        eng.graphs = FakeInferenceGraphs(what="GMA solves")
    return eng


def test_an_eager_gma_solve_logs_its_attention_inside_the_solve():
    """An eager GMA batch logs `flow/attention` once, inside `flow/solve`,
    and a RAFT batch logs none; off, nothing is logged."""
    eng = _gma(capture=False)
    flows = eng.compute_batch(*_pairs(1, 0))
    assert trace.spans() == []
    with trace.recording():
        np.testing.assert_array_equal(eng.compute_batch(*_pairs(1, 0)), flows)
        _raft(capture=False).compute_batch(*_pairs(1, 0))
    logged = [(n, par) for n, par, _, _ in trace.spans()]
    assert logged.count(("flow/attention", "flow/solve")) == 1
    assert [n for n, _ in logged].count("flow/attention") == 1


def test_gma_attention_counters_grow_once_per_graph_key():
    """Through the stand-in graphs, two batch shapes solved three times
    each: `flow.attention_made` grows at each key's first, eager solve and
    at its capture (P and its row statistics made inside the solve, where a
    capture takes them from the graphs' pool) and never in its replays,
    and `flow.attention_bytes` holds their bytes (an f32 solve on the CPU:
    P f32, N x N a direction, and the f32 row statistics).  A RAFT engine
    makes none."""
    eng = _gma(capture=True)
    grown = []
    for B in (2, 1, 2, 1, 2, 1):
        before = trace.counters().get("flow.attention_made", 0)
        eng.compute_batch(*_pairs(B, B))
        grown.append(trace.counters().get("flow.attention_made", 0) - before)
    assert grown == [2, 2, 0, 0, 0, 0]
    N = 8 * 8                                       # 64 x 64 frames
    nbytes = [B * N * N * 4 + B * N * 8 for B in (2, 1)]
    assert trace.counters()["flow.attention_bytes"] == 2 * sum(nbytes)
    assert eng.graphs.captured == 2
    trace.clear()
    _raft(capture=True).compute_batch(*_pairs(2, 0))
    assert "flow.attention_made" not in trace.counters()
