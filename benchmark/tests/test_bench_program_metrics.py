"""The per-layer metrics read from the program's own spans and counters
(`deflicker_torch.utils.trace`), on a synthetic span log and counter set:
the hand-computed values, and nothing where there is nothing to read."""

import importlib.util
import types
from pathlib import Path

import pytest

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MS = 1_000_000          # ns


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _flow_log():
    """Two batches: uploads of 20 and 16 ms, downloads of 4 and 6 ms."""
    log = []
    for t, (up, down) in ((0, (20, 4)), (100, (16, 6))):
        t0 = t * MS
        log += [("flow/upload", "flow/batch", t0, t0 + up * MS),
                ("flow/solve", "flow/batch", t0 + up * MS, t0 + 30 * MS),
                ("flow/wait", "flow/batch", t0 + 30 * MS, t0 + 70 * MS),
                ("flow/download", "flow/batch", t0 + 70 * MS,
                 t0 + (70 + down) * MS),
                ("flow/batch", None, t0, t0 + (70 + down) * MS)]
    return log


def _fit_log():
    """Three chunks of one fit, then a second fit's start: boundaries of
    3 ms and 5 ms; the sync before the second fit pairs with nothing."""
    log, t = [("fit/start", None, 0, MS)], MS
    for gap in (3, 5, None):
        log += [("fit/replay", "fit/chunk", t, t + MS),
                ("fit/sync", "fit/chunk", t + MS, t + 40 * MS),
                ("fit/check", "fit/chunk", t + 40 * MS, t + 41 * MS),
                ("fit/log", "fit/chunk", t + 41 * MS, t + 42 * MS)]
        t += (40 + (gap or 10)) * MS
    log += [("fit/end", None, t, t + MS), ("fit/start", None, t + 2 * MS, t + 3 * MS),
            ("fit/replay", "fit/chunk", t + 4 * MS, t + 5 * MS)]
    return log


@pytest.mark.parametrize("name,want", [("upload_ms_per_batch.flow", 18.0),
                                       ("download_ms_per_batch.flow", 5.0)])
def test_flow_parts_per_batch(name, want):
    reader = _reader(name)
    assert reader.value(_flow_log()) == pytest.approx(want)
    assert reader.value([]) is None


def test_chunk_gap_pairs_a_sync_with_the_next_replay_of_its_fit():
    reader = _reader("chunk_gap_ms.fit")
    assert reader.value(_fit_log()) == pytest.approx(4.0)
    # the log in any order reads the same
    assert reader.value(_fit_log()[::-1]) == pytest.approx(4.0)
    assert reader.value([]) is None
    assert reader.value(_fit_log()[:5]) is None      # no whole boundary


def test_graph_setup_adds_warm_ups_and_captures():
    reader = _reader("graph_setup_s")
    assert reader.value({"graphs.warmup_s": 7.5, "graphs.capture_s": 1.25,
                         "graphs.state_made": 3}) == pytest.approx(8.75)
    assert reader.value({"graphs.capture_s": 0.5}) == pytest.approx(0.5)
    assert reader.value({}) is None
    assert reader.value({"graphs.state_made": 3}) is None


def test_fit_start_reads_its_counter_alone():
    reader = _reader("fit_start_s")
    assert reader.value({"fit.start_s": 11.5, "graphs.warmup_s": 0.5,
                         "graphs.state_made": 1}) == pytest.approx(11.5)
    assert reader.value({}) is None
    assert reader.value({"graphs.warmup_s": 0.5}) is None


@pytest.mark.parametrize("name", ["upload_ms_per_batch.flow",
                                  "download_ms_per_batch.flow",
                                  "chunk_gap_ms.fit", "graph_setup_s",
                                  "fit_start_s"])
def test_nothing_is_read_without_a_profiled_device_window(name):
    reader = _reader(name)
    for trace in (None, {"ops": []}):
        assert reader.read(types.SimpleNamespace(trace=trace)) is None
