"""Warm serving in the port (`api.Deflickerer`, `cli.serve`) against the JAX
package's, on tiny clips on the CPU: the job protocol, the spool
directory, and the warm state kept across jobs."""

import dataclasses
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained_weights"
TINY = dict(iters_num=20, samples_batch=128, steps_per_call=10,
            evaluate_every=19, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            stop_global_rigidity=10)
# keys of a job's result that only one package reports, and why
# "iterations": the fit steps the job ran, which the port's run_stage1
# reports (a resumed fit runs fewer than iters_num) and the JAX package's not
# "graphs", "flow": the job's growth of the port's CUDA graph counters and
# of its flow engine's pinned staging, which the JAX package has not
TORCH_ONLY = {"iterations", "graphs", "flow"}
JAX_ONLY = set()


def _write_clip(folder: Path, seed: int, T: int = 3):
    import cv2

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.float32)
    for t in range(T):
        f = np.clip(np.roll(base, t, axis=1) * (1.0 + 0.1 * ((-1) ** t)), 0, 255)
        cv2.imwrite(str(folder / f"{t:05d}.png"), f.astype(np.uint8))
    return folder


@pytest.fixture
def clips(tmp_path):
    root = tmp_path / "data" / "test"
    return tmp_path, [_write_clip(root / n, s) for s, n in
                      enumerate(("vid_a", "vid_b"))]


def torch_deflickerer(tmp, results="results"):
    from deflicker_torch.api import Deflickerer
    from deflicker_torch.config import AtlasConfig

    d = Deflickerer(ckpt_raft=str(tmp / "missing.pth"),
                    ckpt_filter=str(WEIGHTS / "neural_filter.ckpt"),
                    ckpt_local=str(WEIGHTS / "local_refinement_net.ckpt"),
                    root=str(tmp / "data" / "test"),
                    results_root=str(tmp / results), device="cpu")
    d.atlas_cfg = dataclasses.replace(AtlasConfig(), **TINY)
    return d


def jax_deflickerer(tmp, results="results_jax"):
    from deflicker_tpu.api import Deflickerer
    from deflicker_tpu.config import AtlasConfig

    d = Deflickerer(ckpt_raft=str(tmp / "missing.pth"),
                    ckpt_filter=str(WEIGHTS / "neural_filter.ckpt"),
                    ckpt_local=str(WEIGHTS / "local_refinement_net.ckpt"),
                    root=str(tmp / "data" / "test"),
                    results_root=str(tmp / results), mesh=None)
    d.atlas_cfg = dataclasses.replace(AtlasConfig(), **TINY)
    return d


def test_serve_lines_matches_jax(clips):
    """The same job lines through both packages' serve_lines: as many
    results, the same ok pattern, the same error strings for bad JSON and
    unknown keys, the same result keys, and stage-1 PSNR within the 0.3 dB
    band of test_torch_pipeline.py::test_stage1_fit_tracks_jax_from_same_init.
    Here each package draws its own init, so the jobs fit 200 steps after
    20 pretrain sweeps, where the result no longer depends on the init by
    more than the band (at 20 steps and 2 sweeps one seed's init alone
    moved the JAX result by more than it)."""
    from deflicker_torch.cli.serve import serve_lines
    from deflicker_tpu.cli.serve import serve_lines as jax_serve_lines

    tmp, (vid_a, vid_b) = clips
    jobs = [
        json.dumps({"frame_folder": str(vid_a), "down": 2, "iters": 200}),
        "",                                       # blank line: ignored
        "not json",                               # bad line: error result
        json.dumps({"frame_folder": str(vid_b), "down": 2, "iters": 200,
                    "seed": 5}),
        json.dumps({"frame_folder": str(vid_b), "nope": 1}),  # bad key
    ]
    outs = {}
    for name, make, serve in (("jax", jax_deflickerer, jax_serve_lines),
                              ("torch", torch_deflickerer, serve_lines)):
        buf = io.StringIO()
        d = make(tmp)
        d.atlas_cfg = dataclasses.replace(d.atlas_cfg, pretrain_iter_number=20)
        assert serve(d, jobs, out=buf) == 3
        outs[name] = [json.loads(line) for line in buf.getvalue().splitlines()]
    j, t = outs["jax"], outs["torch"]
    assert len(t) == len(j) == 4
    assert [r["ok"] for r in t] == [r["ok"] for r in j] == [True, False, True,
                                                            False]
    assert t[1]["error"] == j[1]["error"] and t[1]["error"].startswith("bad json")
    assert t[3]["error"] == j[3]["error"]
    assert "unknown job keys: ['nope']" in t[3]["error"]
    assert set(t[3]) == set(j[3])
    for rt, rj in ((t[0], j[0]), (t[2], j[2])):
        assert set(rt) - TORCH_ONLY == set(rj) - JAX_ONLY, (
            sorted(set(rt) ^ set(rj)))
        assert abs(rt["psnr"] - rj["psnr"]) < 0.3, (rt["psnr"], rj["psnr"])
        assert rt["flow"] == {}         # the CPU stages nothing
        for k in ("final_psnr", "final_ewarp", "input_ewarp"):
            assert np.isfinite(rt[k]), k
    for name in ("vid_a", "vid_b"):
        final = tmp / "results" / name / "final" / "output"
        assert len(sorted(final.glob("*.png"))) == 3


def test_a_result_line_carries_the_jobs_flow_and_graph_counts():
    """Each result line of `serve_lines` carries the job's growth of the
    `flow.*` counters beside the `graphs.*` ones, through a stand-in
    engine that counts as the card's would: a job whose frames outgrow the
    pinned staging, then one that reuses it."""
    from deflicker_torch.cli.serve import serve_lines
    from deflicker_torch.utils import trace

    class Warm:
        def process(self, frame_folder, seed=0):
            trace.count("graphs.state_made", seed)
            trace.count("graphs.state_loaded")
            trace.count("flow.staging_made", seed)
            return {"psnr": 30.0}

    buf = io.StringIO()
    jobs = [json.dumps({"frame_folder": "big", "seed": 3}),
            json.dumps({"frame_folder": "same", "seed": 0})]
    assert serve_lines(Warm(), jobs, out=buf) == 2
    first, again = (json.loads(line) for line in buf.getvalue().splitlines())
    assert first["flow"] == {"staging_made": 3}
    assert first["graphs"] == {"state_made": 3, "state_loaded": 1}
    assert again["flow"] == {} and again["graphs"] == {"state_loaded": 1}


def test_serve_watch_spool(clips):
    """The spool loop answers each `<name>.json` with `<name>.result.json`
    and renames the job to `<name>.done`; a failing job answers ok false."""
    from deflicker_torch.cli.serve import serve_watch

    tmp, (vid_a, _) = clips
    spool = tmp / "jobs"
    spool.mkdir()
    (spool / "001.json").write_text(
        json.dumps({"frame_folder": str(vid_a), "down": 2}))
    (spool / "002.json").write_text(json.dumps({"video": "missing.mp4"}))
    assert serve_watch(torch_deflickerer(tmp), spool, poll_s=0.01,
                       max_jobs=2) == 2
    r1 = json.loads((spool / "001.result.json").read_text())
    r2 = json.loads((spool / "002.result.json").read_text())
    assert r1["ok"] is True and r1["psnr"] > 0
    assert r2["ok"] is False and r2["job"] == {"video": "missing.mp4"}
    assert all(p.name.endswith(".result.json") for p in spool.glob("*.json"))
    assert (spool / "001.done").exists() and (spool / "002.done").exists()


def test_deflickerer_keeps_its_state_warm(clips, monkeypatch):
    """Two same-shape clips and one video twice through one Deflickerer: the
    same provider and engine objects serve every job, `load_filter_engine`
    and `make_flow_provider` run once, and a video whose frames are on disk
    is not decoded again."""
    import cv2

    import deflicker_torch.cli.pipeline as tpipe
    import deflicker_torch.filter as tfilter

    tmp, (vid_a, vid_b) = clips
    calls = {"engine": 0, "provider": 0, "decode": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tfilter, "load_filter_engine",
                        counted("engine", tfilter.load_filter_engine))
    monkeypatch.setattr(tpipe, "make_flow_provider",
                        counted("provider", tpipe.make_flow_provider))
    monkeypatch.setattr(tpipe, "video_to_frames",
                        counted("decode", tpipe.video_to_frames))
    video = tmp / "clip_c.mp4"
    writer = cv2.VideoWriter(str(video), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (64, 48))
    for t in range(3):
        writer.write(np.full((48, 64, 3), 60 + 40 * t, np.uint8))
    writer.release()

    d = torch_deflickerer(tmp)
    outs = [d.process(frame_folder=str(vid_a), down=2)]
    provider, engine = d._flow_provider, d._filter_engine
    assert provider is not None and engine is not None
    outs.append(d.process(frame_folder=str(vid_b), down=2, iters=12))
    outs += [d.process(video=str(video), down=2, seed=3) for _ in range(2)]
    assert d._flow_provider is provider and d._filter_engine is engine
    assert calls == {"engine": 1, "provider": 1, "decode": 1}
    assert [o["num_frames"] for o in outs] == [3, 3, 3, 3]
    assert [o["iterations"] for o in outs] == [20, 12, 20, 20]
    assert outs[2]["psnr"] == outs[3]["psnr"]     # same frames, same seed


def test_serve_main_stdin(clips, monkeypatch, capsys):
    """`serve.main` reads jobs from stdin up to --max_jobs, names its device
    in the ready line and answers one JSON line a job."""
    from deflicker_torch.cli import serve
    from deflicker_torch.config import AtlasConfig

    tmp, (vid_a, _) = clips
    config = tmp / "tiny.json"
    config.write_text(json.dumps(dataclasses.asdict(
        dataclasses.replace(AtlasConfig(), **TINY))))
    lines = [json.dumps({"frame_folder": str(vid_a), "down": 2}), "",
             json.dumps({"frame_folder": str(vid_a), "down": 2}),
             json.dumps({"frame_folder": str(vid_a), "down": 2})]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    serve.main(["--max_jobs", "2", "--config", str(config),
                "--root", str(tmp / "data" / "test"),
                "--results_root", str(tmp / "results"),
                "--ckpt_raft", str(tmp / "missing.pth"),
                "--ckpt_filter", str(WEIGHTS / "neural_filter.ckpt"),
                "--ckpt_local", str(WEIGHTS / "local_refinement_net.ckpt")],
               device="cpu")
    captured = capsys.readouterr()
    out = [json.loads(line) for line in captured.out.splitlines()
           if line.startswith("{")]
    assert out[0] == {"ok": True, "status": "ready", "device": "cpu",
                      "mesh": None}
    assert [r["ok"] for r in out[1:]] == [True, True]
    assert json.loads(captured.err.strip().splitlines()[-1])["jobs"] == 2
