"""Multi-host fan-out of the port (`parallel/multihost.py`, `cli.batch
--dcn`): the single-process semantics of the JAX package's TestMultihost,
and two real local processes running `cli.batch --dcn` against one
coordinator, as tests/test_dcn_smoke.py runs the JAX package's.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from deflicker_tpu.parallel import assign_videos as jassign

from deflicker_torch.config import AtlasConfig
from deflicker_torch.parallel import assign_videos, init_distributed
from deflicker_torch.parallel.mesh import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every variable init_distributed reads, cleared for the single-process cases
DIST_ENV = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
            "LOCAL_WORLD_SIZE")

CHILD = """
import sys
import torch
torch.set_num_threads(1)
from deflicker_torch.cli.batch import main
sys.exit(main(sys.argv[1:], device="cpu"))
"""


@pytest.fixture
def no_dist_env(monkeypatch):
    for name in DIST_ENV:
        monkeypatch.delenv(name, raising=False)


class TestMultihost:
    def test_assign_videos_partitions_like_jax(self):
        vids = [f"v{i}" for i in range(10)]
        shares = [assign_videos(vids, k, 4) for k in range(4)]
        assert sorted(sum(shares, [])) == sorted(vids)
        assert shares[0] == ["v0", "v4", "v8"] and shares[3] == ["v3", "v7"]
        assert shares == [jassign(vids, k, 4) for k in range(4)]
        with pytest.raises(ValueError):
            assign_videos(["a"], 2, 2)

    def test_init_distributed_single_process(self, no_dist_env):
        """Nothing configured: no process group, the identity grid."""
        import torch.distributed as dist

        assert init_distributed() == (0, 1)
        assert init_distributed(None, 1, 0) == (0, 1)
        assert not dist.is_initialized()

    def test_init_distributed_needs_an_address_and_an_id(self, no_dist_env,
                                                         monkeypatch):
        with pytest.raises(ValueError, match="coordinator"):
            init_distributed(None, 2, 0)
        monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "1")
        with pytest.raises(ValueError, match="process id"):
            init_distributed()
        with pytest.raises(ValueError, match="outside"):
            init_distributed(None, None, 5)

    def test_batch_cli_dcn_single_process(self, no_dist_env, monkeypatch,
                                          capsys):
        """--dcn with a one-process grid assigns every video, prints the
        hello line and runs the normal path (the pipeline mocked out)."""
        from deflicker_torch.cli import batch

        called = []

        def fake_pipeline(cfg, atlas_cfg, device=None, mesh=None, **kw):
            called.append((cfg.video_name, mesh))
            return {"num_frames": 1, "t_total": 0.0, "psnr": 0.0}

        monkeypatch.setattr("deflicker_torch.cli.pipeline.run_pipeline",
                            fake_pipeline)
        assert batch.main(["--videos", "x.mp4", "y.mp4", "--dcn",
                           "--num_processes", "1", "--process_id", "0"],
                          device="cpu") == 0
        assert called == [("x.mp4", None), ("y.mp4", None)]
        recs = [json.loads(line) for line in capsys.readouterr().out
                .splitlines() if line.startswith("{")]
        assert recs[0] == {"process": 0, "processes": 1, "videos_assigned": 2}


def _clips_and_config(tmp_path):
    """Two 3-frame 48x64 clips and a tiny atlas config on disk."""
    import cv2

    from deflicker_torch.io.media import frames_to_video

    rng = np.random.default_rng(0)
    videos = []
    for name in ("clip_a", "clip_b"):
        frames = tmp_path / (name + "_frames")
        frames.mkdir()
        base = rng.uniform(40, 215, (48, 64, 3)).astype(np.uint8)
        for t in range(3):
            f = np.clip(np.roll(base, t, axis=1).astype(np.float32)
                        * (1.0 + 0.1 * ((-1) ** t)), 0, 255)
            cv2.imwrite(str(frames / f"{t:05d}.png"), f.astype(np.uint8))
        mp4 = tmp_path / f"{name}.mp4"
        frames_to_video(frames, mp4, fps=10)
        videos.append(str(mp4))

    tiny = dataclasses.replace(
        AtlasConfig(), iters_num=12, samples_batch=128, steps_per_call=6,
        evaluate_every=11, pretrain_iter_number=2,
        number_of_channels_atlas=32, number_of_layers_atlas=4,
        number_of_channels_mapping1=32, number_of_layers_mapping1=3,
        stop_global_rigidity=6)
    cfg_json = tmp_path / "tiny_config.json"
    cfg_json.write_text(json.dumps(dataclasses.asdict(tiny)))
    return videos, cfg_json


def _batch_args(tmp_path, videos, cfg_json, pid):
    """cli.batch's arguments for host `pid` (its own data and results)."""
    return ["--dcn", "--videos", *videos,
            "--iters", "12", "--down", "2", "--fps", "10",
            "--config", str(cfg_json),
            "--root", str(tmp_path / f"p{pid}" / "data"),
            "--results_root", str(tmp_path / f"p{pid}" / "results"),
            "--ckpt_raft", str(tmp_path / "missing.pth"),
            "--ckpt_filter", "none_missing.pth",
            "--ckpt_local", "none_missing.pth"]


def _communicate(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _check_hosts(tmp_path, procs, outs):
    """Each host printed its hello line and its clip's record once, and
    wrote the full artifact set of its clip only."""
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        recs = [json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")]
        hello = next(r for r in recs if "videos_assigned" in r)
        assert hello == {"process": pid, "processes": 2,
                         "videos_assigned": 1}
        done = [r for r in recs if "psnr" in r and "video" in r]
        assert len(done) == 1 and done[0]["frames"] == 3

    for pid, mine, other in ((0, "clip_a", "clip_b"),
                             (1, "clip_b", "clip_a")):
        res = tmp_path / f"p{pid}" / "results"
        assert len(list((res / mine / "final" / "output").glob("*.png"))) == 3
        assert not (res / other).exists()


def test_two_process_dcn_batch(tmp_path):
    """Two local processes run `cli.batch --dcn --coordinator 127.0.0.1:<port>
    --num_processes 2 --process_id k` on the CPU: both meet, each takes one
    of two clips, and each writes the full artifact set of its clip only."""
    videos, cfg_json = _clips_and_config(tmp_path)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD,
         *_batch_args(tmp_path, videos, cfg_json, pid),
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(pid)],
        cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(2)]
    _check_hosts(tmp_path, procs, _communicate(procs, 300))


def test_torchrun_dcn_batch(tmp_path):
    """`torchrun --nnodes 2 --nproc_per_node 2 ... cli.batch --dcn` on the
    CPU: two local torchrun agents stand for two hosts of two ranks each.
    The ranks join through torchrun's store, each host (rank // 2) takes
    one of two clips, its two ranks share that clip's fit on one gloo
    group, and each host prints one hello line and writes its clip only."""
    videos, cfg_json = _clips_and_config(tmp_path)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in DIST_ENV}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2",
         "--node_rank", str(pid), "--nproc_per_node", "2",
         "--master_addr", "127.0.0.1", "--master_port", str(port),
         "--no_python", sys.executable, "-c", CHILD,
         *_batch_args(tmp_path, videos, cfg_json, pid)],
        cwd=REPO, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in range(2)]
    _check_hosts(tmp_path, procs, _communicate(procs, 300))
