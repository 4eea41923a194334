"""The port's `parallel/` on two gloo ranks on the CPU: each sharded path
against the unsharded port, the sharded fit's loss against the JAX
package's, and the entry points' `--mesh_devices` / `Deflickerer(mesh=)`.

Every multi-rank case runs in ranks that `deflicker_torch.parallel.launch`
spawns (two processes, a timeout each call); the rank bodies live in
`tests/parallel_ranks.py`.  Several checks share one spawn.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deflicker_tpu.atlas import data as jdata
from deflicker_tpu.atlas import engine as jeng
from deflicker_tpu.config import AtlasConfig as JAtlasConfig
from deflicker_tpu.parallel import assign_videos as jassign

from deflicker_torch.atlas import engine as teng
from deflicker_torch.atlas.data import VideoData
from deflicker_torch.config import AtlasConfig
from deflicker_torch.parallel import launch
from deflicker_torch.utils.checkpoint import to_host
from deflicker_torch.utils.convert import atlas_params_from_jax

from tests import parallel_ranks

torch.set_num_threads(2)

T, H, W = 4, 16, 20
B = 97                      # odd: the ranks hold 49 and 48 samples
TIMEOUT = 300
NARROW = dict(number_of_channels_atlas=32, number_of_layers_atlas=8,
              number_of_channels_mapping1=32, number_of_layers_mapping1=4,
              number_of_channels_mapping2=32, number_of_layers_mapping2=3,
              number_of_channels_alpha=32, number_of_layers_alpha=4,
              positional_encoding_num_atlas=6, samples_batch=B)
# (dual, include_global, include_bootstrap, fit_precision)
CASES = [(False, True, False, "highest"), (False, False, False, "default"),
         (True, True, True, "highest")]


def video_arrays(seed=0):
    """A clip with random flows, flow masks and a segmentation mask, so
    every loss term (masked means included) has something to sum."""
    rng = np.random.default_rng(seed)
    video = rng.uniform(0.1, 0.9, (T, H, W, 3)).astype(np.float32)
    dx, dy = np.zeros_like(video), np.zeros_like(video)
    dx[:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
    dy[:, :-1] = video[:, 1:] - video[:, :-1]
    mask = (rng.uniform(size=(T, H, W)) > 0.5).astype(np.float32)
    ffwd = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    fbwd = rng.normal(size=(T, H, W, 2)).astype(np.float32)
    mfwd = (rng.uniform(size=(T, H, W)) > 0.3).astype(np.float32)
    mbwd = (rng.uniform(size=(T, H, W)) > 0.3).astype(np.float32)
    mfwd[-1] = 0.0
    mbwd[0] = 0.0
    return video, dx, dy, mask, ffwd, fbwd, mfwd, mbwd


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(AtlasConfig(), **NARROW)
    data = VideoData(*video_arrays())
    host = {}
    for dual in (False, True):
        specs = teng.build_specs(cfg, dual=dual)
        p = teng.init_models(specs, torch.Generator().manual_seed(0))
        # the pretrained regime: a random mapping makes the rigidity
        # Jacobian near-singular and every comparison ill-conditioned
        for name in ("mapping1", "mapping2")[:1 + dual]:
            teng.pretrain_mapping(p[name], getattr(specs, name),
                                  torch.Generator().manual_seed(1), T, H, W,
                                  cfg.uv_mapping_scale, 30, 512)
        host[dual] = to_host(p)
    rng = np.random.default_rng(3)
    jif = (rng.integers(0, W, B), rng.integers(0, H, B), rng.integers(0, T, B))
    return cfg, data, host, jif


@pytest.fixture(scope="module")
def fit_out(setup):
    cfg, data, host, jif = setup
    return launch(parallel_ranks.fit, 2, "cpu",
                  (host, cfg, data, jif, CASES, 6), timeout=TIMEOUT)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", CASES, ids=["single", "single-default",
                                             "dual-bootstrap"])
def test_sharded_fit_gradient_matches_unsharded(fit_out, case):
    """Each rank's block of the batch with the global counts, one
    all-reduce: the flat gradient equals the unsharded one (relative
    Frobenius 1e-5), the summed terms the unsharded terms (rtol 1e-5), on
    both ranks alike."""
    for rank, out in enumerate(fit_out):
        o = out[case]
        total, aux, grad = o["ref"]
        assert o["rows"] == (49, 48)[rank]
        assert _rel(o["grad"], grad) < 1e-5
        np.testing.assert_allclose(o["total"], total, rtol=1e-5)
        assert set(o["aux"]) == set(aux)
        for k in aux:
            np.testing.assert_allclose(o["aux"][k], aux[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    np.testing.assert_array_equal(fit_out[0][case]["grad"],
                                  fit_out[1][case]["grad"])


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "highest"],
                         ids=["single", "dual-bootstrap"])
def test_sharded_fit_loss_matches_jax(setup, fit_out, case):
    """The world-2 loss (the ranks' partial terms summed) against the JAX
    package's `make_loss_fn` on the same samples and params at "highest":
    within rtol 1e-5.  The JAX mesh changes only the layout
    (tests/test_parallel.py), so this is also the JAX sharded loss."""
    cfg, data, host, (j, i, f) = setup
    dual, include_global, include_boot, precision = case
    cfg_j = dataclasses.replace(JAtlasConfig(), **NARROW,
                                fit_precision=precision)
    d_j = jdata.VideoData(*map(jnp.asarray, video_arrays())).with_packed()
    params = jax.tree_util.tree_map(jnp.asarray, host[dual])
    lf = jeng.make_loss_fn(jeng.build_specs(cfg_j, dual=dual), cfg_j, d_j,
                           include_global, include_boot)
    with jax.default_matmul_precision("highest"):
        tot, aux = lf(params, d_j, jnp.asarray(j), jnp.asarray(i),
                      jnp.asarray(f))
    o = fit_out[0][case]
    np.testing.assert_allclose(o["total"], float(tot), rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(o["aux"][k], float(aux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_short_sharded_fit_tracks_unsharded(fit_out):
    """Six steps of `fit_atlas` from the same generator, sharded over two
    ranks and unsharded: the per-step losses within rtol 1e-3, the two
    ranks' params bit-equal (one all-reduce feeds the same Adam)."""
    single, sharded = fit_out[0]["fit"]["single"], fit_out[0]["fit"]["sharded"]
    assert len(single[0]) == len(sharded[0]) == 6
    np.testing.assert_allclose(sharded[0], single[0], rtol=1e-3)
    np.testing.assert_array_equal(fit_out[1]["fit"]["sharded"][1], sharded[1])
    assert fit_out[1]["fit"]["sharded"][0] == sharded[0]


@pytest.fixture(scope="module")
def paths_out(setup):
    cfg, data, host, _ = setup
    rng = np.random.default_rng(5)
    frames = (rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8),
              rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8))
    pairs = (rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32),
             rng.uniform(0, 255, (3, 32, 32, 3)).astype(np.float32))
    datas_v = [VideoData(*video_arrays(s)) for s in (7, 8)]
    out = launch(parallel_ranks.paths, 2, "cpu",
                 (host[False], cfg, data, frames, pairs, datas_v),
                 timeout=TIMEOUT)
    return out, frames, pairs, datas_v


def test_split_helpers(paths_out):
    """Blocks of 7 items over 2 ranks are 4 + 3; the gather rebuilds them
    (also along axis 1, 3 + 2 columns), the broadcast and the object carry
    rank 0's values, the sum adds."""
    out, *_ = paths_out
    assert out[0]["block"] == [0.0, 1.0, 2.0, 3.0]
    assert out[1]["block"] == [14.0, 15.0, 16.0]
    for o in out:
        assert o["gathered"] == [0.0, 1.0, 2.0, 3.0, 14.0, 15.0, 16.0]
        assert o["gathered_axis1"] == [[0.0, 1.0, 2.0, 103.0, 104.0],
                                       [5.0, 6.0, 7.0, 108.0, 109.0]]
        assert o["replicated"] == list(np.arange(7.0))
        assert o["summed"] == [3.0, 3.0, 3.0]
        assert o["object"] == {"rank": 0}


def test_sharded_render_matches(setup, paths_out):
    """The frames split over the ranks (2 and 2, two frames a call): every
    rank's gathered video equals the unsharded render (atol 1e-5)."""
    from deflicker_torch.atlas.render import render_frames

    cfg, data, host, _ = setup
    out, *_ = paths_out
    ref = render_frames(atlas_params_from_jax(host[False]),
                        teng.build_specs(cfg), T, H, W)
    for o in out:
        np.testing.assert_allclose(o["render"], ref, atol=1e-5)


def test_sharded_raft_pairs_match(paths_out):
    """A batch of three pairs split 2 + 1 over the ranks: every pair's
    flow equals the unsharded batch's (rtol 1e-4 / atol 1e-4, as
    tests/test_parallel.py holds the JAX package's)."""
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.models import raft_init

    out, _, pairs, _ = paths_out
    flow = RAFTFlow(model=raft_init(torch.Generator().manual_seed(0)),
                    iters=2, dtype=torch.float32, device="cpu")
    ref = flow.compute_batch(*pairs)
    for o in out:
        assert o["raft"].shape == (3, 32, 32, 2)
        np.testing.assert_allclose(o["raft"], ref, rtol=1e-4, atol=1e-4)


def test_sharded_unet_batch_matches(paths_out):
    """Five frames split 3 + 2 over the ranks, batches of 2: the U-Net's
    output equals the unsharded span's (atol 1e-5)."""
    from deflicker_torch.filter.engine import FilterEngine
    from deflicker_torch.models import transformnet_init, unet_init
    from deflicker_torch.ops.pad import Padder

    out, (content, style), *_ = paths_out
    gen = torch.Generator().manual_seed(0)
    engine = FilterEngine(unet_init(gen), transformnet_init(gen),
                          device="cpu", batch=2)
    ref = engine._filter_all(content, style, Padder(40, 56, divisor=32,
                                                    mode="other")).numpy()
    for o in out:
        np.testing.assert_allclose(o["unet"], ref, rtol=1e-5, atol=1e-5)


def test_video_split_group_fit_matches_unsplit(setup, paths_out):
    """A V = 2 group over 2 ranks (one video each: inits, pretrain and fit
    samples drawn for the whole group, each rank's row kept) gives each
    video the unsplit group's params (atol 1e-6, the pretrain bound of
    tests/test_torch_multifit.py) and logs, on both ranks."""
    from deflicker_torch.atlas.multifit import fit_group

    cfg, *_ = setup
    out, _, _, datas_v = paths_out
    gcfg = dataclasses.replace(cfg, iters_num=4, steps_per_call=2,
                               evaluate_every=3, pretrain_iter_number=1,
                               samples_batch=64, stop_global_rigidity=1)
    gens = tuple(torch.Generator().manual_seed(s) for s in range(4))
    ref = fit_group(datas_v, teng.build_specs(cfg), gcfg, gens, "cpu")
    for o in out:
        assert len(o["group"]) == 2
        for (params, logs), r in zip(o["group"], ref["results"]):
            np.testing.assert_allclose(
                params, parallel_ranks._params_np(r.params), atol=1e-6)
            np.testing.assert_allclose(logs, [x["total"] for x in r.logs],
                                       rtol=1e-5)


def test_assign_videos_matches_jax():
    """The port's round-robin deal equals the JAX function's on the same
    lists, and refuses the same bad ids."""
    from deflicker_torch.parallel import assign_videos

    for n_videos in (0, 1, 5, 10):
        vids = [f"v{k}" for k in range(n_videos)]
        for nproc in (1, 2, 3, 4):
            for pid in range(nproc):
                assert assign_videos(vids, pid, nproc) == jassign(vids, pid,
                                                                  nproc)
    for pid, nproc in ((2, 2), (-1, 2)):
        with pytest.raises(ValueError):
            assign_videos(["a"], pid, nproc)


def _write_clip(folder, seed, n=3):
    import cv2

    folder.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    base = rng.uniform(40, 215, (48, 64, 3)).astype(np.float32)
    for t in range(n):
        f = np.clip(np.roll(base, t, axis=1) * (1.0 + 0.1 * (-1) ** t), 0, 255)
        cv2.imwrite(str(folder / f"{t:05d}.png"), f.astype(np.uint8))
    return folder


TINY = dict(iters_num=12, samples_batch=128, steps_per_call=6,
            evaluate_every=11, pretrain_iter_number=2,
            number_of_channels_atlas=32, number_of_layers_atlas=4,
            number_of_channels_mapping1=32, number_of_layers_mapping1=3,
            stop_global_rigidity=6, fit_precision="highest")


def test_entry_points_on_two_ranks(tmp_path):
    """`cli.main --mesh_devices 2` (two gloo ranks spawned by the CLI) and
    `cli.stage1 --mesh_devices 2` write the one-rank run's tree, each file
    once, with stage-1 PSNR within 0.1 dB of one rank's; then
    `Deflickerer(mesh=...)` on two ranks answers `serve_lines` (rank 0
    reads the lines and alone prints; both run each job)."""
    from deflicker_torch.cli import main as cli_main_fn
    from deflicker_torch.cli import stage1

    clip = _write_clip(tmp_path / "data" / "vid", 0)
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(dataclasses.asdict(
        dataclasses.replace(AtlasConfig(), **TINY))))
    weights = tmp_path / "missing"
    common = ["--video_frame_folder", str(clip), "--root",
              str(tmp_path / "data"), "--config", str(config), "--down", "2",
              "--ckpt_raft", str(weights / "r.pth"),
              "--ckpt_filter", str(weights / "f.pth"),
              "--ckpt_local", str(weights / "l.pth")]
    for n in (1, 2):
        assert cli_main_fn(common + ["--results_root",
                                     str(tmp_path / f"r{n}"),
                                     "--mesh_devices", str(n)],
                           device="cpu") == 0
    trees = [sorted(p.relative_to(tmp_path / f"r{n}").as_posix()
                    for p in (tmp_path / f"r{n}").rglob("*")
                    if "events.out" not in p.name)
             for n in (1, 2)]
    assert trees[0] == trees[1]
    psnrs = [float(next((tmp_path / f"r{n}" / "vid" / "stage_1").glob(
        "PSNR_*")).name[5:]) for n in (1, 2)]
    assert abs(psnrs[0] - psnrs[1]) <= 0.1
    assert len(list((tmp_path / "r2" / "vid" / "final" / "output")
                    .glob("*.png"))) == 3

    assert stage1.main(["--vid_name", "vid", "--root", str(tmp_path / "data"),
                        "--config", str(config), "--down", "2",
                        "--results_root", str(tmp_path / "s2"),
                        "--ckpt_raft", str(weights / "r.pth"),
                        "--mesh_devices", "2"], device="cpu") == 0
    assert len(list((tmp_path / "s2" / "vid" / "stage_1" / "output")
                    .glob("*.png"))) == 3

    lines = [json.dumps({"frame_folder": str(clip), "down": 2}), "",
             "not json", json.dumps({"frame_folder": str(clip), "nope": 1})]
    out = launch(parallel_ranks.serve, 2, "cpu",
                 (str(tmp_path), str(config), lines), timeout=TIMEOUT)
    assert out[1]["printed"] == ""
    res = [json.loads(x) for x in out[0]["printed"].splitlines()]
    assert [r["ok"] for r in res] == [True, False, False]
    assert out[0]["n"] == out[1]["n"] == 2
    assert out[0]["mesh"] == {"data": 2}
