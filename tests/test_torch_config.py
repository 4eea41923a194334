"""The port's config, CLI parsing and checkpoints against the JAX package's."""

import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from deflicker_tpu.config import AtlasConfig as JAtlasConfig
from deflicker_tpu.utils.checkpoint import load_checkpoint as jload

from deflicker_torch.config import AtlasConfig, load_atlas_config
from deflicker_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(2)


def test_atlas_config_defaults_and_reference_json_match_jax():
    """Every shared field has the JAX package's default, and the reference
    JSON dump is identical."""
    j, t = JAtlasConfig(), AtlasConfig()
    shared = {f.name for f in dataclasses.fields(t)}
    assert shared <= {f.name for f in dataclasses.fields(j)}
    for name in shared:
        assert getattr(t, name) == getattr(j, name), name
    assert t.to_reference_json() == j.to_reference_json()
    assert t.use_pallas_imlp and t.fit_precision == "default"


def test_load_atlas_config_ignores_unknown_keys(tmp_path):
    path = tmp_path / "config_flow_100.json"
    raw = dict(JAtlasConfig().to_reference_json(), iters_num=77,
               pallas_tile=1536, some_new_key=1)
    path.write_text(json.dumps(raw))
    cfg = load_atlas_config(path)
    assert cfg.iters_num == 77 and cfg.samples_batch == 10000


def test_cli_args_to_configs():
    from deflicker_torch.cli.main import args_to_configs, build_parser

    args = build_parser().parse_args(
        ["--video_name", "x.mp4", "--gpu", "3", "--iters", "500",
         "--fit_precision", "highest", "--stage2_precision", "float32"])
    cfg, acfg = args_to_configs(args)
    assert cfg.gpu == 3 and cfg.stage2_dtype == "float32"
    assert acfg.iters_num == 500 and acfg.evaluate_every == 499
    assert acfg.fit_precision == "highest"


def test_checkpoint_roundtrip_and_jax_reads_it(tmp_path):
    """The port's checkpoints hold plain numpy only: the JAX package's
    loader reads them, and tensors come back as owned copies."""
    w = torch.arange(6.0).reshape(2, 3).requires_grad_()
    path = save_checkpoint(tmp_path / "ck", {"params": {"m": [{"w": w}]},
                                             "iteration": 5})
    with torch.no_grad():
        w += 1.0                      # a later update does not show through
    for loaded in (load_checkpoint(path), jload(path)):
        np.testing.assert_array_equal(loaded["params"]["m"][0]["w"],
                                      np.arange(6.0).reshape(2, 3))
        assert loaded["iteration"] == 5


class _Foreign:
    pass


def test_checkpoint_loader_refuses_foreign_classes(tmp_path):
    """A pickle naming any class beyond numpy and builtins (as a JAX fit
    checkpoint's optax state does) is refused, not imported."""
    path = tmp_path / "foreign"
    path.write_bytes(pickle.dumps({"opt_state": _Foreign()}))
    with pytest.raises(pickle.UnpicklingError, match="only plain numpy"):
        load_checkpoint(path)
