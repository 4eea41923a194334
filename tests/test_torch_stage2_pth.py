"""Port vs JAX package: the reference's `.pth` stage-2 weights.

The reference's own `neural_filter.pth` and `local_refinement_net.pth` are
not in the repository, so the `.pth` files here are written from the
shipped `.ckpt` in the reference's layout: the modules' state dicts under
DataParallel's `module.` keys, optionally inside `{"state_dict": ...}`, and
the TransformNet's file with its dead InstanceNorm running stats."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.cli import convert_weights as jcli
from deflicker_tpu.filter import convert as jconv
from deflicker_tpu.filter import engine as jeng

from deflicker_torch.cli import convert_weights as tcli
from deflicker_torch.filter import convert as tconv
from deflicker_torch.filter import engine as teng
from deflicker_torch.models.refine import TransformNet
from deflicker_torch.models.unet import UNet
from deflicker_torch.utils.convert import load_stage2_module

torch.set_num_threads(2)

WEIGHTS = Path(__file__).resolve().parents[1] / "pretrained_weights"
CKPT = {"filter": WEIGHTS / "neural_filter.ckpt",
        "local": WEIGHTS / "local_refinement_net.ckpt"}
MODULE = {"filter": UNet, "local": TransformNet}


def reference_state(kind: str, layout: str) -> dict:
    """The shipped weights of `kind` as the reference's checkpoint dict."""
    sd = load_stage2_module(MODULE[kind](), CKPT[kind]).state_dict()
    if layout == "plain":
        return dict(sd)
    wrapped = {f"module.{k}": v.clone() for k, v in sd.items()}
    if kind == "local":
        # InstanceNorm running stats the reference saves and never applies
        for k in [k for k in sd if k.endswith("conv2d.weight")][:3]:
            base = "module." + k[:-len("conv2d.weight")] + "norm_layer."
            n = sd[k].shape[0]
            wrapped[base + "running_mean"] = torch.zeros(n)
            wrapped[base + "running_var"] = torch.ones(n)
            wrapped[base + "num_batches_tracked"] = torch.tensor(0)
    return {"state_dict": wrapped} if layout == "state_dict" else wrapped


@pytest.fixture(scope="module")
def pth_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    files = {}
    for kind in CKPT:
        for layout in ("plain", "module", "state_dict"):
            path = d / f"{kind}-{layout}.pth"
            torch.save(reference_state(kind, layout), path)
            files[kind, layout] = path
    return files


@pytest.mark.parametrize("layout", ["plain", "module", "state_dict"])
@pytest.mark.parametrize("kind", ["filter", "local"])
def test_pth_loads_bit_equal_to_ckpt(pth_files, kind, layout):
    """Every layout of the reference's `.pth` loads (strict) into the port's
    module with a state dict bit-equal to the `.ckpt` load."""
    want = load_stage2_module(MODULE[kind](), CKPT[kind]).state_dict()
    got = load_stage2_module(MODULE[kind](),
                             pth_files[kind, layout]).state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", ["filter", "local"])
def test_both_packages_read_the_same_pth(pth_files, kind):
    """The JAX package's `load_stage2_checkpoint` and the port read the same
    `.pth` into the same flax tree, key for key and bit for bit, and that
    tree is the shipped `.ckpt`'s."""
    path = pth_files[kind, "state_dict"]
    want = jconv.load_stage2_checkpoint(path)
    got = tconv.variables_from_state_dict(tconv.read_stage2_pth(path))
    shipped = jconv.load_stage2_checkpoint(CKPT[kind])

    def leaves(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(leaves(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = np.asarray(v)
        return out

    lw, lg, ls = leaves(want), leaves(got), leaves(shipped)
    assert set(lg) == set(lw) == set(ls)
    for k in lw:
        assert lg[k].dtype == lw[k].dtype, k
        np.testing.assert_array_equal(lg[k], lw[k], err_msg=k)
        np.testing.assert_array_equal(lg[k], ls[k], err_msg=k)


def _frames(seed, n=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)


def test_filter_engine_from_pth_matches_jax(pth_files, tmp_path):
    """`load_filter_engine` on `.pth` paths (the reference's defaults) and the
    JAX package on the same files: the UNet filter within the 2e-4 of
    test_torch_stage2.py::test_filter_frames_matches_jax, the refinement
    span within that file's 2e-4 too (f32, conv summation order only)."""
    fpath, lpath = pth_files["filter", "module"], pth_files["local", "module"]
    engine = teng.load_filter_engine(fpath, lpath, device="cpu")
    fvars = jconv.load_stage2_checkpoint(fpath)
    lvars = jconv.load_stage2_checkpoint(lpath)

    content, style = _frames(0), _frames(1)
    want = np.asarray(jeng.filter_frames(fvars, jnp.asarray(content),
                                         jnp.asarray(style), dtype=jnp.float32))
    got = teng.filter_frames(engine.unet, torch.tensor(content),
                             torch.tensor(style), torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)

    preds, p0 = _frames(3, n=3), _frames(4, n=1)[0]
    _, out_j = jeng.refine_span(lvars, (jnp.asarray(p0), jnp.asarray(p0)),
                                jnp.asarray(preds), jnp.int32(3),
                                dtype=jnp.float32)
    _, out_t = teng.refine_span(engine.tnet, (torch.tensor(p0),
                                              torch.tensor(p0)),
                                torch.tensor(preds), 3, torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-4)

    # a `.pt` reads the same way; an existing `.pth` wins over its `.ckpt`
    pt = tmp_path / "neural_filter.pt"
    pt.write_bytes(fpath.read_bytes())
    unet = teng.load_filter_engine(pt, None, device="cpu").unet
    assert all(torch.equal(a, b) for a, b in zip(unet.state_dict().values(),
                                                 engine.unet.state_dict().values()))
    assert teng._resolve_ckpt(fpath) == fpath


@pytest.mark.parametrize("kind", ["filter", "local"])
def test_convert_weights_cli_matches_jax(pth_files, kind, tmp_path, capsys):
    """`convert_weights --kind filter|local` writes the JAX CLI's file: the
    same keys, bit-equal leaves of the same dtype."""
    src = str(pth_files[kind, "state_dict"])
    jcli.main(["--kind", kind, "--src", src, "--dst", str(tmp_path / "j.ckpt")])
    assert tcli.main(["--kind", kind, "--src", src,
                      "--dst", str(tmp_path / "t.ckpt")], device="cpu") == 0
    assert f"{kind}: " in capsys.readouterr().out
    with open(tmp_path / "j.ckpt", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "t.ckpt", "rb") as f:
        got = pickle.load(f)

    def check(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                check(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    check(got, want, "")
