"""Port vs JAX package: the foreground-mask providers of the dual-atlas
path.  Host code on both sides, so the same inputs must give the same
masks bit for bit; the heavyweight backends (carvekit, detectron2) are not
installed, so their adapters run with stand-in predictors."""

import numpy as np
import pytest

from deflicker_tpu.seg import providers as jseg

from deflicker_torch.seg import providers as tseg

COCO = ["person", "bicycle", "car", "dog"]


class _FakeTensor:
    def __init__(self, arr):
        self.arr = np.asarray(arr)

    def cpu(self):
        return self

    def numpy(self):
        return self.arr


class _FakeInstances:
    def __init__(self, masks, classes):
        self.pred_masks = _FakeTensor(masks)
        self.pred_classes = _FakeTensor(classes)


def _instances():
    rng = np.random.default_rng(0)
    masks = rng.uniform(size=(3, 6, 7)) > 0.5
    return masks, np.array([2, 3, 3])          # car, dog, dog


@pytest.mark.parametrize("class_name", ["anything", "dog", "car", "person"])
def test_select_instance_mask_matches_jax(class_name):
    """First instance for 'anything', first of the named class otherwise, a
    black mask when nothing qualifies — equal to the JAX package's choice."""
    masks, classes = _instances()
    got = tseg.select_instance_mask(masks, classes, COCO, class_name, (6, 7))
    want = jseg.select_instance_mask(masks, classes, COCO, class_name, (6, 7))
    assert got.dtype == np.float32 and got.shape == (6, 7)
    np.testing.assert_array_equal(got, want)
    first = {"anything": 0, "dog": 1, "car": 0}.get(class_name)
    if first is None:
        assert not got.any()
    else:
        np.testing.assert_array_equal(got, masks[first].astype(np.float32))
    empty = tseg.select_instance_mask(np.zeros((0, 6, 7), bool),
                                      np.zeros((0,), int), COCO, class_name, (6, 7))
    assert empty.shape == (6, 7) and not empty.any()


def test_maskrcnn_adapter_feeds_bgr_and_selects():
    """The detectron2 adapter hands the predictor BGR and applies the
    instance selection (a stand-in predictor: the real one needs a
    download)."""
    masks, classes = _instances()
    seen = []
    prov = tseg.MaskRCNNMasks.__new__(tseg.MaskRCNNMasks)
    prov.predictor = lambda bgr: (seen.append(bgr),
                                  {"instances": _FakeInstances(masks, classes)})[1]
    prov.classes, prov.class_name = COCO, "dog"
    rgb = np.zeros((6, 7, 3), np.uint8)
    rgb[..., 0] = 255                           # pure red in RGB
    out = prov.compute_mask(rgb)
    np.testing.assert_array_equal(out, masks[1].astype(np.float32))
    assert seen[0][..., 2].min() == 255 and seen[0][..., 0].max() == 0


def test_carvekit_adapter_thresholds_alpha():
    from PIL import Image

    alpha = np.zeros((4, 5), np.uint8)
    alpha[1:3, 1:4] = 200                       # > 0.5 after /255
    alpha[0, 0] = 100                           # < 0.5 -> background
    rgba = np.dstack([np.zeros((4, 5, 3), np.uint8), alpha])
    outs = []
    for mod in (tseg, jseg):
        prov = mod.CarvekitMasks.__new__(mod.CarvekitMasks)
        prov.interface = lambda imgs: [Image.fromarray(rgba, "RGBA")]
        outs.append(prov.compute_mask(np.zeros((4, 5, 3), np.uint8)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], (alpha > 127).astype(np.float32))


@pytest.mark.parametrize("class_name,provider,error", [
    ("portrait", None, "carvekit"), ("dog", None, "detectron2"),
    (None, "maskrcnn", "detectron2"), ("dog", "carvekit", "carvekit")])
def test_get_mask_provider_routes_like_jax(class_name, provider, error):
    """'portrait' -> carvekit, any other class -> Mask-RCNN, `provider`
    overrides; with the package absent each adapter raises the same clear
    ImportError as the JAX package's."""
    with pytest.raises(ImportError, match=error) as e_t:
        tseg.get_mask_provider(class_name, provider)
    with pytest.raises(ImportError, match=error) as e_j:
        jseg.get_mask_provider(class_name, provider)
    assert str(e_t.value) == str(e_j.value)


def test_get_mask_provider_grabcut_override():
    prov = tseg.get_mask_provider("portrait", "grabcut")
    assert isinstance(prov, tseg.GrabCutMasks)
    assert (prov.iters, prov.margin) == (3, 0.1)


def _two_frames():
    """Two 48x64 frames: a bright textured disc on a dark noisy ground."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:48, 0:64]
    frames = []
    for cx in (28, 34):
        img = rng.integers(10, 50, (48, 64, 3))
        disc = (yy - 24) ** 2 + (xx - cx) ** 2 < 12 ** 2
        img[disc] = rng.integers(180, 250, (int(disc.sum()), 3))
        frames.append(img.astype(np.uint8))
    return frames


def test_grabcut_matches_jax_and_finds_the_object():
    """cv2 GrabCut with the centered-rectangle prior on two small frames:
    the same cv2 call on the same pixels, so the masks are equal bit for
    bit; and it does segment the disc (most of it inside, the frame's
    margin outside)."""
    yy, xx = np.mgrid[0:48, 0:64]
    for rgb, cx in zip(_two_frames(), (28, 34)):
        got = tseg.GrabCutMasks().compute_mask(rgb)
        want = jseg.GrabCutMasks().compute_mask(rgb)
        assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 1.0}
        np.testing.assert_array_equal(got, want)
        disc = (yy - 24) ** 2 + (xx - cx) ** 2 < 10 ** 2
        assert got[disc].mean() > 0.9
        assert not got[:4].any() and not got[:, :6].any()


def test_preprocess_masks_contract_and_idempotence(tmp_path):
    """`<vid>_seg/%05d.png`, uint8 0/255, one file per frame, equal to the
    JAX package's files; a second run computes nothing and rewrites
    nothing; a missing file alone is recomputed."""
    from PIL import Image

    roots = {}
    for name, mod in (("torch", tseg), ("jax", jseg)):
        frames = tmp_path / name / "vid"
        frames.mkdir(parents=True)
        for t, rgb in enumerate(_two_frames()):
            Image.fromarray(rgb).save(frames / f"{t:05d}.png")
        out = mod.preprocess_masks(frames, mod.GrabCutMasks(), verbose=False)
        assert [p.name for p in out] == ["00000.png", "00001.png"]
        assert out[0].parent == tmp_path / name / "vid_seg"
        roots[name] = out
    for a, b in zip(roots["torch"], roots["jax"]):
        m = np.array(Image.open(a))
        assert m.dtype == np.uint8 and m.shape == (48, 64)
        assert set(np.unique(m)) <= {0, 255} and 0 < (m > 0).mean() < 1
        np.testing.assert_array_equal(m, np.array(Image.open(b)))

    calls = []

    class Counting:
        def compute_mask(self, rgb):
            calls.append(rgb.shape)
            return np.ones(rgb.shape[:2], np.float32)

    frames = tmp_path / "torch" / "vid"
    stamps = [p.stat().st_mtime_ns for p in roots["torch"]]
    tseg.preprocess_masks(frames, Counting(), verbose=False)
    assert calls == [] and stamps == [p.stat().st_mtime_ns for p in roots["torch"]]
    roots["torch"][1].unlink()
    tseg.preprocess_masks(frames, Counting(), verbose=False)
    assert calls == [(48, 64, 3)]
    assert np.array(Image.open(roots["torch"][1])).min() == 255
    assert tseg.PrecomputedMasks(frames.parent / "vid_seg").validate(2)
    assert not tseg.PrecomputedMasks(frames.parent / "vid_seg").validate(3)
