"""Foreground-mask providers for the dual-atlas (segmentation) path.

The reference has two host-side mask preprocessors producing
`data/test/<vid>_seg/%05d.png` (uint8 0/255):
  * Carvekit portrait matting (`--class_name portrait`,
    src/preprocess_mask_portrait.py:16-52), and
  * Detectron2 Mask-RCNN COCO instances (any other class name,
    src/preprocess_mask_rcnn.py:18-58; first instance, or first instance of
    the named class; black mask if none).

Both depend on large external packages, so mask generation is a pluggable
host-side producer of the same `_seg` files, as in the JAX package:
  * `PrecomputedMasks` — consume `_seg` files that already exist (also how
    the stage-1 loader reads them back);
  * `CarvekitMasks` / `MaskRCNNMasks` — thin adapters that use the external
    packages when installed and raise a clear error otherwise;
  * `GrabCutMasks` — dependency-free cv2 GrabCut with a center prior, so the
    dual-atlas path runs end-to-end on a bare machine (quality below the
    learned segmenters; meant for smoke/bootstrap runs).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Protocol

import numpy as np

from ..io.media import list_frames


class MaskProvider(Protocol):
    def compute_mask(self, rgb: np.ndarray) -> np.ndarray:
        """uint8 RGB (H, W, 3) -> float mask (H, W) in {0, 1}."""
        ...


class PrecomputedMasks:
    """Masks already on disk under `<vid>_seg` — nothing to compute."""

    def __init__(self, seg_dir: str | Path):
        self.seg_dir = Path(seg_dir)

    def compute_mask(self, rgb: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise RuntimeError("PrecomputedMasks only validates existing files")

    def validate(self, num_frames: int) -> bool:
        return len(list_frames(self.seg_dir)) >= num_frames


class CarvekitMasks:
    """Portrait matting via carvekit (reference:
    src/preprocess_mask_portrait.py:24-33 — Tracer-B7, seg 640 / matting
    2048, trimap dilation 30 / erosion 5)."""

    def __init__(self):
        try:
            from carvekit.api.high import HiInterface  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                "carvekit is not installed; install image-background-remove-"
                "tool or use --mask_provider grabcut / precomputed "
                "_seg files") from e
        self.interface = HiInterface(
            object_type="object", batch_size_seg=5, batch_size_matting=1,
            seg_mask_size=640, matting_mask_size=2048,
            trimap_prob_threshold=231, trimap_dilation=30, trimap_erosion_iters=5)

    def compute_mask(self, rgb: np.ndarray) -> np.ndarray:
        from PIL import Image

        out = self.interface([Image.fromarray(rgb)])[0]
        alpha = np.array(out)[..., 3].astype(np.float32) / 255.0
        return (alpha > 0.5).astype(np.float32)


def select_instance_mask(masks: np.ndarray, classes: np.ndarray,
                         class_names: List[str], class_name: str,
                         hw) -> np.ndarray:
    """The reference's instance-selection semantics
    (src/preprocess_mask_rcnn.py:42-58): class 'anything' -> the first
    detected instance; otherwise the first instance whose COCO class name
    matches; an all-black mask when nothing qualifies."""
    if class_name != "anything":
        keep = [k for k, c in enumerate(classes)
                if class_names[c] == class_name]
    else:
        keep = list(range(len(classes)))
    if not keep:
        return np.zeros(hw, np.float32)
    return masks[keep[0]].astype(np.float32)


class MaskRCNNMasks:
    """COCO instance masks via detectron2 (reference:
    src/preprocess_mask_rcnn.py:18-58): threshold 0.5; first instance for
    class 'anything', else first instance whose COCO class matches; black
    mask when nothing is found."""

    def __init__(self, class_name: str = "anything"):
        try:
            from detectron2 import model_zoo  # noqa: F401, PLC0415
            from detectron2.config import get_cfg  # noqa: PLC0415
            from detectron2.engine import DefaultPredictor  # noqa: PLC0415
            from detectron2.data import MetadataCatalog  # noqa: PLC0415
        except ImportError as e:
            raise ImportError(
                "detectron2 is not installed; use --mask_provider grabcut or "
                "provide precomputed _seg files") from e
        cfg = get_cfg()
        cfg_file = "COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml"
        cfg.merge_from_file(model_zoo.get_config_file(cfg_file))
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.5
        cfg.MODEL.WEIGHTS = model_zoo.get_checkpoint_url(cfg_file)
        self.predictor = DefaultPredictor(cfg)
        self.classes = MetadataCatalog.get(
            cfg.DATASETS.TRAIN[0]).thing_classes
        self.class_name = class_name

    def compute_mask(self, rgb: np.ndarray) -> np.ndarray:
        out = self.predictor(rgb[..., ::-1])  # predictor expects BGR
        inst = out["instances"]
        masks = inst.pred_masks.cpu().numpy()
        classes = inst.pred_classes.cpu().numpy()
        return select_instance_mask(masks, classes, self.classes,
                                    self.class_name, rgb.shape[:2])


class GrabCutMasks:
    """Dependency-free fallback: cv2 GrabCut seeded with a centered
    rectangle prior (64% area).  Not in the reference."""

    def __init__(self, iters: int = 3, margin: float = 0.1):
        self.iters = iters
        self.margin = margin

    def compute_mask(self, rgb: np.ndarray) -> np.ndarray:
        import cv2

        h, w = rgb.shape[:2]
        my, mx = int(h * self.margin), int(w * self.margin)
        rect = (mx, my, w - 2 * mx, h - 2 * my)
        mask = np.zeros((h, w), np.uint8)
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        try:
            cv2.grabCut(rgb, mask, rect, bgd, fgd, self.iters,
                        cv2.GC_INIT_WITH_RECT)
        except cv2.error:
            mask[my:h - my, mx:w - mx] = cv2.GC_PR_FGD
        return np.isin(mask, (cv2.GC_FGD, cv2.GC_PR_FGD)).astype(np.float32)


def get_mask_provider(class_name: Optional[str],
                      provider: Optional[str] = None) -> MaskProvider:
    """Select a provider like the reference CLI does (test.py:31-40:
    'portrait' -> carvekit, anything else -> Mask-RCNN), with `provider`
    overriding ('carvekit' | 'maskrcnn' | 'grabcut')."""
    if provider == "grabcut":
        return GrabCutMasks()
    if provider == "carvekit" or (provider is None and class_name == "portrait"):
        return CarvekitMasks()
    return MaskRCNNMasks(class_name or "anything")


def preprocess_masks(frames_dir: str | Path, provider: MaskProvider,
                     verbose: bool = True) -> List[Path]:
    """Write `<vid>_seg/%05d.png` for every frame (idempotent per frame),
    the same filesystem contract as the reference preprocessors."""
    from PIL import Image

    frames_dir = Path(frames_dir)
    seg_dir = frames_dir.parent / f"{frames_dir.name}_seg"
    seg_dir.mkdir(parents=True, exist_ok=True)
    out = []
    for k, fp in enumerate(list_frames(frames_dir)):
        dst = seg_dir / f"{k:05d}.png"
        if not dst.exists():
            rgb = np.array(Image.open(fp).convert("RGB"))
            mask = provider.compute_mask(rgb)
            Image.fromarray((mask * 255).astype(np.uint8)).save(dst)
            if verbose:
                print(f"mask {fp.name}")
        out.append(dst)
    return out
