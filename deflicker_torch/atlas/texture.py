"""Dual-atlas texture export + texture-space rendering.

The reference dual evaluator's atlas machinery
(src/models/stage_1/evaluate.py:24-202 + evaluate_model:203-602), as in the
JAX package's atlas/texture.py:

  * `get_mapping_area` — uv bounding box that the (masked, alpha-passing)
    video pixels map into (evaluate.py:142-189): the index space goes
    through the MLPs in fixed-size chunks on the params' device and only
    the min/max come back to the host;
  * `get_high_res_texture` — discretize the neural atlas into an RxR image
    (evaluate.py:87-126), one batched forward; optional text-pattern
    overlay for visualizing the mapping;
  * `render_from_texture` — reconstruct frames by bilinearly sampling the
    DISCRETIZED texture at mapped uv (evaluate.py:24-83 get_colors path) —
    what makes atlas-space video editing possible: edit the texture PNG,
    re-render the video;
  * `export_atlas_artifacts` — write the fg/bg texture PNGs and alpha maps
    the reference emits.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.imlp import imlp_apply
from ..ops.coords import normalize_xyt
from ..ops.sampling import bilinear_sample
from .data import VideoData
from ..utils.device import resolve_device
from .engine import AtlasSpecs, Params
from .render import param_device, render_frame


@torch.no_grad()
def get_mapping_area(params: Params, specs: AtlasSpecs, mask,
                     larger_dim: int, num_frames: int, uv_shift: float,
                     use_mapping2: bool = False, invert_alpha: bool = False,
                     alpha_thresh: float = -0.5, chunk: int = 1 << 17
                     ) -> Tuple[float, float, float, float, float]:
    """(maxx, minx, maxy, miny, edge_size) of the uv area covered by pixels
    with mask==1 and (raw tanh) alpha > alpha_thresh, after uv*0.5+uv_shift.
    mask: (T, H, W) array or tensor.  Mirrors evaluate.py:142-189 (thresholds
    on the RAW alpha output, not the squashed one).

    The MLPs see `chunk` points at a time, so peak device memory is
    O(chunk), never O(T*H*W); the running min/max stay on the device and
    come back once."""
    device = param_device(params)
    mask = torch.as_tensor(mask).to(device)
    T, H, W = mask.shape
    total = T * H * W
    flat_mask = mask.reshape(-1)
    mkey = "mapping2" if use_mapping2 else "mapping1"
    mspec = specs.mapping2 if use_mapping2 else specs.mapping1

    inf = torch.tensor(float("inf"), device=device)
    lo = torch.full((2,), float("inf"), device=device)
    hi = torch.full((2,), float("-inf"), device=device)
    count = torch.zeros((), dtype=torch.long, device=device)
    for start in range(0, total, chunk):
        idx = torch.arange(start, min(total, start + chunk), device=device)
        f = idx // (H * W)
        rem = idx % (H * W)
        xyt = normalize_xyt(rem % W, rem // W, f, larger_dim, num_frames)
        uv = imlp_apply(params[mkey], xyt, mspec)
        a = imlp_apply(params["alpha"], xyt, specs.alpha)[:, 0]
        if invert_alpha:
            a = -a
        sel = ((flat_mask[idx] > 0.5) & (a > alpha_thresh))[:, None]
        lo = torch.minimum(lo, torch.where(sel, uv, inf).amin(dim=0))
        hi = torch.maximum(hi, torch.where(sel, uv, -inf).amax(dim=0))
        count += sel.sum()

    if int(count) == 0:
        return 1.0, -1.0, 1.0, -1.0, 2.0
    lo = lo.cpu().numpy() * 0.5 + uv_shift
    hi = hi.cpu().numpy() * 0.5 + uv_shift
    minx = float(max(lo[0], -1.0))
    miny = float(max(lo[1], -1.0))
    maxx = float(min(hi[0], 1.0))
    maxy = float(min(hi[1], 1.0))
    edge = float(max(maxx - minx, maxy - miny))
    return maxx, minx, maxy, miny, edge


@torch.no_grad()
def get_high_res_texture(resolution: int, minx: float, maxx: float,
                         miny: float, maxy: float, atlas_params,
                         specs: AtlasSpecs,
                         add_text_pattern: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Discretize the neural atlas over [minx,maxx]x[miny,maxy] into an
    (R, R, 3) image in [0,1] (evaluate.py:87-126).  Returns
    (marked_texture, original_texture); the marked one carries the
    reference's text pattern for visualizing the mapping."""
    device = atlas_params[0]["w"].device
    xs = torch.linspace(minx, maxx, resolution, device=device)
    ys = torch.linspace(miny, maxy, resolution, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")   # row i = y value ys[i]
    uv = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    rgb = imlp_apply(atlas_params, uv, specs.atlas)
    tex = (0.5 * (rgb + 1.0)).reshape(resolution, resolution, 3
                                      ).cpu().numpy().astype(np.float32)
    orig = tex.copy()

    if add_text_pattern:
        import colorsys

        import cv2

        # modern OpenCV only draws on uint8
        canvas = (tex * 255.0).astype(np.uint8)
        for base in (0, 500):
            for ii in range(40, 500, 80):
                color = tuple(255.0 * c for c in
                              colorsys.hsv_to_rgb((ii - 40) / 500, 1.0, 1.0))
                cv2.putText(canvas, "abcdefghijlmnopqrstuvwxyz1234567890!@#$%^&*()-+=>",
                            (10, ii + base), cv2.FONT_HERSHEY_SIMPLEX, 1.2,
                            color, 2, cv2.LINE_AA)
                cv2.putText(canvas, "ABCDEFGHIJKLMNOPQRSTUVWXYZ?~;:<./\\|][{},",
                            (10, ii + 40 + base), cv2.FONT_HERSHEY_SIMPLEX,
                            1.1, color, 2, cv2.LINE_AA)
        tex = canvas.astype(np.float32) / 255.0
    return tex, orig


def render_from_texture(texture: np.ndarray, minx: float, maxx: float,
                        miny: float, maxy: float, uv, device=None
                        ) -> np.ndarray:
    """Sample the discretized texture at uv points (already shifted into the
    texture's quadrant): uv -> texture pixel coords -> bilinear
    (evaluate.py:63-83).  uv: (..., 2) array or tensor; returns (..., 3) on
    the host.  The sampling runs on `device`; left out, that is where a
    tensor `uv` lies, and for a host array the card (`resolve_device`, which
    raises without CUDA)."""
    if device is None:
        device = (uv.device if isinstance(uv, torch.Tensor)
                  else resolve_device())
    resolution = texture.shape[0]
    pixel_size = resolution / (maxx - minx)
    uv = torch.as_tensor(uv).float().to(device)
    coords = torch.stack([(uv[..., 0] - minx) * pixel_size,
                          (uv[..., 1] - miny) * pixel_size], dim=-1)
    tex = torch.as_tensor(np.asarray(texture), dtype=torch.float32).to(device)
    return bilinear_sample(tex, coords).cpu().numpy()


def export_atlas_artifacts(params: Params, specs: AtlasSpecs,
                           data: VideoData, results_folder: str | Path,
                           resolution: int = 1000,
                           texture_render_check: bool = True) -> Dict:
    """Write the dual-atlas artifact set: fg/bg texture PNGs (marked +
    original), per-frame alpha maps, and a texture-space reconstruction
    sanity value.  Requires specs.dual."""
    from ..io.media import write_image

    if not specs.dual:
        raise ValueError("texture export needs the dual-atlas models")
    results_folder = Path(results_folder)
    results_folder.mkdir(parents=True, exist_ok=True)
    device = param_device(params)
    T, (H, W) = data.num_frames, data.res
    L = data.larger_dim

    # fg area from mask, bg area from inverted alpha over the whole frame
    mask = torch.as_tensor(data.mask).to(device)
    fg_box = get_mapping_area(params, specs, mask, L, T, uv_shift=0.5)
    bg_box = get_mapping_area(params, specs, torch.ones_like(mask), L, T,
                              uv_shift=-0.5, use_mapping2=True,
                              invert_alpha=True)

    out: Dict = {"fg_box": fg_box, "bg_box": bg_box}
    for name, box in (("texture1", fg_box), ("texture2", bg_box)):
        maxx, minx, maxy, miny, _ = box
        marked, orig = get_high_res_texture(resolution, minx, maxx, miny,
                                            maxy, params["atlas"], specs,
                                            add_text_pattern=True)
        write_image(marked, results_folder / f"{name}_marked.png")
        write_image(orig, results_folder / f"{name}.png")
        out[name] = orig

    # alpha maps per frame
    alpha_dir = results_folder / "alpha"
    rf0 = None
    for f in range(T):
        rf = render_frame(params, specs, f, H, W, T)
        if f == 0:
            rf0 = rf
        a = rf["alpha"][..., 0].cpu().numpy()
        write_image(np.stack([a] * 3, axis=-1), alpha_dir / f"{f:05d}.png")

    if texture_render_check:
        # texture-space render of frame 0 (the editable-texture path)
        maxx, minx, maxy, miny, _ = fg_box
        tex_rgb = render_from_texture(out["texture1"], minx, maxx, miny,
                                      maxy, rf0["uv1"] * 0.5 + 0.5, device)
        out["texture_render_psnr_proxy"] = float(
            np.mean((tex_rgb - rf0["rgb"].cpu().numpy()) ** 2))
    return out
