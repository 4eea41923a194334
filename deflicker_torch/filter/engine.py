"""Stage-2 engine: neural filter (U-Net) + sequential local refinement.

The JAX package's filter engine (src/neural_filter_and_refinement.py:89-130
in the reference):

  * the U-Net filter is per-frame independent: frames go through it in
    batches;
  * the refinement recurrence O_t = P_t + TransformNet(P_t, O_{t-1}, P_t,
    P_{t-1}) runs span by span with the carry (O_{t-1}, P_{t-1}) threaded
    across spans on the device (`refine_span`);
  * frames are padded to /32 ('other' mode: width split, height all-bottom,
    replicate) and mapped back by EXACT CROP by default — as in the JAX
    package, a deliberate deviation from the reference, which resizes the
    padded frame; unpad='resize' keeps the reference quirk;
  * PNGs quantize by truncation, (clip(x, 0, 1) * 255).astype(uint8).

Public functions take NHWC frames, as the JAX package's do, and transpose
to NCHW for the modules.  `run` streams one video; `run_multi` streams
several same-resolution videos in lockstep (`refine_span_multi`), each
video's carry frozen at its own last frame.

On the card a refinement step is one CUDA graph (atlas/graphs.py), the
counterpart of a step of the JAX package's refinement scans: it reads
frame t of a static span buffer and the carry from static buffers, writes
O_t, and freezes a video's carry past its last real frame by comparing a
step counter that the graph advances with the span's `n_valid`, both on
the device.  One graph per (V, padded H, padded W, dtype) is kept for the
engine's life, replayed once a frame; the U-Net stays eager (a few large
batches a span).  `refine_span` and `refine_span_multi` are the eager
functions the captured step is held to.

With a mesh (parallel/mesh.py) every rank runs `run` / `run_multi` alike:
each span's U-Net frames split over the ranks and are gathered, the
refinement of one video runs on every rank (it is sequential), the
lockstep refinement of several videos splits their axis when it divides
by the ranks, and rank 0 alone writes.

Output contract (identical to the reference):
  results/<vid>/neural_filter/concat/%05d.png   (content | atlas | filtered)
  results/<vid>/neural_filter/output/%05d.png   (filtered P_t)
  results/<vid>/final/output/%05d.png           (refined O_t)
  + the three .mp4s next to each folder.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..io.media import frames_to_video, list_frames, read_image, write_image
from ..models.refine import TransformNet
from ..models.unet import UNet
from ..ops.pad import Padder
from ..parallel.mesh import (Mesh, barrier, batch_sharding, block, is_main,
                             shard_constraint)


def _to_u8(x: torch.Tensor) -> np.ndarray:
    """PNG quantization on the device, bit-identical to write_image's
    host conversion ((clip(x,0,1)*255).astype(uint8) — truncating)."""
    return (x.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


@torch.no_grad()
def filter_frames(unet: UNet, content: torch.Tensor, style: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """P = UNet(cat(content, atlas-frame)) on a batch of NHWC frames
    (neural_filter_and_refinement.py:97).  uint8 frames normalize to [0, 1]
    on the device.  `unet` must already be in `dtype`; the output is f32."""
    x = torch.cat([content, style], dim=-1)
    if x.dtype == torch.uint8:
        x = x.to(dtype) / torch.tensor(255.0, dtype=dtype, device=x.device)
    else:
        x = x.to(dtype)
    return _nhwc(unet(_nchw(x))).float()


@torch.no_grad()
def refine_span(tnet: TransformNet, carry: Tuple[torch.Tensor, torch.Tensor],
                preds: torch.Tensor, n_valid: int, dtype=torch.float32):
    """A span of the refinement recurrence (reference loop:
    src/neural_filter_and_refinement.py:99-109) with carry = (O_{t-1},
    P_{t-1}) threaded across calls.  Only the first `n_valid` frames of the
    span are real: the carry freezes at the last real frame, so padding
    never leaks into the recurrence.  preds: (S, H, W, 3).  Returns
    (new_carry, refined (S, H, W, 3))."""
    o_prev, p_prev = carry
    outs = []
    for t in range(preds.shape[0]):
        p_t = preds[t]
        inp = torch.cat([p_t, o_prev, p_t, p_prev], dim=-1)[None]
        resid = _nhwc(tnet(_nchw(inp.to(dtype))))[0].float()
        o_t = p_t + resid
        if t < n_valid:
            o_prev, p_prev = o_t, p_t
        outs.append(o_t)
    return (o_prev, p_prev), torch.stack(outs, dim=0)


def refine_sequence(tnet: TransformNet, preds: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """The whole recurrence: O_0 = P_0, O_t = P_t + TransformNet(cat(P_t,
    O_{t-1}, P_t, P_{t-1})) (neural_filter_and_refinement.py:99-109).
    preds: (T, H, W, 3) filtered frames.  Returns (T, H, W, 3) refined."""
    if preds.shape[0] == 1:
        return preds.clone()
    p0 = preds[0]
    _, rest = refine_span(tnet, (p0, p0), preds[1:], preds.shape[0] - 1, dtype)
    return torch.cat([p0[None], rest], dim=0)


@torch.no_grad()
def refine_span_multi(tnet: TransformNet,
                      carry: Tuple[torch.Tensor, torch.Tensor],
                      preds: torch.Tensor, n_valid, dtype=torch.float32):
    """A span of the refinement recurrence for V videos in lockstep (the JAX
    package's `refine_span_multi`): every step pushes V frames through
    TransformNet as one batch, with carry = (O_{t-1}, P_{t-1}) of shape
    (V, H, W, 3) threaded across calls.  `n_valid` (V ints) says how many
    frames of the span are real per video: a video's carry freezes at its
    last real frame, so padding never advances a shorter video's
    recurrence.  preds: (V, S, H, W, 3).  Returns (new_carry, refined
    (V, S, H, W, 3))."""
    o_prev, p_prev = carry
    n_valid = torch.as_tensor(n_valid, device=preds.device)
    outs = []
    for t in range(preds.shape[1]):
        p_t = preds[:, t]
        inp = torch.cat([p_t, o_prev, p_t, p_prev], dim=-1)
        o_t = p_t + _nhwc(tnet(_nchw(inp.to(dtype)))).float()
        keep = (t < n_valid)[:, None, None, None]
        o_prev = torch.where(keep, o_t, o_prev)
        p_prev = torch.where(keep, p_t, p_prev)
        outs.append(o_t)
    return (o_prev, p_prev), torch.stack(outs, dim=1)


def refine_sequence_multi(tnet: TransformNet, preds: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """The whole recurrence for V videos in lockstep (the JAX package's
    `refine_sequence_multi`): O_0 = P_0 for each video, then
    `refine_span_multi` over frames 1..T-1.  preds: (V, T, H, W, 3)
    filtered frames.  Returns (V, T, H, W, 3) refined."""
    V, T = preds.shape[:2]
    if T == 1:
        return preds.clone()
    p0 = preds[:, 0]
    _, rest = refine_span_multi(tnet, (p0, p0), preds[:, 1:], [T - 1] * V,
                                dtype)
    return torch.cat([p0[:, None], rest], dim=1)


class _Refiner:
    """A captured refinement step's static buffers for V videos of padded
    size Hp x Wp: the span of filtered frames (V, S, Hp, Wp, 3) it reads,
    the refined span it writes, the carry (O_{t-1}, P_{t-1}), the step
    counter t and the span's `n_valid` (V,), all on the device."""

    def __init__(self, tnet, V, S, Hp, Wp, dtype, device):
        from ..atlas.graphs import WARMUP_CALLS, CapturedStep

        span, out = (torch.empty((V, S, Hp, Wp, 3), device=device)
                     for _ in range(2))
        o_prev, p_prev = (torch.empty((V, Hp, Wp, 3), device=device)
                          for _ in range(2))
        t = torch.zeros((1,), dtype=torch.int64, device=device)
        n_valid = torch.zeros((V,), dtype=torch.int64, device=device)

        def step():
            # refine_span_multi's step, with frame t read on the device
            with torch.no_grad():
                p_t = span.index_select(1, t)[:, 0]
                inp = torch.cat([p_t, o_prev, p_t, p_prev], dim=-1)
                o_t = p_t + _nhwc(tnet(_nchw(inp.to(dtype)))).float()
                out.index_copy_(1, t, o_t[:, None])
                keep = (t < n_valid)[:, None, None, None]
                o_prev.copy_(torch.where(keep, o_t, o_prev))
                p_prev.copy_(torch.where(keep, p_t, p_prev))
                t.add_(1)

        self.span, self.out, self.t, self.n_valid = span, out, t, n_valid
        self.carry = (o_prev, p_prev)
        self.step = CapturedStep(step, WARMUP_CALLS)


class FilterEngine:
    """Stage 2 on `device` (see the module docstring).  On the card each
    refinement step is a CUDA graph (`graphs`, an `InferenceGraphs`);
    `capture=False` refines eagerly there (the comparison the card's tests
    and chip_smoke make).  `timer`, when set, is called with a part's name
    ("read_wait", "unet", "refine", "d2h", "write_wait", "encode") and
    returns the context manager that part of `run` runs in (chip_smoke's
    stage-2 profile)."""

    def __init__(self, unet: UNet, tnet: TransformNet, device="cuda",
                 dtype=torch.float32, batch: int = 16, span: int = 32,
                 unpad: str = "crop", mesh: Optional[Mesh] = None,
                 capture: Optional[bool] = None):
        from ..atlas.graphs import InferenceGraphs

        if unpad not in ("crop", "resize"):
            raise ValueError(f"unpad must be 'crop' or 'resize', got {unpad!r}")
        self.mesh = mesh
        self.device = torch.device(mesh.device if mesh is not None else device)
        self.dtype = dtype
        # stage2_dtype="bfloat16": weights and input in bf16, output f32
        self.unet = unet.to(device=self.device, dtype=dtype).eval()
        self.tnet = tnet.to(device=self.device, dtype=dtype).eval()
        self.batch = batch
        self.span = max(2, span)
        self.unpad = unpad
        self.graphs = InferenceGraphs(self.device, "refinement steps",
                                      capture)
        self.timer: Optional[Callable[[str], object]] = None

    def _part(self, name: str):
        return (self.timer(name) if self.timer is not None
                else contextlib.nullcontext())

    def refine(self, carry: Tuple[torch.Tensor, torch.Tensor],
               body: torch.Tensor, n_valid) -> Tuple[tuple, torch.Tensor]:
        """`refine_span_multi` on the engine's device: carry (V, Hp, Wp, 3)
        x2, body (V, n, Hp, Wp, 3) with n <= `span`, `n_valid` V ints.  On
        the card the step graph of this shape replays once a frame; the
        carry it returns is its static buffers (pass them back as the next
        span's carry)."""
        if not self.graphs.enabled:
            return refine_span_multi(self.tnet, carry, body, n_valid,
                                     self.dtype)
        V, n, Hp, Wp, _ = body.shape
        e = self.graphs.entry((V, Hp, Wp, self.dtype), lambda: _Refiner(
            self.tnet, V, self.span, Hp, Wp, self.dtype, self.device))
        for mine, theirs in zip(e.carry, carry):
            if mine is not theirs:
                mine.copy_(theirs)
        e.span[:, :n].copy_(body)
        e.n_valid.copy_(torch.as_tensor(n_valid, dtype=torch.int64))
        e.t.zero_()
        self.graphs.run(e.step, n)
        return e.carry, e.out[:, :n].clone()

    @staticmethod
    def _read_u8(path):
        from PIL import Image

        img = np.array(Image.open(str(path)))
        if img.ndim == 2:
            img = np.tile(img[:, :, None], (1, 1, 3))
        return np.ascontiguousarray(img[..., :3])

    @classmethod
    def _load_span(cls, content_names, style_names, s0, s1, H, W):
        """Frames [s0, s1) as uint8; style resized to the content's size
        like the reference (uint8 resize before normalizing)."""
        import cv2

        n = s1 - s0
        content = np.zeros((n, H, W, 3), np.uint8)
        style = np.zeros((n, H, W, 3), np.uint8)
        for t in range(n):
            content[t] = cls._read_u8(content_names[s0 + t])
            s = cls._read_u8(style_names[s0 + t])
            if s.shape[:2] != (H, W):
                s = cv2.resize(s, (W, H), interpolation=cv2.INTER_LINEAR)
            style[t] = s
        return content, style

    def _filter_all(self, content: np.ndarray, style: np.ndarray,
                    padder: Padder) -> torch.Tensor:
        """Batched U-Net filtering of a span -> (n, Hp, Wp, 3) f32 on the
        device (on a mesh, each rank filters its block of the frames)."""
        n = content.shape[0]
        content_p = padder.pad(batch_sharding(torch.from_numpy(content),
                                              self.mesh).to(self.device))
        style_p = padder.pad(batch_sharding(torch.from_numpy(style),
                                            self.mesh).to(self.device))
        preds = [filter_frames(self.unet, content_p[s0:s0 + self.batch],
                               style_p[s0:s0 + self.batch], self.dtype)
                 for s0 in range(0, content_p.shape[0], self.batch)]
        local = (torch.cat(preds, dim=0) if preds else torch.zeros(
            (0, *content_p.shape[1:3], 3), device=self.device))
        return shard_constraint(local, self.mesh, 0, n)

    def _write_span(self, s0, content, style, preds, refined, results_dir,
                    save_concat, size, padder):
        """PNG writes for one span (writer thread; host only).  Padded
        outputs map back by exact crop, or by the reference's resize."""
        import cv2

        W, H = size
        results_dir = Path(results_dir)
        concat_dir = results_dir / "neural_filter" / "concat"
        filter_dir = results_dir / "neural_filter" / "output"
        final_dir = results_dir / "final" / "output"
        if self.unpad == "crop":
            hp, wp = preds.shape[1:3]
            preds = preds[:, padder.top:hp - padder.bottom,
                          padder.left:wp - padder.right]
            refined = refined[:, padder.top:hp - padder.bottom,
                              padder.left:wp - padder.right]
        for t in range(preds.shape[0]):
            if self.unpad == "crop":
                p, o = preds[t], refined[t]
            else:
                p = cv2.resize(preds[t], (W, H), interpolation=cv2.INTER_LINEAR)
                o = cv2.resize(refined[t], (W, H),
                               interpolation=cv2.INTER_LINEAR)
            write_image(p, filter_dir / f"{s0 + t:05d}.png")
            write_image(o, final_dir / f"{s0 + t:05d}.png")
            if save_concat:
                write_image(np.concatenate([content[t], style[t], p], axis=1),
                            concat_dir / f"{s0 + t:05d}.png")

    def run(self, content_dir: str | Path, style_dir: str | Path,
            results_dir: str | Path, fps: int = 10, save_concat: bool = True,
            return_output: bool = True) -> Optional[np.ndarray]:
        """Stage 2 over a video's frames, streaming span by span: a reader
        thread decodes span k+1 and a writer thread encodes span k-1 while
        the device filters and refines span k.  Returns the refined
        (T, Hp, Wp, 3) frames when `return_output`."""
        from concurrent.futures import ThreadPoolExecutor

        content_names = list_frames(content_dir)
        style_names = list_frames(style_dir)
        if len(content_names) != len(style_names):
            raise ValueError(f"{len(content_names)} content vs "
                             f"{len(style_names)} style frames")
        T = len(content_names)
        H, W = read_image(content_names[0]).shape[:2]
        padder = Padder(H, W, divisor=32, mode="other")
        S = self.span
        results_dir = Path(results_dir)

        spans = [(s0, min(T, s0 + S)) for s0 in range(0, T, S)]
        reader = ThreadPoolExecutor(max_workers=1)
        writer = ThreadPoolExecutor(max_workers=1)
        pending = []
        outputs = [] if return_output else None
        try:
            nxt = reader.submit(self._load_span, content_names, style_names,
                                *spans[0], H, W)
            carry = None
            for k, (s0, s1) in enumerate(spans):
                with self._part("read_wait"):
                    content, style = nxt.result()
                if k + 1 < len(spans):
                    nxt = reader.submit(self._load_span, content_names,
                                        style_names, *spans[k + 1], H, W)
                with self._part("unet"):
                    preds = self._filter_all(content, style, padder)
                if carry is None:
                    # O_0 = P_0; the recurrence starts at frame 1 with carry
                    # (P_0, P_0) (neural_filter_and_refinement.py:99)
                    carry = (preds[:1], preds[:1])
                    body, offset = preds[1:], 1
                else:
                    body, offset = preds, 0
                nb = int(body.shape[0])
                if nb:
                    with self._part("refine"):
                        carry, refined = self.refine(carry, body[None], [nb])
                    refined = refined[0]
                else:
                    refined = body
                if offset:
                    refined = torch.cat([preds[:1], refined], dim=0)
                if is_main(self.mesh):
                    with self._part("d2h"):
                        preds_u8 = _to_u8(preds)
                        refined_u8 = _to_u8(refined)
                    with self._part("write_wait"):
                        while len(pending) > 2:   # ~2 spans in flight at most
                            pending.pop(0).result()
                    pending.append(writer.submit(
                        self._write_span, s0, content, style, preds_u8,
                        refined_u8, results_dir, save_concat, (W, H), padder))
                if return_output:
                    with self._part("d2h"):
                        outputs.append(refined.cpu().numpy())
            with self._part("write_wait"):
                for f in pending:
                    f.result()
        finally:
            reader.shutdown(wait=False)
            writer.shutdown(wait=True)

        if is_main(self.mesh):
            with self._part("encode"):
                self._write_videos(results_dir, save_concat, fps)
        barrier(self.mesh)
        return np.concatenate(outputs, axis=0) if return_output else None

    @staticmethod
    def _write_videos(results_dir: Path, save_concat: bool, fps: int) -> None:
        dirs = ([results_dir / "neural_filter" / "concat"] if save_concat
                else [])
        dirs += [results_dir / "neural_filter" / "output",
                 results_dir / "final" / "output"]
        for d in dirs:
            frames_to_video(d, d.parent / (d.name + ".mp4"), fps=fps)

    def run_multi(self, jobs, fps: int = 10, save_concat: bool = True,
                  return_output: bool = True) -> Optional[List[np.ndarray]]:
        """Stage 2 over several same-resolution videos, streaming in
        lockstep (the JAX package's `FilterEngine.run_multi`): the reader
        thread decodes span k+1 of every video, the device filters the V
        videos' span k as one batch of frames and refines it with
        `refine_span_multi`, and the writer thread encodes span k-1.

        jobs: [(content_dir, style_dir, results_dir)].  A video that has
        ended idles on its last frame, and its carry stays frozen, so it
        never changes another video's output.  Returns each video's refined
        (T_v, Hp, Wp, 3) frames when `return_output`."""
        from concurrent.futures import ThreadPoolExecutor

        import cv2

        metas = []
        for c, s, r in jobs:
            cn, sn = list_frames(c), list_frames(s)
            if len(cn) != len(sn):
                raise ValueError(f"{len(cn)} content vs {len(sn)} style "
                                 f"frames ({c})")
            metas.append((cn, sn, Path(r)))
        V = len(metas)
        Ts = [len(cn) for cn, _, _ in metas]
        shapes = {read_image(cn[0]).shape[:2] for cn, _, _ in metas}
        if len(shapes) != 1:
            raise ValueError(f"run_multi needs same-resolution videos, got "
                             f"{shapes} (group by shape first)")
        H, W = shapes.pop()
        padder = Padder(H, W, divisor=32, mode="other")
        S = self.span
        T_max = max(Ts)
        spans = [(s0, min(T_max, s0 + S)) for s0 in range(0, T_max, S)]
        # the refinement's video axis splits when it divides by the ranks
        vmesh = (self.mesh if self.mesh is not None and self.mesh.size > 1
                 and V % self.mesh.size == 0 else None)
        lo, hi = block(V, vmesh)

        def load_span(s0, s1):
            n = s1 - s0
            content = np.zeros((V, n, H, W, 3), np.uint8)
            style = np.zeros((V, n, H, W, 3), np.uint8)
            for v, (cn, sn, _) in enumerate(metas):
                for k in range(n):
                    t = min(s0 + k, Ts[v] - 1)     # ended: its last frame
                    content[v, k] = self._read_u8(cn[t])
                    si = self._read_u8(sn[t])
                    if si.shape[:2] != (H, W):
                        si = cv2.resize(si, (W, H),
                                        interpolation=cv2.INTER_LINEAR)
                    style[v, k] = si
            return content, style

        reader = ThreadPoolExecutor(max_workers=1)
        writer = ThreadPoolExecutor(max_workers=1)
        pending = []
        outputs = [[] for _ in range(V)] if return_output else None
        try:
            nxt = reader.submit(load_span, *spans[0])
            carry = None
            for k, (s0, s1) in enumerate(spans):
                content, style = nxt.result()
                if k + 1 < len(spans):
                    nxt = reader.submit(load_span, *spans[k + 1])
                n = s1 - s0
                flat = self._filter_all(content.reshape(V * n, H, W, 3),
                                        style.reshape(V * n, H, W, 3), padder)
                preds = flat.reshape(V, n, *flat.shape[1:])
                mine = preds[lo:hi]
                if carry is None:
                    carry = (mine[:, 0], mine[:, 0])     # O_0 = P_0 per video
                    body, offset = mine[:, 1:], 1
                else:
                    body, offset = mine, 0
                nb = int(body.shape[1])
                if nb:
                    # each video's real frames of this span's body
                    nv = np.clip(np.asarray(Ts[lo:hi]) - (s0 + offset), 0, nb)
                    carry, refined = self.refine(carry, body, nv)
                else:
                    refined = body
                refined = shard_constraint(refined, vmesh, 0, V)
                if offset:
                    refined = torch.cat([preds[:, :1], refined], dim=1)
                if return_output:
                    for v in range(V):
                        nreal = min(Ts[v], s1) - s0
                        if nreal > 0:
                            outputs[v].append(refined[v, :nreal].cpu().numpy())
                if not is_main(self.mesh):
                    continue
                preds_u8 = _to_u8(preds)
                refined_u8 = _to_u8(refined)
                while len(pending) > 2 * V:      # ~2 spans in flight at most
                    pending.pop(0).result()
                for v, (_, _, rdir) in enumerate(metas):
                    nreal = min(Ts[v], s1) - s0
                    if nreal <= 0:
                        continue                  # this video has ended
                    pending.append(writer.submit(
                        self._write_span, s0, content[v, :nreal],
                        style[v, :nreal], preds_u8[v, :nreal],
                        refined_u8[v, :nreal], rdir, save_concat, (W, H),
                        padder))
            for f in pending:
                f.result()
        finally:
            reader.shutdown(wait=False)
            writer.shutdown(wait=True)

        if is_main(self.mesh):
            for _, _, rdir in metas:
                self._write_videos(rdir, save_concat, fps)
        barrier(self.mesh)
        if not return_output:
            return None
        return [np.concatenate(o, axis=0) for o in outputs]


def _resolve_ckpt(path: Optional[str | Path]) -> Optional[Path]:
    """The checkpoint to load, in order: the given path; its `.ckpt`
    sibling; the repository's shipped weights of the same name
    (<repo>/pretrained_weights); else None."""
    if not path:
        return None
    path = Path(path)
    if path.exists():
        return path
    trained = path.with_suffix(".ckpt")
    if trained.exists():
        return trained
    shipped = (Path(__file__).resolve().parents[2] / "pretrained_weights"
               / trained.name)
    return shipped if shipped.exists() else None


def load_filter_engine(ckpt_filter: Optional[str | Path],
                       ckpt_local: Optional[str | Path], device="cuda",
                       dtype=torch.float32, batch: int = 16, seed: int = 2023,
                       unpad: str = "crop", mesh: Optional[Mesh] = None
                       ) -> FilterEngine:
    """A FilterEngine from the reference's `.pth` weights (filter/convert.py)
    or the shipped `.ckpt` files (pickled flax trees, converted by
    utils/convert.stage2_from_flax).  Missing weights fall back to seeded
    random init (smoke runs only).  With `mesh` the engine runs on its
    rank's device and shares the work with the other ranks."""
    from ..utils.convert import load_stage2_module

    fpath = _resolve_ckpt(ckpt_filter)
    lpath = _resolve_ckpt(ckpt_local)
    if fpath is None or lpath is None:
        print("[deflicker_torch] stage-2 checkpoint(s) missing "
              f"({ckpt_filter} / {ckpt_local}) — using RANDOM weights "
              "(smoke only)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        unet, tnet = UNet(6, 3, 32), TransformNet(32, 5, 12, 3)
    if fpath is not None:
        load_stage2_module(unet, fpath)
    if lpath is not None:
        load_stage2_module(tnet, lpath)
    return FilterEngine(unet, tnet, device=device, dtype=dtype, batch=batch,
                        unpad=unpad, mesh=mesh)
