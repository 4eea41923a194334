"""Stage-2 training: the neural filter (UNet), then the local refinement
net (TransformNet), on procedural clips made on the device (train/synth.py).

The JAX package's `train/stage2_trainer.py`, with the same objectives:
  filter:  P = UNet(cat(flickered, atlas));  L1 to clean + grad_weight x
           the L1 of the image gradients (the atlas input is blurry, and
           the L1 alone lets the net lean on it);
  refiner: O_t = P_t + TransformNet(cat(P_t, O_{t-1}, P_t, P_{t-1})) from
           (P_0, P_0) with the UNet frozen;  L1 to clean + temporal_weight x
           |O_t - warp(O_{t-1}, flow_t)| on Clip.valid pixels, the warp
           differentiated through O_{t-1}.

Adam (betas 0.9 / 0.999, eps 1e-8: optax.adam's update, m_hat / (sqrt(v_hat)
+ eps); on the card the fused capturable one) at a constant LR or optax's
warmup-cosine schedule, evaluated at the 0-based step count before each
update.  `dtype="bfloat16"` runs the convs under `torch.autocast(bfloat16)`
from f32 master params, as flax's `dtype=bf16` computes its convs; the
losses are taken in f32.  Steps run in chunks of `steps_per_call`: the
losses accumulate on the device and are read back once a chunk.  Each
step's clips come from a device generator; the per-step coin (image bank or
Fourier clips) and the bank indices come from a CPU generator, so no step
reads the device.

A step is a function over fixed tensors (`make_train_step`), one a clip
kind, the counterpart of the JAX package's scanned `_filter_chunk` and
`_refiner_chunk`: on the card each is captured as a CUDA graph after two
eager warm-up steps (atlas/graphs.py), and the host's part of a step is
the coin, the bank indices' copy, the LR's fill and one replay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..atlas.engine import _adam
from ..atlas.graphs import CapturedStep, FitGraphs, GraphState
from ..filter.engine import _nchw, _nhwc
from ..models.refine import TransformNet, transformnet_init
from ..models.unet import UNet, unet_init
from ..ops.sampling import flow_warp
from .synth import Clip, build_clips, draw_clips


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    height: int = 128
    width: int = 128
    filter_steps: int = 4000
    refine_steps: int = 1500
    batch: int = 8               # frames per UNet step
    clip_len: int = 6            # refiner clip length
    clip_batch: int = 2          # refiner clips per step
    learning_rate: float = 2e-4
    lr_schedule: str = "constant"  # "constant" | "cosine" (warmup + decay)
    grad_weight: float = 0.5     # filter gradient-L1 weight
    temporal_weight: float = 2.0  # refiner warp-loss weight
    # the defaults are the shipped weights' recipe (affine/iid clips)
    texture_mix: float = 0.5     # P(image-bank clips) a step, given a bank
    p_layer: float = 0.0         # P(foreground layer) a clip
    corr_flicker: bool = False   # AR(1) flicker series (False: iid)
    dtype: str = "bfloat16"      # conv compute dtype (params stay f32)
    steps_per_call: int = 50
    seed: int = 0


LogCallback = Callable[[str, int, Dict[str, float]], None]


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """The LR at a 0-based step.  "cosine" is optax's
    warmup_cosine_decay_schedule(lr / 10, lr, max(1, int(0.03 total)),
    total, lr / 20): a linear warmup, then cosine decay to lr / 20."""
    lr = cfg.learning_rate
    if cfg.lr_schedule == "constant":
        return lambda step: lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    warmup = max(1, int(0.03 * total_steps))
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"cosine schedule needs more than {warmup} steps, "
                         f"got {total_steps}")
    init, end = lr / 10, lr / 20
    alpha = 0.0 if lr == 0.0 else end / lr

    def sched(step: int) -> float:
        if step < warmup:
            return (init - lr) * (1.0 - step / warmup) + lr
        c = min(step - warmup, decay)
        return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay))
                     + alpha)

    return sched


def _make_optimizer(net: torch.nn.Module, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the net's params: the fit's (`atlas.engine._adam`), fused
    and capturable on the card."""
    return _adam(net.parameters(), cfg.learning_rate)


def _autocast(cfg: TrainConfig, device: torch.device):
    return torch.autocast(device.type, dtype=torch.bfloat16,
                          enabled=cfg.dtype == "bfloat16")


def _l1(a, b):
    return torch.mean(torch.abs(a - b))


def _grad_l1(a, b):
    """L1 of the image gradients of NHWC a and b: along W (axis 2), H (1)."""
    dxa, dxb = a[:, :, 1:] - a[:, :, :-1], b[:, :, 1:] - b[:, :, :-1]
    dya, dyb = a[:, 1:] - a[:, :-1], b[:, 1:] - b[:, :-1]
    return _l1(dxa, dxb) + _l1(dya, dyb)


def _filter_loss(unet: UNet, clips: Clip, cfg: TrainConfig):
    """The filter objective on the first frame of B clips."""
    inp, atlas, clean = clips.inp[:, 0], clips.atlas[:, 0], clips.clean[:, 0]
    x = torch.cat([inp, atlas], dim=-1)
    with _autocast(cfg, x.device):
        pred = unet(_nchw(x))
    pred = _nhwc(pred.float())
    rec = _l1(pred, clean)
    grad = _grad_l1(pred, clean)
    return rec + cfg.grad_weight * grad, {"rec": rec, "grad": grad}


def _refiner_loss(tnet: TransformNet, unet: UNet, clips: Clip,
                  cfg: TrainConfig):
    """The refiner objective through the inference recurrence, the UNet
    frozen (no gradient reaches it, as stop_gradient in the JAX trainer)."""
    B, T, H, W, _ = clips.inp.shape
    x = torch.cat([clips.inp, clips.atlas], dim=-1).reshape(B * T, H, W, 6)
    with torch.no_grad(), _autocast(cfg, x.device):
        P = unet(_nchw(x))
    P = _nhwc(P.float()).reshape(B, T, H, W, 3)
    o_prev = p_prev = P[:, 0]
    recs, temps = [], []
    for t in range(1, T):
        p_t = P[:, t]
        inp = torch.cat([p_t, o_prev, p_t, p_prev], dim=-1)
        with _autocast(cfg, x.device):
            resid = tnet(_nchw(inp))
        o_t = p_t + _nhwc(resid.float())
        recs.append(_l1(o_t, clips.clean[:, t]))
        warped = torch.vmap(flow_warp)(o_prev, clips.flow_bw[:, t])
        # Clip.valid: in bounds and free of occlusions and mask edges
        valid = clips.valid[:, t]
        temps.append(torch.sum(torch.abs(o_t - warped) * valid)
                     / (torch.sum(valid) * 3.0 + 1e-8))
        o_prev, p_prev = o_t, p_t
    rec, temp = torch.stack(recs).mean(), torch.stack(temps).mean()
    return rec + cfg.temporal_weight * temp, {"rec": rec, "temp": temp}


def _step(opt: torch.optim.Optimizer, lr, loss_fn) -> Dict[str, torch.Tensor]:
    """One Adam update at `lr` (a float, or the device tensor a training
    run fills before each step); the losses stay on the device."""
    opt.zero_grad(set_to_none=True)
    total, aux = loss_fn()
    total.backward()
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    return {"total": total.detach(), **{k: v.detach() for k, v in aux.items()}}


def _seeds(seed: int, n: int) -> List[int]:
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


class _ClipSource:
    """Each step's B clips of T frames: from the image bank with
    probability `cfg.texture_mix` (all of one step's clips one kind), else
    Fourier clips; drawn on the device from `seed`'s data stream, the coin
    and the bank indices from its CPU stream.  `next_kind` draws the coin
    on the host, `draw` makes the clips of a kind on the device."""

    def __init__(self, cfg: TrainConfig, bank: Optional[torch.Tensor],
                 seed: int, device: torch.device, B: int, T: int):
        data_seed, pick_seed = _seeds(seed, 2)
        self.cfg, self.bank, self.B, self.T = cfg, bank, B, T
        self.gen = torch.Generator(device).manual_seed(data_seed)
        self.pick = torch.Generator().manual_seed(pick_seed)
        # the bank indices of an image step, at a fixed address
        self.idx = (None if bank is None
                    else torch.zeros(B, dtype=torch.int64, device=device))

    def next_kind(self) -> bool:
        """Whether the next step takes image clips: its coin, then for an
        image step its bank indices, copied into `idx` (on the card from
        pinned memory, without waiting for the device)."""
        coin = float(torch.rand((), generator=self.pick))
        if self.bank is None or coin >= self.cfg.texture_mix:
            return False
        idx = torch.randint(0, self.bank.shape[0], (self.B,),
                            generator=self.pick)
        if self.idx.is_cuda:
            idx = idx.pin_memory()
        self.idx.copy_(idx, non_blocking=True)
        return True

    @torch.no_grad()
    def draw(self, image: bool) -> Clip:
        cfg = self.cfg
        textures = self.bank.index_select(0, self.idx) if image else None
        d = draw_clips(self.gen, self.B, self.T, cfg.height, cfg.width,
                       image=image, p_layer=cfg.p_layer,
                       corr_flicker=cfg.corr_flicker)
        return build_clips(d, cfg.height, cfg.width, textures=textures)


def make_train_step(opt: torch.optim.Optimizer, lr: torch.Tensor,
                    loss_fn: Callable, clips: _ClipSource, image: bool,
                    sums: Dict[str, object]) -> Callable[[], None]:
    """One training step of one clip kind over fixed tensors, a step of the
    JAX package's scanned chunks: draw the clips (`clips.draw(image)`), run
    `loss_fn(clips)` (autocast entered inside it), its backward and Adam at
    `lr` (a device tensor), and add `total` and the aux terms into the
    chunk sums in place: `sums` holds "keys", the terms in order, and
    "vals", their sums (made at a run's first step, shared by both kinds'
    steps, zeroed by `_run` at each chunk's start)."""

    def step():
        batch = clips.draw(image)
        terms = _step(opt, lr, lambda: loss_fn(batch))
        if not sums:
            sums["keys"] = list(terms)
            sums["vals"] = torch.zeros(len(terms), device=lr.device)
        sums["vals"].add_(torch.stack(list(terms.values())))

    return step


def _run(step_fn: Callable[[int], None], sums: Dict[str, object],
         total_steps: int, per_call: int, name: str,
         log_callback: Optional[LogCallback], dtype: str) -> List[Dict]:
    """`total_steps` calls of step_fn(step) in chunks of `per_call`, each
    adding its terms into `sums` (`make_train_step`); each chunk's mean
    losses are read back once and must be finite.  In f32, cuDNN takes
    deterministic algorithms here (captures included): its choices
    otherwise made two runs of one seed differ (its bf16 ones do not)."""
    logs = []
    done = 0
    cudnn = torch.backends.cudnn
    deterministic = cudnn.deterministic
    cudnn.deterministic = deterministic or dtype == "float32"
    try:
        while done < total_steps:
            n = min(per_call, total_steps - done)
            if sums:
                sums["vals"].zero_()
            for k in range(done, done + n):
                step_fn(k)
            done += n
            means = (sums["vals"] / n).tolist()
            rec = dict(zip(sums["keys"], means))
            if not all(np.isfinite(v) for v in means):
                raise FloatingPointError(
                    f"non-finite {name} loss at step {done}: {rec}")
            logs.append({"step": done, **rec})
            if log_callback is not None:
                log_callback(name, done, rec)
    finally:
        cudnn.deterministic = deterministic
    return logs


def _train(net: torch.nn.Module, loss_fn: Callable, cfg: TrainConfig,
           clips: _ClipSource, total_steps: int, name: str,
           log_callback: Optional[LogCallback],
           graphs: Optional[FitGraphs]) -> List[Dict]:
    """`total_steps` Adam steps of `net` on `loss_fn(clips)`.  The run's
    state lies at fixed addresses: the net's params, its Adam, the LR (a
    0-d device tensor the host fills with the schedule's value before each
    step), the clip source (its device generator, the bank indices) and
    the chunk sums.  Each clip kind has one step function
    (`make_train_step`); on the card each is captured after its own two
    eager warm-up steps, in one memory pool drawing from the one generator,
    and replayed in the coin's order; else it runs eagerly and the run
    says why on one line.  `graphs`: a `FitGraphs` (one with `eager=True`
    captures nothing); None, this run's own.  Nothing outlives the run."""
    device = clips.gen.device
    opt = _make_optimizer(net, cfg)
    lr = torch.zeros((), device=device)
    sched = lr_schedule(cfg, total_steps)
    graphs = graphs or FitGraphs()
    capture = graphs.capturing(device, f"{name} training")
    state = GraphState(device, clips.gen)
    sums: Dict[str, object] = {}
    steps = {image: CapturedStep(make_train_step(opt, lr, loss_fn, clips,
                                                 image, sums))
             for image in (False, True)}

    def step(k):
        image = clips.next_kind()
        lr.fill_(sched(k))
        steps[image].run(graphs if capture else None, state, 1)

    return _run(step, sums, total_steps, cfg.steps_per_call, name,
                log_callback, cfg.dtype)


def _prep_bank(cfg: TrainConfig, texture_bank, device):
    """(bank on the device or None, effective cfg): with no bank every
    step takes Fourier clips (texture_mix 0)."""
    if texture_bank is None:
        return None, dataclasses.replace(cfg, texture_mix=0.0)
    return torch.as_tensor(np.asarray(texture_bank, np.float32),
                           device=device), cfg


def train_filter(cfg: TrainConfig, seed: int,
                 log_callback: Optional[LogCallback] = None,
                 texture_bank=None, device=None,
                 graphs: Optional[FitGraphs] = None) -> Tuple[UNet, List[Dict]]:
    """Train the UNet neural filter; returns (unet, logs).  `texture_bank`:
    an optional (N, th, tw, 3) f32 image bank (synth.load_texture_bank).
    `graphs`: as in `_train` (on the card, one CUDA graph a clip kind)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    bank, cfg = _prep_bank(cfg, texture_bank, device)
    init_seed, data_seed = _seeds(seed, 2)
    unet = unet_init(torch.Generator().manual_seed(init_seed)).to(device)
    clips = _ClipSource(cfg, bank, data_seed, device, cfg.batch, 1)
    logs = _train(unet, lambda batch: _filter_loss(unet, batch, cfg), cfg,
                  clips, cfg.filter_steps, "filter", log_callback, graphs)
    return unet, logs


def train_refiner(cfg: TrainConfig, seed: int, unet: UNet,
                  log_callback: Optional[LogCallback] = None,
                  texture_bank=None, device=None,
                  graphs: Optional[FitGraphs] = None
                  ) -> Tuple[TransformNet, List[Dict]]:
    """Train the refinement net through the inference recurrence (the UNet
    frozen); returns (tnet, logs).  `graphs`: as in `train_filter`."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    bank, cfg = _prep_bank(cfg, texture_bank, device)
    init_seed, data_seed = _seeds(seed, 2)
    tnet = transformnet_init(torch.Generator().manual_seed(init_seed)).to(device)
    unet = unet.to(device)
    clips = _ClipSource(cfg, bank, data_seed, device, cfg.clip_batch,
                        cfg.clip_len)
    logs = _train(tnet, lambda batch: _refiner_loss(tnet, unet, batch, cfg),
                  cfg, clips, cfg.refine_steps, "refiner", log_callback,
                  graphs)
    return tnet, logs


def train_stage2(cfg: TrainConfig, out_dir,
                 log_callback: Optional[LogCallback] = None,
                 texture_bank=None, device=None):
    """Train both networks and save checkpoints `load_filter_engine` reads
    (in either package): `neural_filter.ckpt` and
    `local_refinement_net.ckpt`, the flax-layout {"params": ...} numpy tree
    of the shipped weights; plus `scalars.jsonl` (one line a chunk) and
    `train_config.json`.  Returns the two checkpoint paths."""
    import json
    from pathlib import Path

    from ..filter.convert import variables_from_state_dict
    from ..utils.checkpoint import save_checkpoint
    from ..utils.device import resolve_device

    device = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    f_seed, r_seed = _seeds(cfg.seed, 2)

    with open(out_dir / "scalars.jsonl", "a") as scalars:
        def log(name, step, rec):
            scalars.write(json.dumps({"net": name, "step": step, **rec}) + "\n")
            scalars.flush()
            if log_callback is not None:
                log_callback(name, step, rec)

        unet, _ = train_filter(cfg, f_seed, log, texture_bank, device)
        fpath = save_checkpoint(out_dir / "neural_filter.ckpt",
                                variables_from_state_dict(unet.state_dict()))
        tnet, _ = train_refiner(cfg, r_seed, unet, log, texture_bank, device)
        lpath = save_checkpoint(out_dir / "local_refinement_net.ckpt",
                                variables_from_state_dict(tnet.state_dict()))
    (out_dir / "train_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg), indent=2))
    return fpath, lpath
