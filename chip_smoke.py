"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device and build: prints `nvidia-smi` name and power limit, builds the
     CUDA kernels from `deflicker_torch/csrc` (the IMLP chain and the
     correlation lookup, one nvcc each, started together) and times it;
  2. kernel vs plain: every kernel of the main paths at their shapes — the
     fit's mapping1 query (90,000 rows x 6 layers of 256) and atlas query
     (30,000 rows x 8 layers of 256 with skips) for the chain kernels; the
     flow engine's lookup (8 x 54 x 96 pixels, D = 256, four levels, flows
     of +-3 and +-40 px, and a ragged 7 x 9, D = 32 case) for the
     correlation kernel — held against its plain PyTorch twin, then timed
     beside its bound, the plain twin and, where one PyTorch call computes
     the same function, that call;
  3. the pipeline with Farneback flow: `deflicker_torch.cli.pipeline
     .run_pipeline` on a procedural flickering clip of 80 frames at 432x768,
     at the default AtlasConfig widths and batch with the shipped stage-2
     weights; only `iters_num` is cut.  The launch counters are zeroed just
     before and read just after, and the outputs are checked;
  4. profile: 40 more fit steps of the same clip, timed plain and then under
     torch.profiler — device-busy time per step, idle share, top kernels;
  5. the pipeline with RAFT flow: a seeded random RAFT saved as a `.pth`
     with the reference's keys, found by `make_flow_provider`, on a fresh
     copy of the clip: 79 pairs in batches of 4 pairs x 2 directions, 20 GRU
     iterations, bf16, the correlation kernel in every iteration; the fit is
     cut deeper.  Counters zeroed before, read after; flow files, artifacts
     and metrics checked for shape and finiteness (untrained weights give
     noise for flow, so no quality floor applies);
  6. profile of one RAFT batch (8 x 432 x 768, 20 iterations).
The second-to-last line is the kernel table as JSON, the last line
{"ok": true, "device": {...}}.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 66.9e12
PEAK_HBM_BYTES = 3.35e12

# kernel-vs-plain tolerances, relative Frobenius error ||k - p|| / ||p||.
# Both sides round operands to bf16 and accumulate in f32; the orders of the
# f32 sums differ, and in the backward a different f32 sum can round a
# bf16 gradient the other way, which later layers carry on.
TOL_FWD = 1e-2
TOL_BWD = 2e-2
# correlation lookup: kernel and twin multiply the same bf16-rounded f2 by the
# same f32 f1 and differ only in the order of the f32 sums
TOL_CORR_REL = 1e-4         # relative Frobenius
TOL_CORR_ABS = 1e-3         # max abs, as a share of max |plain|

ITERS = 500                 # fit steps (the default config runs 10,001)
ITERS_RAFT_RUN = 100        # fit steps of the second pipeline run (RAFT flow)
CLIP = (80, 432, 768)       # frames, height, width
PAIR_BATCH = 4              # preprocess_optical_flow's default
RAFT_ITERS = 20             # RAFTFlow's default


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Median device time of fn() over `iters` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def abs_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def kernel_shapes(device):
    """The two chain calls of one fit step at the default AtlasConfig."""
    import torch

    from deflicker_torch.atlas.engine import build_specs
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.models.imlp import imlp_init, positional_encoding

    cfg = AtlasConfig()
    specs = build_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    out = []
    # mapping1: 9 coordinate variants x 10,000 samples, no encoding, no dx
    # needed; atlas: 3 variants x 10,000, PE 10 of 2-D uv, dx needed
    for name, spec, rows, need_dx in (
            ("mapping1", specs.mapping1, 9 * cfg.samples_batch, False),
            ("atlas", specs.atlas, 3 * cfg.samples_batch, True)):
        params = imlp_init(spec, gen, device)
        x = torch.rand((rows, spec.input_dim), generator=gen) * 2 - 1
        if name == "atlas":
            x = x * 0.5 + 0.5
        x = x.to(device)
        if spec.use_positional:
            x = positional_encoding(x, spec.positional_dim)
        g = torch.randn((rows, spec.output_dim), generator=gen).to(device)
        ws = [p["w"].detach() for p in params]
        bs = [p["b"].detach() for p in params]
        out.append(dict(name=name, x=x.contiguous(), ws=ws, bs=bs, g=g,
                        skips=tuple(spec.skip_layers), need_dx=need_dx))
    return out


def chain_counts(case, kind: str):
    """(flops, bytes) that the function must do and move at this shape."""
    B, E = case["x"].shape
    ws, skips = case["ws"], case["skips"]
    macs = [w.shape[0] * w.shape[1] for w in ws]
    w_bytes = sum(2 * m for m in macs) + sum(4 * b.numel() for b in case["bs"])
    O = ws[-1].shape[1]
    if kind == "fwd":
        return 2.0 * B * sum(macs), 4.0 * B * E + w_bytes + 4.0 * B * O
    # remat backward: forward of layers 0..n-2, dW of every layer, input
    # grads through the kept rows of layers n-1..1 (and layer 0 for dx)
    n = len(ws)
    flops = 2.0 * B * sum(macs[:-1]) + 2.0 * B * sum(macs)
    for i in range(n - 1, -1, -1):
        if i == 0 and not case["need_dx"]:
            continue
        kept = E if i == 0 else ws[i - 1].shape[1]
        flops += 2.0 * B * kept * ws[i].shape[1]
    grads = 4 * sum(macs) + 4 * sum(b.numel() for b in case["bs"])
    dx = 4.0 * B * E if case["need_dx"] else 0.0
    return flops, 4.0 * B * E + w_bytes + 4.0 * B * O + grads + dx


def library_chain(case, kind: str):
    """One bf16 cuBLAS matmul chain of the same layers (torch.matmul; the
    port never calls it) — forward, or its autograd backward."""
    import torch

    xb = case["x"].to(torch.bfloat16)
    wb = [w.to(torch.bfloat16) for w in case["ws"]]
    bb = [b.to(torch.bfloat16) for b in case["bs"]]

    def fwd(ws_):
        h = xb
        for i, (w, b) in enumerate(zip(ws_, bb)):
            if i > 0:
                h = torch.relu(h)
            if i in case["skips"]:
                h = torch.cat([h, xb], dim=-1)
            h = torch.matmul(h, w) + b
        return h

    if kind == "fwd":
        return lambda: fwd(wb)
    wr = [w.clone().requires_grad_() for w in wb]
    gb = case["g"].to(torch.bfloat16)

    def bwd():
        out = fwd(wr)
        torch.autograd.grad(out, wr, gb)
    return bwd


def phase_chain_kernels(device) -> dict:
    import torch

    from deflicker_torch.ops.cuda import imlp_kernel as K

    cases = kernel_shapes(device)
    rows = {"fwd": [], "bwd": []}
    for case in cases:
        x, ws, bs, g, sk = case["x"], case["ws"], case["bs"], case["g"], case["skips"]
        wb = [w.to(torch.bfloat16).contiguous() for w in ws]
        need_dx = case["need_dx"]

        y = K.imlp_chain_fwd_cuda(x, wb, bs, sk)
        torch.cuda.synchronize()
        y_p = K.imlp_chain_fwd_plain(x, ws, bs, sk)
        err_f, abs_f = rel_err(y, y_p), abs_err(y, y_p)
        if not (err_f <= TOL_FWD):
            raise AssertionError(f"fwd {case['name']}: rel err {err_f} > {TOL_FWD}")

        dx, dW, db = K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx)
        torch.cuda.synchronize()
        dx_p, dW_p, db_p = K.imlp_chain_bwd_plain(x, ws, bs, sk, g, need_dx)
        pairs = list(zip(dW + db, dW_p + db_p))
        if need_dx:
            pairs.append((dx, dx_p))
        elif dx is not None:
            raise AssertionError("dx computed though not needed")
        errs = [rel_err(a, b) for a, b in pairs]
        err_b, abs_b = max(errs), max(abs_err(a, b) for a, b in pairs)
        if not (err_b <= TOL_BWD) or not all(math.isfinite(e) for e in errs):
            raise AssertionError(f"bwd {case['name']}: rel err {err_b} > {TOL_BWD}")

        for kind, err, aerr, run, plain in (
                ("fwd", err_f, abs_f,
                 lambda: K.imlp_chain_fwd_cuda(x, wb, bs, sk),
                 lambda: K.imlp_chain_fwd_plain(x, ws, bs, sk)),
                ("bwd", err_b, abs_b,
                 lambda: K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx),
                 lambda: K.imlp_chain_bwd_plain(x, ws, bs, sk, g, need_dx))):
            flops, nbytes = chain_counts(case, kind)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            rows[kind].append(dict(
                shape=case["name"], rows=int(x.shape[0]), max_abs_err=aerr,
                rel_err=err,
                ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library_chain(case, kind)),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9))
            print(f"[kernel] {kind} {case['name']}: {rows[kind][-1]}", flush=True)
    return rows


# (name, B, H, W, D, flow spread in 1/8-resolution pixels): the flow engine's
# lookup for the clip (pair_batch 4 x 2 directions, 432x768 / 8) with windows
# mostly inside the levels, the same with windows partly and wholly outside,
# and a ragged case whose last level is empty
CORR_CASES = (("engine+-3", 2 * PAIR_BATCH, CLIP[1] // 8, CLIP[2] // 8, 256, 3.0),
              ("engine+-40", 2 * PAIR_BATCH, CLIP[1] // 8, CLIP[2] // 8, 256, 40.0),
              ("ragged-7x9", 1, 7, 9, 32, 2.0))


def corr_case(B, H, W, D, spread, device, seed=0):
    """Random f1, the bf16-stored pyramid of a random f2, coords = grid +
    uniform flow, from a seeded CPU generator."""
    import torch

    from deflicker_torch.models.raft import build_fmap_pyramid

    gen = torch.Generator().manual_seed(seed)
    f1 = torch.randn((B, H, W, D), generator=gen).to(device)
    f2 = torch.randn((B, H, W, D), generator=gen).to(device)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    flow = (torch.rand((B, H, W, 2), generator=gen) * 2 - 1) * spread
    coords = (torch.stack([xs, ys], dim=-1)[None] + flow).to(device).contiguous()
    stored = [lvl.to(torch.bfloat16).contiguous() for lvl in build_fmap_pyramid(f2)]
    return f1, f2, stored, coords


def corr_counts(f1, stored, coords, radius=4):
    """(flops, bytes) the lookup needs on these inputs: one D-long dot (2 D
    flop) for every integer window position that lies inside its level —
    positions outside read zero and need none — plus the 81 four-term
    combinations of each (pixel, level); f1, the bf16 pyramid and coords
    read once, the output written once."""
    import torch

    B, H, W, D = f1.shape
    K1 = 2 * radius + 2
    step = torch.arange(K1, device=f1.device)
    dots = 0
    for l, lvl in enumerate(stored):
        Hl, Wl = lvl.shape[1], lvl.shape[2]
        lx = (coords[..., 0] / 2.0 ** l).clamp(-(radius + 2.0), Wl - 1.0 + radius + 2.0)
        ly = (coords[..., 1] / 2.0 ** l).clamp(-(radius + 2.0), Hl - 1.0 + radius + 2.0)
        ix = (torch.floor(lx).long() - radius)[..., None] + step
        iy = (torch.floor(ly).long() - radius)[..., None] + step
        nx = ((ix >= 0) & (ix < Wl)).sum(-1)
        ny = ((iy >= 0) & (iy < Hl)).sum(-1)
        dots += int((nx * ny).sum())
    n_out = B * H * W * len(stored) * (2 * radius + 1) ** 2
    flops = 2.0 * D * dots + 7.0 * n_out
    nbytes = (4.0 * f1.numel() + 2.0 * sum(lvl.numel() for lvl in stored)
              + 4.0 * coords.numel() + 4.0 * n_out)
    return flops, nbytes, dots


def phase_corr_kernel(device) -> list:
    """The correlation kernel against its plain twin, then its time beside
    its bound, the twin and (for information: no single PyTorch call computes
    this function) the materialized path's volume build and lookup."""
    import torch

    from deflicker_torch.models import raft as R
    from deflicker_torch.ops.cuda import corr_kernel as C

    rows = []
    for name, B, H, W, D, spread in CORR_CASES:
        f1, f2, stored, coords = corr_case(B, H, W, D, spread, device)
        got = C.corr_lookup_cuda(f1, stored, coords)
        torch.cuda.synchronize()
        want = C.corr_lookup_plain(f1, stored, coords)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"corr {name}: shape {tuple(got.shape)} or "
                                 "non-finite values")
        err, aerr, scale = rel_err(got, want), abs_err(got, want), float(want.abs().max())
        if not (err <= TOL_CORR_REL) or not (aerr <= TOL_CORR_ABS * scale):
            raise AssertionError(f"corr {name}: rel err {err} (<= {TOL_CORR_REL}), "
                                 f"max abs {aerr} (<= {TOL_CORR_ABS} x {scale})")
        flops, nbytes, dots = corr_counts(f1, stored, coords)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
        row = dict(shape=name, B=B, pixels=H * W, D=D, max_abs_err=aerr,
                   rel_err=err, zero_share=float((want == 0).float().mean()),
                   ms=cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords)),
                   plain_ms=cuda_ms(lambda: C.corr_lookup_plain(f1, stored, coords)),
                   library_ms=None,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   gflop=flops / 1e9, mbytes=nbytes / 1e6, dots=dots)
        # the materialized mode on the same inputs (f32 volume): what a solve
        # pays once (build) and per iteration (lookup) without the kernel
        row["materialized_build_ms"] = cuda_ms(
            lambda: R.build_corr_pyramid(f1, f2), iters=10, warmup=2)
        volume = R.build_corr_pyramid(f1, f2)
        row["materialized_lookup_ms"] = cuda_ms(lambda: R.corr_lookup(volume, coords))
        del volume
        rows.append(row)
        print(f"[kernel] corr {name}: {row}", flush=True)
    return rows


def make_clip(frames_dir: Path, seed: int = 0) -> None:
    """A moving texture with a per-frame global gain (flicker)."""
    import cv2

    T, H, W = CLIP
    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.uniform(30, 220, (H // 8, (W + 4 * T) // 8, 3))
                      .astype(np.float32), (W + 4 * T, H),
                      interpolation=cv2.INTER_CUBIC)
    yy, xx = np.mgrid[0:H, 0:W + 4 * T].astype(np.float32)
    base += 20.0 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 13.0)[..., None]
    gains = 1.0 + 0.15 * rng.uniform(-1, 1, T)
    frames_dir.mkdir(parents=True, exist_ok=True)
    for t in range(T):
        frame = np.clip(base[:, 4 * t:4 * t + W] * gains[t], 0, 255)
        cv2.imwrite(str(frames_dir / f"{t:05d}.png"), frame.astype(np.uint8))


def reset_counters() -> None:
    from deflicker_torch.ops.cuda import corr_kernel, imlp_kernel

    imlp_kernel.reset_launches()
    corr_kernel.reset_launches()


def read_counters() -> dict:
    from deflicker_torch.ops.cuda import corr_kernel, imlp_kernel

    return {**imlp_kernel.launches, **corr_kernel.launches}


def run_pipeline_checked(device, tag: str, frames: Path, results: Path,
                         ckpt_raft: Path, iters: int, psnr_floor):
    """`run_pipeline` at the default AtlasConfig widths and batch with the
    shipped stage-2 weights and `iters` fit steps; every launch counter is
    zeroed just before and read just after; artifacts and metrics checked."""
    import torch

    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.io.media import list_frames, read_image

    cfg = PipelineConfig(
        video_frame_folder=str(frames), root=str(frames.parent),
        results_root=str(results), ckpt_raft=str(ckpt_raft),
        ckpt_filter=str(ROOT / "pretrained_weights" / "neural_filter.ckpt"),
        ckpt_local=str(ROOT / "pretrained_weights" /
                       "local_refinement_net.ckpt"))
    atlas_cfg = dataclasses.replace(AtlasConfig(), iters_num=iters,
                                    evaluate_every=iters - 1,
                                    stop_global_rigidity=iters // 2)
    print(f"[{tag}] {CLIP[0]} frames {CLIP[1]}x{CLIP[2]} (fit at /4), full "
          f"default widths, batch {atlas_cfg.samples_batch}; cut: iters_num "
          f"10001 -> {iters}, evaluate_every -> {iters - 1}, "
          f"stop_global_rigidity -> {iters // 2}", flush=True)

    torch.cuda.reset_peak_memory_stats(device)
    reset_counters()
    out = run_pipeline(cfg, atlas_cfg, device=device)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(device)

    if launches["fwd"] < 2 * iters or launches["bwd"] < 2 * iters:
        raise AssertionError(f"chain kernels launched {launches}, "
                             f"need >= {2 * iters} each")
    for key in ("psnr", "final_psnr", "final_ewarp"):
        if key not in out or not math.isfinite(out[key]):
            raise AssertionError(f"{key} missing or not finite: {out.get(key)}")
    if psnr_floor is not None and out["psnr"] < psnr_floor:
        raise AssertionError(f"stage-1 PSNR {out['psnr']} dB: fit failed")
    res = results / frames.name
    T = CLIP[0]
    for sub in ("stage_1/output", "neural_filter/output", "final/output"):
        n = len(list_frames(res / sub))
        if n != T:
            raise AssertionError(f"{sub}: {n} frames, want {T}")
    for f in ("stage_1/checkpoint", "final/output.mp4",
              "neural_filter/output.mp4"):
        if not (res / f).exists():
            raise AssertionError(f"missing artifact {f}")
    final0 = read_image(list_frames(res / "final/output")[0])
    if final0.shape != (CLIP[1], CLIP[2], 3) or not np.isfinite(final0).all():
        raise AssertionError(f"final frame shape {final0.shape}")
    summary = {k: out[k] for k in ("psnr", "final_psnr", "final_ewarp",
                                   "input_ewarp", "iters_per_sec", "t_flow",
                                   "t_pretrain", "t_fit", "t_render",
                                   "t_stage2", "t_total")}
    summary.update(launches=launches, peak_mem_gib=peak / 2 ** 30,
                   iterations=iters)
    print(f"[{tag}] " + json.dumps(summary), flush=True)
    return out, launches, atlas_cfg


def phase_pipeline(device):
    """The pipeline with Farneback flow (no RAFT checkpoint on disk)."""
    shutil.rmtree(WORK, ignore_errors=True)
    frames = WORK / "data" / "clip"
    make_clip(frames)
    _, launches, atlas_cfg = run_pipeline_checked(
        device, "pipeline", frames, WORK / "results", WORK / "no-raft.pth",
        ITERS, psnr_floor=10.0)
    if launches["lookup"] != 0:
        raise AssertionError(f"Farneback run launched the corr kernel: {launches}")
    return launches, frames, atlas_cfg


def phase_raft_pipeline(device, frames: Path) -> dict:
    """The pipeline with RAFT flow through the normal entry points: a seeded
    random RAFT saved as `raft-things.pth` is stored (reference keys under
    `module.`), found by `make_flow_provider` from `PipelineConfig.ckpt_raft`,
    on a fresh copy of the frames so that no flow cache is reused."""
    import torch

    from deflicker_torch.cli.pipeline import make_flow_provider
    from deflicker_torch.config import PipelineConfig
    from deflicker_torch.flow import RAFTFlow
    from deflicker_torch.models.raft import raft_init

    ckpt = WORK / "raft-random.pth"
    model = raft_init(torch.Generator().manual_seed(0))
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()}, ckpt)
    copy = WORK / "data_raft" / frames.name
    shutil.copytree(frames, copy)
    provider = make_flow_provider(PipelineConfig(ckpt_raft=str(ckpt)), device)
    if not isinstance(provider, RAFTFlow) or provider.iters != RAFT_ITERS \
            or provider.dtype != torch.bfloat16 or provider.corr_mode != "auto":
        raise AssertionError(f"flow provider is {provider!r}")
    del provider, model

    pairs = CLIP[0] - 1
    batches = -(-pairs // PAIR_BATCH)
    print(f"[raft-pipeline] random RAFT weights (seed 0) at full size, {pairs} "
          f"pairs in {batches} batches of {PAIR_BATCH} pairs x 2 directions, "
          f"{RAFT_ITERS} GRU iterations, bf16, corr_mode auto; no PSNR floor "
          "(flow from untrained weights is noise)", flush=True)
    out, launches, _ = run_pipeline_checked(
        device, "raft-pipeline", copy, WORK / "results_raft", ckpt,
        ITERS_RAFT_RUN, psnr_floor=None)
    if launches["lookup"] < batches * RAFT_ITERS:
        raise AssertionError(f"corr kernel launched {launches['lookup']} times, "
                             f"need >= {batches * RAFT_ITERS}")
    flows = sorted((copy.parent / f"{copy.name}_flow").glob("*.npy"))
    if len(flows) != 2 * pairs:
        raise AssertionError(f"{len(flows)} flow files, want {2 * pairs}")
    peak_flow = 0.0
    for f in flows:
        flow = np.load(f)
        if flow.shape != (CLIP[1], CLIP[2], 2) or flow.dtype != np.float32 \
                or not np.isfinite(flow).all():
            raise AssertionError(f"{f.name}: {flow.shape} {flow.dtype} or not finite")
        peak_flow = max(peak_flow, float(np.abs(flow).max()))
    print("[raft-pipeline] " + json.dumps({
        "t_flow": out["t_flow"], "pairs": pairs,
        "pairs_per_sec": pairs / out["t_flow"], "flow_files": len(flows),
        "max_abs_flow_px": peak_flow, "corr_launches": launches["lookup"]}),
        flush=True)
    return launches


def device_events(prof):
    """Device-side events of a torch.profiler run (kernels, copies), summed
    by name: [(microseconds, count, name)], longest first."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    return sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)


def phase_profile(device, frames: Path, atlas_cfg, steps: int = 40) -> None:
    """Where a fit step's time goes: `steps` more steps of the same fit under
    torch.profiler; device-busy time (sum of kernel times) against the
    step's wall time gives the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data)

    T, H, W = CLIP[0], CLIP[1] // 4, CLIP[2] // 4
    # pack once: fit_atlas reuses a pack already on the device
    data = load_video_data(frames, H, W, atlas_cfg.maximum_number_of_frames
                           ).with_packed(device)
    cfg = dataclasses.replace(atlas_cfg, iters_num=steps, steps_per_call=steps,
                              evaluate_every=10 ** 9)
    specs = build_specs(cfg)
    params = init_models(specs, torch.Generator().manual_seed(0), device)
    gen = torch.Generator(device=device).manual_seed(0)
    fit_atlas(params, specs, data, dataclasses.replace(cfg, iters_num=5), gen)
    torch.cuda.synchronize()
    t0 = time.time()
    fit_atlas(params, specs, data, cfg, gen)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fit_atlas(params, specs, data, cfg, gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report_profile("profile", "step", steps, wall_plain, wall, prof)


def report_profile(tag: str, unit: str, n: int, wall_plain: float, wall: float,
                   prof) -> None:
    """Device-busy time per `unit`, idle share and the top device ops of a
    profiled window of `n` units.  The idle share is taken against the
    unprofiled wall time (the profiler slows the host side, not the
    kernels)."""
    rows = device_events(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    n_ops = sum(r[1] for r in rows)
    print(f"[{tag}] " + json.dumps({
        f"{unit}s": n, f"{unit}_wall_ms": 1e3 * wall_plain / n,
        f"{unit}_wall_ms_profiled": 1e3 * wall / n,
        f"device_busy_ms_per_{unit}": busy_ms / n,
        "idle_share": 1.0 - busy_ms / (1e3 * wall_plain),
        f"device_ops_per_{unit}": n_ops / n}), flush=True)
    for dev_us, count, key in rows[:8] + sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[{tag}] {dev_us / 1e3 / n:8.3f} ms/{unit}  x{count / n:6.1f}"
              f"  {key[:90]}")


def phase_raft_profile(device, frames: Path, solves: int = 3) -> None:
    """Where a flow solve's time goes: `RAFTFlow.compute_batch` on one batch
    of the clip (4 pairs x 2 directions at 432x768, 20 iterations, bf16),
    upload and download included, timed plain and under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.flow import RAFTFlow, load_flow_image
    from deflicker_torch.io.media import list_frames

    files = list_frames(frames)[:PAIR_BATCH + 1]
    ims = [load_flow_image(f) for f in files]
    a = np.stack(ims[:-1] + ims[1:])
    b = np.stack(ims[1:] + ims[:-1])
    engine = RAFTFlow(WORK / "raft-random.pth", device=device)
    engine.compute_batch(a, b)                           # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(solves):
        engine.compute_batch(a, b)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(solves):
            engine.compute_batch(a, b)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report_profile("raft-profile", "solve", solves, wall_plain, wall, prof)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import deflicker_torch  # noqa: F401  (fails outside a checkout)
    from deflicker_torch.ops.cuda import build

    smi = nvidia_smi_line()
    print(smi, flush=True)
    device = torch.device("cuda:0")
    t0 = time.time()
    logs = build.build(["imlp_chain", "corr_lookup"], verbose=True)
    print(f"[build] nvcc {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = phase_chain_kernels(device)
    corr_rows = phase_corr_kernel(device)
    t1 = time.time()
    launches, frames, atlas_cfg = phase_pipeline(device)
    print(f"[pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_profile(device, frames, atlas_cfg)
    t1 = time.time()
    raft_launches = phase_raft_pipeline(device, frames)
    print(f"[raft-pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_raft_profile(device, frames)

    src = "deflicker_torch/csrc/imlp_chain.cu"
    replaces = {"fwd": "deflicker_tpu/ops/pallas/imlp_kernel.py:421",
                "bwd": "deflicker_tpu/ops/pallas/imlp_kernel.py:470"}
    kernels = []
    for kind in ("fwd", "bwd"):
        r = rows[kind]
        # one fit step's two calls (mapping1 + atlas) summed
        kernels.append({
            "name": f"imlp_chain_{kind}", "route": "cuda", "source": src,
            "replaces": replaces[kind], "launches": launches[kind],
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r),
            "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": "operations" if all(x["bound_by"] == "operations"
                                            for x in r) else "bytes",
            "library_ms": sum(x["library_ms"] for x in r),
            "per_shape": r,
        })
    # the lookup of one GRU iteration at the engine's shape (the first case);
    # its launches are those of the RAFT pipeline run
    main_shape = corr_rows[0]
    kernels.append({
        "name": "corr_lookup", "route": "cuda",
        "source": "deflicker_torch/csrc/corr_lookup.cu",
        "replaces": "deflicker_tpu/ops/pallas/corr_kernel.py:616",
        "launches": raft_launches["lookup"],
        "max_abs_err": max(x["max_abs_err"] for x in corr_rows),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "per_shape": corr_rows,
    })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
