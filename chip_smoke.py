"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device and build: prints `nvidia-smi` name and power limit, builds the
     CUDA kernels from `deflicker_torch/csrc` with nvcc and times the build;
  2. kernel vs plain: every kernel of the main path at the main path's
     shapes (the fit's mapping1 query, 90,000 rows x 6 layers of 256, and
     atlas query, 30,000 rows x 8 layers of 256 with skips), held against
     its plain PyTorch twin, then timed beside its bound, the plain twin and
     one PyTorch library call computing the same function;
  3. the pipeline: `deflicker_torch.cli.pipeline.run_pipeline` on a
     procedural flickering clip of 80 frames at 432x768, at the default
     AtlasConfig widths and batch with the shipped stage-2 weights; only
     `iters_num` is cut.  The launch counters are zeroed just before and read
     just after, and the outputs are checked;
  4. profile: 40 more fit steps of the same clip, timed plain and then under
     torch.profiler — device-busy time per step, idle share, top kernels.
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# kernel-vs-plain tolerances, relative Frobenius error ||k - p|| / ||p||.
# Both sides round operands to bf16 and accumulate in f32; the orders of the
# f32 sums differ, and in the backward a different f32 sum can round a
# bf16 gradient the other way, which later layers carry on.
TOL_FWD = 1e-2
TOL_BWD = 2e-2

ITERS = 500                 # fit steps (the default config runs 10,001)
CLIP = (80, 432, 768)       # frames, height, width


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


def phase_kernels(device) -> list:
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


def phase_pipeline(device) -> dict:
    import torch

    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.io.media import list_frames
    from deflicker_torch.ops.cuda import imlp_kernel as K

    shutil.rmtree(WORK, ignore_errors=True)
    frames = WORK / "data" / "clip"
    make_clip(frames)
    cfg = PipelineConfig(
        video_frame_folder=str(frames), root=str(frames.parent),
        results_root=str(WORK / "results"),
        ckpt_raft=str(WORK / "no-raft.pth"),
        ckpt_filter=str(ROOT / "pretrained_weights" / "neural_filter.ckpt"),
        ckpt_local=str(ROOT / "pretrained_weights" /
                       "local_refinement_net.ckpt"))
    atlas_cfg = dataclasses.replace(AtlasConfig(), iters_num=ITERS,
                                    evaluate_every=ITERS - 1,
                                    stop_global_rigidity=ITERS // 2)
    print(f"[pipeline] {CLIP[0]} frames {CLIP[1]}x{CLIP[2]} (fit at /4), full "
          f"default widths, batch {atlas_cfg.samples_batch}; cut: iters_num "
          f"10001 -> {ITERS}, evaluate_every -> {ITERS - 1}, "
          f"stop_global_rigidity -> {ITERS // 2}", flush=True)

    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    out = run_pipeline(cfg, atlas_cfg, device=device)
    launches = dict(K.launches)
    peak = torch.cuda.max_memory_allocated(device)

    if launches["fwd"] < 2 * ITERS or launches["bwd"] < 2 * ITERS:
        raise AssertionError(f"chain kernels launched {launches}, "
                             f"need >= {2 * ITERS} each")
    for key in ("psnr", "final_psnr", "final_ewarp"):
        if key not in out or not math.isfinite(out[key]):
            raise AssertionError(f"{key} missing or not finite: {out.get(key)}")
    if out["psnr"] < 10.0:
        raise AssertionError(f"stage-1 PSNR {out['psnr']} dB: fit failed")
    res = WORK / "results" / "clip"
    T = CLIP[0]
    for sub in ("stage_1/output", "neural_filter/output", "final/output"):
        n = len(list_frames(res / sub))
        if n != T:
            raise AssertionError(f"{sub}: {n} frames, want {T}")
    for f in ("stage_1/checkpoint", "final/output.mp4",
              "neural_filter/output.mp4"):
        if not (res / f).exists():
            raise AssertionError(f"missing artifact {f}")
    from deflicker_torch.io.media import read_image

    final0 = read_image(list_frames(res / "final/output")[0])
    if final0.shape != (CLIP[1], CLIP[2], 3) or not np.isfinite(final0).all():
        raise AssertionError(f"final frame shape {final0.shape}")
    summary = {k: out[k] for k in ("psnr", "final_psnr", "final_ewarp",
                                   "input_ewarp", "iters_per_sec", "t_flow",
                                   "t_pretrain", "t_fit", "t_render",
                                   "t_stage2", "t_total")}
    summary.update(launches=launches, peak_mem_gib=peak / 2 ** 30,
                   iterations=ITERS)
    print("[pipeline] " + json.dumps(summary), flush=True)
    return launches, frames, atlas_cfg


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
    from torch.autograd import DeviceType

    # device-side events only (kernels, copies): their durations, by name
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    n_kernels = sum(r[1] for r in rows)
    step_ms = 1e3 * wall / steps
    # idle share against the unprofiled wall time (the profiler slows the
    # host side, not the kernels)
    print("[profile] " + json.dumps({
        "steps": steps, "step_wall_ms": 1e3 * wall_plain / steps,
        "step_wall_ms_profiled": step_ms,
        "device_busy_ms_per_step": busy_ms / steps,
        "idle_share": 1.0 - busy_ms / (1e3 * wall_plain),
        "device_ops_per_step": n_kernels / steps}), flush=True)
    for dev_us, count, key in rows[:8] + sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[profile] {dev_us / 1e3 / steps:8.3f} ms/step  x{count / steps:5.1f}"
              f"  {key[:90]}")


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
    logs = build.build(["imlp_chain"], verbose=True)
    print(f"[build] nvcc {time.time() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    rows = phase_kernels(device)
    t1 = time.time()
    launches, frames, atlas_cfg = phase_pipeline(device)
    print(f"[pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_profile(device, frames, atlas_cfg)

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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
