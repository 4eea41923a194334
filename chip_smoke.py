"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device and build: prints `nvidia-smi` name and power limit, builds the
     CUDA kernels from `deflicker_torch/csrc` (the IMLP chain and the
     correlation lookup, one nvcc each, started together) and times it,
     with every kernel's registers, spills and shared memory;
  2. kernel vs plain: every kernel of the main paths at their shapes — the
     single fit's mapping1 query (90,000 rows x 6 layers of 256) and atlas
     query (30,000 rows x 8 layers of 256 with skips) for the remat pair of
     chain kernels; the dual fit's four queries (mapping1 and the 4-layer
     mapping2 at 90,000 rows, atlas at 60,000, the one-output alpha at
     50,000) for the stash pair, whose gradients must also equal the remat
     pair's bit for bit; the flow engine's lookup (8 x 54 x 96 pixels,
     D = 256, four levels, flows of +-3 and +-40 px, and a ragged 7 x 9,
     D = 32 case) for the correlation kernel — held against its plain
     PyTorch twin, then timed beside its bound, the plain twin and, where
     one PyTorch call computes the same function, that call; each backward
     also piece by piece (recompute, reverse pass, dW GEMM, reduction);
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
  6. profile of one RAFT batch (8 x 432 x 768, 20 iterations);
  7. the dual-atlas pipeline: `run_pipeline` with `class_name` set on a
     second procedural clip (a textured disc moving over a moving
     background, per-frame gain flicker) whose `_seg` masks are on disk and
     are picked up by `preprocess_masks`; four networks at the default
     widths, batch 10,000, fit at 432x768 (the dual default, down = 1),
     DEFLICKER_IMLP_STASH=1, so every chain call of the fit goes through
     the stash pair: its counters must read 4 x steps each and the remat
     pair's 0.  The schedule is scaled so that both loss graphs a default
     run reaches execute; loss terms, metrics, textures and alpha maps are
     checked, and alpha must have begun to follow the mask;
  8. profile of the dual fit step, with the stash pair and with the remat
     pair, same seeds;
  9. the two other correlation bodies at the flow engine's shape (8 x 54 x
     96, D = 256, four levels) and flows of +-0.5, +-3 and +-40 px: the
     shared body (a block stages its 8 pixels' union window in shared
     memory) and the resident body (levels 2-3 held whole in shared memory)
     against the plain twin and bit-equal to the band body, timed beside
     it, with the share of staged windows and the resident levels;
 10. the chain kernels with a video axis, V = 3 at the single fit's shapes,
     both pairs: against the twins, bit-equal to V one-video launches, one
     V = 3 launch timed against 3 one-video launches;
 11. the chunked long-video path: `run_pipeline` on a 170-frame clip with
     `maximum_number_of_frames` 80 (3 chunks of 57, the last anchored back
     one frame), RAFT flow with DEFLICKER_CORR_RESIDENT=1, one V = 3 fit of
     the three chunks at the default widths and batch, every frame rendered,
     stage 2 over all 170 frames; then 40 profiled steps of that group fit;
 12. the batch CLI's group mode (`cli.batch --parallel_fit`) on two 80-frame
     clips: RAFT flow with DEFLICKER_CORR_SHARED=1, one V = 2 fit with
     DEFLICKER_IMLP_STASH=1, stage 2 through `FilterEngine.run_multi`.
Each pipeline phase zeroes the launch counters just before it and reads
them just after.  The second-to-last line is the kernel table as JSON, the
last line {"ok": true, "device": {...}}.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
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
ITERS_DUAL = 300            # fit steps of the dual-atlas run
PRETRAIN_DUAL = 50          # pretrain sweeps per mapping of the dual run (default 100)
CLIP = (80, 432, 768)       # frames, height, width
PAIR_BATCH = 4              # preprocess_optical_flow's default
RAFT_ITERS = 20             # RAFTFlow's default
LONG_FRAMES = 170           # the chunked phase's clip
LONG_CAP = 80               # its maximum_number_of_frames (default 200)
ITERS_MULTI = 100           # fit steps of the chunked and batch phases
PRETRAIN_MULTI = 25         # pretrain sweeps there (default 100)
CORR_SPREADS = (0.5, 3.0, 40.0)
VIDEOS = 3                  # video axis of the batched chain phase


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


@contextlib.contextmanager
def env(**values):
    """Set environment switches for a block, then restore them."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def piece_times(K, x, wb, bs, sk, g, need_dx, stash=None) -> dict:
    """CUDA-event times of the launches of one backward call, each run alone
    on a scratch that a whole call filled: the recompute (remat only), the
    reverse pass, the dW GEMM and the reduction."""
    launch = K.bwd_piece_launcher(x, wb, bs, sk, g, need_dx, stash)
    names = ("reverse", "dw", "reduce") if stash is not None else \
        ("recompute", "reverse", "dw", "reduce")
    return {name: cuda_ms(lambda: launch(name)) for name in names}


def print_build(logs: dict) -> None:
    """Registers and spills of every kernel from ptxas, then the chain
    kernels' registers, local bytes and shared memory a block as the
    runtime reports them."""
    from deflicker_torch.ops.cuda import imlp_kernel

    for name, log in logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                entry = entry[entry.find("_cu_") + 4:] if "_cu_" in entry else entry
            elif ("Used" in line and "registers" in line) or "spill" in line:
                print(f"[build] {name} {entry[:70]}: {line.strip()}")
    for kname, (regs, local, smem) in imlp_kernel.kernel_attrs().items():
        print(f"[build] imlp_chain {kname}: {regs} registers, {local} local bytes "
              f"a thread, {smem} shared bytes a block", flush=True)


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
            if kind == "bwd":
                rows[kind][-1]["pieces_ms"] = piece_times(K, x, wb, bs, sk, g, need_dx)
            print(f"[kernel] {kind} {case['name']}: {rows[kind][-1]}", flush=True)
    return rows


# The four chain calls of one dual fit step: (network, coordinate variants
# per sample while the global rigidity term is on, and after it stops, whether
# the call needs dx).  A mapping is queried at 7 variants plus 2 for global
# rigidity, the atlas at fg and bg quadrants x base / x+1 / y+1, alpha at 5.
DUAL_CALLS = (("mapping1", 9, 7, False), ("mapping2", 9, 7, False),
              ("atlas", 6, 6, True), ("alpha", 5, 5, False))


def dual_kernel_shapes(device):
    """The chain calls of the dual fit at the default AtlasConfig (10,000
    samples a step): the four of a step with global rigidity first (90,000,
    90,000, 60,000 and 50,000 rows), then the two mappings at the 70,000
    rows they are called with once global rigidity has stopped."""
    import torch

    from deflicker_torch.atlas.engine import build_specs
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.models.imlp import imlp_init, positional_encoding

    cfg = AtlasConfig()
    specs = build_specs(cfg, dual=True)
    gen = torch.Generator().manual_seed(1)
    out = []
    calls = [(name, early, True, need_dx)
             for name, early, _, need_dx in DUAL_CALLS]
    calls += [(f"{name}-late", late, False, need_dx)
              for name, early, late, need_dx in DUAL_CALLS if late != early]
    for name, variants, with_global, need_dx in calls:
        spec = getattr(specs, name.removesuffix("-late"))
        rows = variants * cfg.samples_batch
        params = imlp_init(spec, gen, device)
        x = (torch.rand((rows, spec.input_dim), generator=gen) * 2 - 1).to(device)
        if spec.use_positional:
            x = positional_encoding(x, spec.positional_dim)
        g = torch.randn((rows, spec.output_dim), generator=gen).to(device)
        out.append(dict(name=name, x=x.contiguous(),
                        ws=[p["w"].detach() for p in params],
                        bs=[p["b"].detach() for p in params], g=g,
                        skips=tuple(spec.skip_layers), need_dx=need_dx,
                        with_global=with_global))
    return out


def stash_counts(case, kind: str):
    """(flops, bytes) of the stash pair at this shape.  Forward: the chain's
    products; x, weights and biases read, the output and the bf16 stash
    (B x the widths of layers 0..n-2) written.  Backward: dW of every layer
    and the input gradients through the kept rows, no recompute; x, weights,
    g and the stash read, the gradients (and dx) written."""
    B, E = case["x"].shape
    ws = case["ws"]
    macs = [w.shape[0] * w.shape[1] for w in ws]
    w_bytes = sum(2 * m for m in macs) + sum(4 * b.numel() for b in case["bs"])
    O = ws[-1].shape[1]
    stash = 2.0 * B * sum(w.shape[1] for w in ws[:-1])
    if kind == "fwd":
        return 2.0 * B * sum(macs), 4.0 * B * E + w_bytes + 4.0 * B * O + stash
    flops = 2.0 * B * sum(macs)
    for i in range(len(ws) - 1, -1, -1):
        if i == 0 and not case["need_dx"]:
            continue
        kept = E if i == 0 else ws[i - 1].shape[1]
        flops += 2.0 * B * kept * ws[i].shape[1]
    grads = 4 * sum(macs) + 4 * sum(b.numel() for b in case["bs"])
    dx = 4.0 * B * E if case["need_dx"] else 0.0
    return flops, 4.0 * B * E + w_bytes + 4.0 * B * O + stash + grads + dx


def library_stash_chain(case, kind: str):
    """The same bf16 `torch.matmul` chain with autograd on, whose forward
    saves its activations as the stash forward does; its backward alone
    (`torch.autograd.grad` on the kept graph) stands beside the stash
    backward.  The port never calls it."""
    import torch

    xb = case["x"].to(torch.bfloat16).requires_grad_(case["need_dx"])
    wr = [w.to(torch.bfloat16).requires_grad_() for w in case["ws"]]
    bb = [b.to(torch.bfloat16) for b in case["bs"]]
    gb = case["g"].to(torch.bfloat16)

    def fwd():
        h = xb
        for i, (w, b) in enumerate(zip(wr, bb)):
            if i > 0:
                h = torch.relu(h)
            if i in case["skips"]:
                h = torch.cat([h, xb.detach()], dim=-1)
            h = torch.matmul(h, w) + b
        return h

    if kind == "fwd":
        return fwd
    out = fwd()
    wanted = wr + ([xb] if case["need_dx"] else [])
    return lambda: torch.autograd.grad(out, wanted, gb, retain_graph=True)


def phase_stash_kernels(device) -> dict:
    """The stash pair at every shape the dual fit calls it with: against the
    plain twins (the tolerances of the remat pair), bit-equal to the remat
    pair, the wrapper's stash layout against the kernel's, then timed beside
    its bound, the plain twins and the library chain."""
    import ctypes

    import torch

    from deflicker_torch.ops.cuda import imlp_kernel as K

    rows = {"fwd_stash": [], "bwd_stash": []}
    for case in dual_kernel_shapes(device):
        x, ws, bs, g, sk = case["x"], case["ws"], case["bs"], case["g"], case["skips"]
        wb = [w.to(torch.bfloat16).contiguous() for w in ws]
        need_dx, name, B = case["need_dx"], case["name"], x.shape[0]

        y, stash = K.imlp_chain_fwd_stash_cuda(x, wb, bs, sk)
        torch.cuda.synchronize()
        in_kernel = K._library().imlp_chain_stash_elems(
            ctypes.byref(K._desc(x, wb, bs, sk)), B)
        if in_kernel != stash.numel():
            raise AssertionError(f"fwd_stash {name}: the wrapper lays out "
                                 f"{stash.numel()} stash elements, the kernel "
                                 f"{in_kernel}")
        y_p, stash_p = K.imlp_chain_fwd_stash_plain(x, ws, bs, sk)
        views = K.stash_views(stash, wb, B)
        pairs_f = [(y, y_p)] + list(zip(views, stash_p))
        err_f = max(rel_err(a, b) for a, b in pairs_f)
        abs_f = max(abs_err(a, b) for a, b in pairs_f)
        if not (err_f <= TOL_FWD) or not torch.equal(
                y, K.imlp_chain_fwd_cuda(x, wb, bs, sk)):
            raise AssertionError(f"fwd_stash {name}: rel err {err_f} > {TOL_FWD} "
                                 "or output differs from the remat forward")

        dx, dW, db = K.imlp_chain_bwd_stash_cuda(x, wb, bs, sk, stash, g, need_dx)
        dx_r, dW_r, db_r = K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx)
        torch.cuda.synchronize()
        if (dx is None) != (not need_dx):
            raise AssertionError("dx computed though not needed, or missing")
        same = all(torch.equal(a, b) for a, b in zip(dW + db, dW_r + db_r))
        if need_dx:
            same = same and torch.equal(dx, dx_r)
        if not same:
            raise AssertionError(f"bwd_stash {name}: gradients are not bit-equal "
                                 "to the remat backward's")
        dx_p, dW_p, db_p = K.imlp_chain_bwd_stash_plain(x, ws, bs, sk, stash_p, g,
                                                        need_dx)
        pairs_b = list(zip(dW + db, dW_p + db_p)) + ([(dx, dx_p)] if need_dx else [])
        errs = [rel_err(a, b) for a, b in pairs_b]
        err_b, abs_b = max(errs), max(abs_err(a, b) for a, b in pairs_b)
        if not (err_b <= TOL_BWD) or not all(math.isfinite(e) for e in errs):
            raise AssertionError(f"bwd_stash {name}: rel err {err_b} > {TOL_BWD}")

        for kind, key, err, aerr, run, plain in (
                ("fwd", "fwd_stash", err_f, abs_f,
                 lambda: K.imlp_chain_fwd_stash_cuda(x, wb, bs, sk),
                 lambda: K.imlp_chain_fwd_stash_plain(x, ws, bs, sk)),
                ("bwd", "bwd_stash", err_b, abs_b,
                 lambda: K.imlp_chain_bwd_stash_cuda(x, wb, bs, sk, stash, g, need_dx),
                 lambda: K.imlp_chain_bwd_stash_plain(x, ws, bs, sk, stash_p, g,
                                                      need_dx))):
            flops, nbytes = stash_counts(case, kind)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            remat = (lambda: K.imlp_chain_fwd_cuda(x, wb, bs, sk)) if kind == "fwd" \
                else (lambda: K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx))
            rows[key].append(dict(
                shape=name, rows=int(B), max_abs_err=aerr, rel_err=err,
                bit_equal_to_remat=True, with_global=case["with_global"],
                ms=cuda_ms(run), remat_ms=cuda_ms(remat), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library_stash_chain(case, kind)),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
                stash_mbytes=stash.numel() * 2 / 1e6))
            if kind == "bwd":
                rows[key][-1]["pieces_ms"] = piece_times(K, x, wb, bs, sk, g, need_dx,
                                                         stash)
            print(f"[kernel] {key} {name}: {rows[key][-1]}", flush=True)
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


def make_clip(frames_dir: Path, seed: int = 0, T: int = CLIP[0]) -> None:
    """A moving texture with a per-frame global gain (flicker)."""
    import cv2

    _, H, W = CLIP
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


def make_dual_clip(frames_dir: Path, seed: int = 1) -> None:
    """A textured disc (the foreground, drifting right and bobbing) over a
    texture that pans at another speed, with a per-frame global gain (flicker); the
    disc's mask goes to `<frames_dir>_seg/%05d.png` (uint8 0/255), where the
    pipeline's mask step finds it."""
    import cv2

    T, H, W = CLIP
    rng = np.random.default_rng(seed)

    def texture(h, w, cell):
        small = rng.uniform(30, 220, (h // cell + 1, w // cell + 1, 3))
        return cv2.resize(small.astype(np.float32), (w, h),
                          interpolation=cv2.INTER_CUBIC)

    back = texture(H, W + 2 * T, 8)
    fore = texture(2 * 90, 2 * 90, 5) * 0.6 + 90.0
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    gains = 1.0 + 0.15 * rng.uniform(-1, 1, T)
    seg_dir = frames_dir.parent / f"{frames_dir.name}_seg"
    frames_dir.mkdir(parents=True, exist_ok=True)
    seg_dir.mkdir(parents=True, exist_ok=True)
    for t in range(T):
        frame = back[:, 2 * (T - t):2 * (T - t) + W].copy()
        cx = 200.0 + 3.0 * t
        cy = H / 2 + 40.0 * math.sin(t / 12.0)
        inside = (yy - cy) ** 2 + (xx - cx) ** 2 < 90.0 ** 2
        fy = np.clip(yy - cy + 90, 0, 179).astype(int)
        fx = np.clip(xx - cx + 90, 0, 179).astype(int)
        frame[inside] = fore[fy[inside], fx[inside]]
        frame = np.clip(frame * gains[t], 0, 255)
        cv2.imwrite(str(frames_dir / f"{t:05d}.png"), frame.astype(np.uint8))
        cv2.imwrite(str(seg_dir / f"{t:05d}.png"), inside.astype(np.uint8) * 255)


def reset_counters() -> None:
    from deflicker_torch.ops.cuda import corr_kernel, imlp_kernel

    imlp_kernel.reset_launches()
    corr_kernel.reset_launches()


def read_counters() -> dict:
    from deflicker_torch.ops.cuda import corr_kernel, imlp_kernel

    return {**imlp_kernel.launches, **corr_kernel.launches}


def run_pipeline_checked(device, tag: str, frames: Path, results: Path,
                         ckpt_raft: Path, iters: int, psnr_floor,
                         class_name=None, overrides=None, n_frames=CLIP[0],
                         pair=None):
    """`run_pipeline` at the default AtlasConfig widths and batch with the
    shipped stage-2 weights and `iters` fit steps; every launch counter is
    zeroed just before and read just after; artifacts and metrics checked.
    `class_name` runs the dual-atlas path (masks through the GrabCut
    provider step, which reuses the `_seg` files on disk); `overrides` are
    further AtlasConfig cuts; `pair` names the chain counters that must read
    networks x steps (by default the remat or the stash pair)."""
    import torch

    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.io.media import list_frames, read_image

    cfg = PipelineConfig(
        video_frame_folder=str(frames), root=str(frames.parent),
        results_root=str(results), ckpt_raft=str(ckpt_raft),
        ckpt_filter=str(ROOT / "pretrained_weights" / "neural_filter.ckpt"),
        ckpt_local=str(ROOT / "pretrained_weights" /
                       "local_refinement_net.ckpt"),
        class_name=class_name,
        mask_provider="grabcut" if class_name else None)
    cuts = dict(iters_num=iters, evaluate_every=iters - 1,
                stop_global_rigidity=iters // 2)
    cuts.update(overrides or {})
    default = AtlasConfig()
    atlas_cfg = dataclasses.replace(default, **cuts)
    print(f"[{tag}] {n_frames} frames {CLIP[1]}x{CLIP[2]} (fit at "
          f"/{1 if class_name else 4}), full default widths, batch "
          f"{atlas_cfg.samples_batch}; cut: " + ", ".join(
              f"{k} {getattr(default, k)} -> {v}" for k, v in cuts.items()),
          flush=True)

    torch.cuda.reset_peak_memory_stats(device)
    reset_counters()
    out = run_pipeline(cfg, atlas_cfg, device=device)
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated(device)

    pair = pair or (("fwd_stash", "bwd_stash") if class_name else ("fwd", "bwd"))
    calls = (4 if class_name else 2) * iters       # networks x fit steps
    if any(launches[k] != calls for k in pair):
        raise AssertionError(f"chain kernels launched {launches}, "
                             f"need {calls} of {pair} each")
    for key in ("psnr", "final_psnr", "final_ewarp"):
        if key not in out or not math.isfinite(out[key]):
            raise AssertionError(f"{key} missing or not finite: {out.get(key)}")
    if psnr_floor is not None and out["psnr"] < psnr_floor:
        raise AssertionError(f"stage-1 PSNR {out['psnr']} dB: fit failed")
    res = results / frames.name
    T = n_frames
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
                                   "t_stage2", "t_total", "chunks")
               if k in out}
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


def reckoned_stash_bytes(batch: int) -> dict:
    """bf16 stash of one dual fit step with global rigidity (the largest),
    all four networks alive at once between forward and backward: rows x the
    widths of layers 0..n-2."""
    from deflicker_torch.atlas.engine import build_specs
    from deflicker_torch.config import AtlasConfig

    specs = build_specs(AtlasConfig(), dual=True)
    out = {}
    for name, variants, _, _ in DUAL_CALLS:
        spec = getattr(specs, name)
        out[name] = 2 * variants * batch * sum(
            fan_out for _, fan_out in spec.layer_dims()[:-1])
    return out


def phase_dual_pipeline(device):
    """The dual-atlas pipeline through `run_pipeline` with `class_name` set
    and the stash pair selected by DEFLICKER_IMLP_STASH=1."""
    frames = WORK / "data_dual" / "clipdual"
    make_dual_clip(frames)
    seg = frames.parent / f"{frames.name}_seg"
    stamps = {p.name: p.stat().st_mtime_ns for p in seg.glob("*.png")}
    if len(stamps) != CLIP[0]:
        raise AssertionError(f"{len(stamps)} mask files, want {CLIP[0]}")
    # the default schedule (global rigidity for the first half, alpha
    # bootstrapping up to the last step) scaled to the cut run, so both loss
    # graphs a default run reaches execute; stopping the bootstrap earlier
    # in so short a run lets alpha collapse to 0 everywhere
    overrides = dict(stop_bootstrapping_iteration=ITERS_DUAL - 1,
                     pretrain_iter_number=PRETRAIN_DUAL)
    stash = reckoned_stash_bytes(10000)
    print("[dual-pipeline] DEFLICKER_IMLP_STASH=1; stash per step reckoned "
          f"{ {k: round(v / 1e6, 1) for k, v in stash.items()} } MB, "
          f"{sum(stash.values()) / 1e6:.1f} MB in all", flush=True)
    with env(DEFLICKER_IMLP_STASH="1"):
        out, launches, atlas_cfg = run_pipeline_checked(
            device, "dual-pipeline", frames, WORK / "results_dual",
            WORK / "no-raft.pth", ITERS_DUAL, psnr_floor=10.0,
            class_name="anything", overrides=overrides)
    if launches["fwd"] or launches["bwd"] or launches["lookup"]:
        raise AssertionError(f"the dual stash run launched other kernels: {launches}")
    if out["res"] != (CLIP[1], CLIP[2]):
        raise AssertionError(f"dual fit resolution {out['res']}")
    if {p.name: p.stat().st_mtime_ns for p in seg.glob("*.png")} != stamps:
        raise AssertionError("the mask step rewrote the masks on disk")

    s1 = WORK / "results_dual" / frames.name / "stage_1"
    seen = set()
    for line in (s1 / "scalars.jsonl").read_text().splitlines():
        rec = json.loads(line)
        bad = [k for k, v in rec.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite loss terms {bad} at step {rec['step']}")
        seen |= set(rec)
    want = {"rgb", "gradient", "rigidity1", "rigidity2", "global_rigidity1",
            "global_rigidity2", "flow1", "flow2", "sparsity", "alpha_flow",
            "alpha_bootstrap", "total"}
    if not want <= seen:
        raise AssertionError(f"loss terms never logged: {sorted(want - seen)}")
    from deflicker_torch.io.media import list_frames, read_image

    for name in ("texture1.png", "texture2.png", "texture1_marked.png",
                 "texture2_marked.png"):
        tex = read_image(s1 / "texture" / name)
        if tex.shape != (1000, 1000, 3) or not np.isfinite(tex).all():
            raise AssertionError(f"{name}: shape {tex.shape}")
    alphas = list_frames(s1 / "texture" / "alpha")
    if len(alphas) != CLIP[0]:
        raise AssertionError(f"{len(alphas)} alpha maps, want {CLIP[0]}")
    a0 = read_image(alphas[0])
    if a0.shape != (CLIP[1], CLIP[2], 3) or not (0.0 <= a0.min() <= a0.max() <= 1.0):
        raise AssertionError(f"alpha map shape {a0.shape}")
    m0 = read_image(list_frames(seg)[0])[..., 0] > 0.5
    print(f"[dual-pipeline] loss terms {sorted(seen - {'step', 'time'})} finite; "
          f"textures 1000x1000, {len(alphas)} alpha maps; alpha of frame 0 (8-bit): "
          f"mean {float(a0[m0].mean()):.4f} inside the mask, "
          f"{float(a0[~m0].mean()):.4f} outside, range {float(a0.min()):.4f}.."
          f"{float(a0.max()):.4f}", flush=True)
    if not float(a0[m0].mean()) > float(a0[~m0].mean()) + 0.05:
        raise AssertionError("alpha does not follow the mask: the dual fit failed")
    last = json.loads((s1 / "scalars.jsonl").read_text().splitlines()[-1])
    print("[dual-pipeline] last chunk's mean loss terms: " + json.dumps(
        {k: v for k, v in last.items() if k != "time"}), flush=True)
    return launches, frames, atlas_cfg


def phase_dual_profile(device, frames: Path, atlas_cfg, steps: int = 20) -> None:
    """Where a dual fit step's time goes, with the stash pair and with the
    remat pair: the same data, init and sample seeds for both; `steps` steps
    timed plain, then under torch.profiler; peak device memory of each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data)
    from deflicker_torch.ops.cuda import imlp_kernel

    T, H, W = CLIP
    data = load_video_data(frames, H, W, atlas_cfg.maximum_number_of_frames,
                           use_masks=True).with_packed(device)
    cfg = dataclasses.replace(atlas_cfg, iters_num=steps, steps_per_call=steps,
                              evaluate_every=10 ** 9, stop_global_rigidity=10 ** 9,
                              stop_bootstrapping_iteration=10 ** 9)
    specs = build_specs(cfg, dual=True)
    for mode in ("stash", "remat", "remat", "stash"):
        with env(DEFLICKER_IMLP_STASH="1" if mode == "stash" else "0"):
            params = init_models(specs, torch.Generator().manual_seed(0), device)
            gen = torch.Generator(device=device).manual_seed(0)
            fit_atlas(params, specs, data, dataclasses.replace(cfg, iters_num=5), gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            imlp_kernel.reset_launches()
            t0 = time.time()
            fit_atlas(params, specs, data, cfg, gen)
            torch.cuda.synchronize()
            wall_plain = time.time() - t0
            peak = torch.cuda.max_memory_allocated(device)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.time()
                fit_atlas(params, specs, data, cfg, gen)
                torch.cuda.synchronize()
                wall = time.time() - t0
            print(f"[dual-profile-{mode}] launches {dict(imlp_kernel.launches)}, "
                  f"peak memory {peak / 2 ** 30:.3f} GiB", flush=True)
            report_profile(f"dual-profile-{mode}", "step", steps, wall_plain,
                           wall, prof)


def phase_corr_bodies(device) -> dict:
    """The shared and resident bodies at the flow engine's shape and three
    flow spreads: against the plain twin (the band body's tolerances), bit
    for bit against the band body, then timed beside it and the twin; the
    bound is the band body's (the same function on the same inputs)."""
    import torch

    from deflicker_torch.ops.cuda import corr_kernel as C

    _, B, H, W, D, _ = CORR_CASES[0]
    rows = {"shared": [], "resident": []}
    for spread in CORR_SPREADS:
        f1, _, stored, coords = corr_case(B, H, W, D, spread, device)
        band = C.corr_lookup_cuda(f1, stored, coords)
        want = C.corr_lookup_plain(f1, stored, coords)
        scale = float(want.abs().max())
        flops, nbytes, dots = corr_counts(f1, stored, coords)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
        band_ms = cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords))
        plain_ms = cuda_ms(lambda: C.corr_lookup_plain(f1, stored, coords),
                           iters=5, warmup=1)
        for body in ("shared", "resident"):
            staged = torch.zeros(len(stored), dtype=torch.int32, device=device)
            got = C.corr_lookup_cuda(f1, stored, coords, body=body,
                                     staged=staged if body == "shared" else None)
            torch.cuda.synchronize()
            err, aerr = rel_err(got, want), abs_err(got, want)
            if not (err <= TOL_CORR_REL) or not (aerr <= TOL_CORR_ABS * scale):
                raise AssertionError(f"corr {body} +-{spread}: rel err {err}, "
                                     f"max abs {aerr} (x {scale})")
            if not torch.equal(got, band):
                raise AssertionError(f"corr {body} +-{spread}: output differs "
                                     "from the band body's")
            row = dict(body=body, spread=spread, B=B, pixels=H * W, D=D,
                       max_abs_err=aerr, rel_err=err, bit_equal_to_band=True,
                       ms=cuda_ms(lambda: C.corr_lookup_cuda(
                           f1, stored, coords, body=body)),
                       band_ms=band_ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       dots=dots)
            if body == "shared":
                blocks = -(-B * H * W // 8)
                row["staged_share_by_level"] = [int(n) / blocks
                                                for n in staged.tolist()]
                row["staged_share"] = sum(staged.tolist()) / (blocks * len(stored))
            else:
                row["resident_levels"] = list(C.resident_levels(
                    [tuple(lvl.shape[1:3]) for lvl in stored], D,
                    C.resident_capacity()))
                row["resident_capacity_bytes"] = C.resident_capacity()
            rows[body].append(row)
            print(f"[kernel] corr_{body} +-{spread}: {row}", flush=True)
    return rows


def library_chain_v(case, kind: str):
    """One bf16 batched `torch.matmul` chain over the video axis (the port
    never calls it): forward, or forward + autograd backward."""
    import torch

    xb = case["x"].to(torch.bfloat16)
    wb = [w.to(torch.bfloat16) for w in case["ws"]]
    bb = [b.to(torch.bfloat16)[:, None] for b in case["bs"]]

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
    return lambda: torch.autograd.grad(fwd(wr), wr, gb)


def phase_video_chain(device) -> dict:
    """Both chain pairs with a video axis (V = 3) at the single fit's two
    shapes: against the plain twins, bit-equal to V one-video launches, one
    V = 3 launch timed against 3 one-video launches and the batched library
    chain; bound = V x the one-video bound."""
    import torch

    from deflicker_torch.models.imlp import imlp_init, positional_encoding
    from deflicker_torch.atlas.engine import build_specs
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.ops.cuda import imlp_kernel as K

    cfg = AtlasConfig()
    specs = build_specs(cfg)
    gen = torch.Generator().manual_seed(3)
    rows = {k: [] for k in ("fwd_v", "bwd_v", "fwd_stash_v", "bwd_stash_v")}
    for name, spec, rows_n, need_dx in (
            ("mapping1", specs.mapping1, 9 * cfg.samples_batch, False),
            ("atlas", specs.atlas, 3 * cfg.samples_batch, True)):
        params = imlp_init(spec, gen, device, n_videos=VIDEOS)
        x = torch.rand((VIDEOS, rows_n, spec.input_dim), generator=gen) * 2 - 1
        x = x.to(device)
        if spec.use_positional:
            x = positional_encoding(x, spec.positional_dim)
        x = x.contiguous()
        g = torch.randn((VIDEOS, rows_n, spec.output_dim), generator=gen).to(device)
        ws = [p["w"].detach() for p in params]
        bs = [p["b"].detach().contiguous() for p in params]
        wb = [w.to(torch.bfloat16).contiguous() for w in ws]
        sk = tuple(spec.skip_layers)
        case = dict(x=x, ws=ws, bs=bs, g=g, skips=sk, need_dx=need_dx)
        one = [dict(x=x[v], ws=[w[v] for w in ws], bs=[b[v] for b in bs],
                    wb=[w[v] for w in wb], g=g[v]) for v in range(VIDEOS)]

        y = K.imlp_chain_fwd_cuda(x, wb, bs, sk)
        ys, stash = K.imlp_chain_fwd_stash_cuda(x, wb, bs, sk)
        grads = K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx)
        sgrads = K.imlp_chain_bwd_stash_cuda(x, wb, bs, sk, stash, g, need_dx)
        torch.cuda.synchronize()
        flat = lambda r: ([r[0]] if need_dx else []) + r[1] + r[2]
        same = torch.equal(y, ys) and all(
            torch.equal(a, b) for a, b in zip(flat(sgrads), flat(grads)))
        for v, o in enumerate(one):
            same = same and torch.equal(y[v], K.imlp_chain_fwd_cuda(
                o["x"], o["wb"], o["bs"], sk))
            r1 = K.imlp_chain_bwd_cuda(o["x"], o["wb"], o["bs"], sk, o["g"], need_dx)
            same = same and all(torch.equal(a[v], b)
                                for a, b in zip(flat(grads), flat(r1)))
        if not same:
            raise AssertionError(f"video-axis chain {name}: not bit-equal to the "
                                 "one-video launches")
        y_p = K.imlp_chain_fwd_plain(x, ws, bs, sk)
        g_p = K.imlp_chain_bwd_plain(x, ws, bs, sk, g, need_dx)
        stash_p = K.imlp_chain_fwd_stash_plain(x, ws, bs, sk)[1]
        errs_f = [rel_err(y, y_p)]
        errs_b = [rel_err(a, b) for a, b in zip(flat(grads), flat(g_p))]
        if not (max(errs_f) <= TOL_FWD) or not (max(errs_b) <= TOL_BWD):
            raise AssertionError(f"video-axis chain {name}: rel err "
                                 f"{max(errs_f)} / {max(errs_b)}")
        abs_f = abs_err(y, y_p)
        abs_b = max(abs_err(a, b) for a, b in zip(flat(grads), flat(g_p)))
        one_case = dict(x=x[0], ws=[w[0] for w in ws], bs=[b[0] for b in bs],
                        g=g[0], skips=sk, need_dx=need_dx)
        for key, kind, err, aerr, run, each, plain, counts in (
                ("fwd_v", "fwd", max(errs_f), abs_f,
                 lambda: K.imlp_chain_fwd_cuda(x, wb, bs, sk),
                 lambda: [K.imlp_chain_fwd_cuda(o["x"], o["wb"], o["bs"], sk)
                          for o in one],
                 lambda: K.imlp_chain_fwd_plain(x, ws, bs, sk), chain_counts),
                ("bwd_v", "bwd", max(errs_b), abs_b,
                 lambda: K.imlp_chain_bwd_cuda(x, wb, bs, sk, g, need_dx),
                 lambda: [K.imlp_chain_bwd_cuda(o["x"], o["wb"], o["bs"], sk,
                                                o["g"], need_dx) for o in one],
                 lambda: K.imlp_chain_bwd_plain(x, ws, bs, sk, g, need_dx),
                 chain_counts),
                ("fwd_stash_v", "fwd", max(errs_f), abs_f,
                 lambda: K.imlp_chain_fwd_stash_cuda(x, wb, bs, sk),
                 lambda: [K.imlp_chain_fwd_stash_cuda(o["x"], o["wb"], o["bs"], sk)
                          for o in one],
                 lambda: K.imlp_chain_fwd_stash_plain(x, ws, bs, sk), stash_counts),
                ("bwd_stash_v", "bwd", max(errs_b), abs_b,
                 lambda: K.imlp_chain_bwd_stash_cuda(x, wb, bs, sk, stash, g,
                                                     need_dx),
                 lambda: [K.imlp_chain_bwd_stash_cuda(
                     o["x"], o["wb"], o["bs"], sk, stash[v], o["g"], need_dx)
                     for v, o in enumerate(one)],
                 lambda: K.imlp_chain_bwd_stash_plain(x, ws, bs, sk, stash_p, g,
                                                      need_dx),
                 stash_counts)):
            flops, nbytes = counts(one_case, kind)
            t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
            rows[key].append(dict(
                shape=name, videos=VIDEOS, rows=int(rows_n), max_abs_err=aerr,
                rel_err=err, bit_equal_to_one_video=True, ms=cuda_ms(run),
                one_video_x3_ms=cuda_ms(each), plain_ms=cuda_ms(plain, iters=5),
                library_ms=cuda_ms(library_chain_v(case, kind)),
                bound_ms=VIDEOS * 1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes"))
            print(f"[kernel] {key} {name}: {rows[key][-1]}", flush=True)
    return rows


def phase_chunked(device):
    """The chunked long-video path through `run_pipeline`: a 170-frame clip
    past a cap of 80 (3 chunks of 57, starts 0, 57, 113), RAFT flow from the
    seeded random `.pth` with the resident correlation body, one V = 3 fit
    of the chunks (the video-axis chain pair, one launch per network and
    step), every frame rendered and refined."""
    from deflicker_torch.cli.pipeline import _chunk_starts
    from deflicker_torch.io.media import list_frames

    frames = WORK / "data_long" / "cliplong"
    make_clip(frames, seed=2, T=LONG_FRAMES)
    size, starts = _chunk_starts(LONG_FRAMES, LONG_CAP)
    if (size, starts) != (57, [0, 57, 113]):
        raise AssertionError(f"chunking {size} {starts}")
    solves = -(-(LONG_FRAMES - 1) // PAIR_BATCH)
    overrides = dict(maximum_number_of_frames=LONG_CAP,
                     pretrain_iter_number=PRETRAIN_MULTI)
    print(f"[chunked] {LONG_FRAMES} frames, cap {LONG_CAP} -> 3 chunks of {size} "
          f"at {starts}; DEFLICKER_CORR_RESIDENT=1, {solves} flow solves",
          flush=True)
    with env(DEFLICKER_CORR_RESIDENT="1"):
        out, launches, atlas_cfg = run_pipeline_checked(
            device, "chunked", frames, WORK / "results_long",
            WORK / "raft-random.pth", ITERS_MULTI, psnr_floor=None,
            overrides=overrides, n_frames=LONG_FRAMES, pair=("fwd_v", "bwd_v"))
    want = RAFT_ITERS * solves
    if launches["lookup_resident"] != want or launches["lookup"] \
            or launches["lookup_shared"]:
        raise AssertionError(f"corr launches {launches}, want {want} resident")
    if launches["fwd"] or launches["bwd"] or out["chunks"] != 3:
        raise AssertionError(f"chunked run: {launches}, {out.get('chunks')} chunks")
    s1 = WORK / "results_long" / frames.name / "stage_1"
    names = [p.name for p in list_frames(s1 / "output")]
    if names != [f"{t:05d}.png" for t in range(LONG_FRAMES)]:
        raise AssertionError("stage-1 frames are not numbered 0..169")
    print("[chunked] " + json.dumps({
        "chunks": out["chunks"], "video_iters_per_sec": out["iters_per_sec"],
        "solves": solves, "lookup_resident": launches["lookup_resident"],
        "fwd_v": launches["fwd_v"], "bwd_v": launches["bwd_v"]}), flush=True)
    return launches, frames, atlas_cfg


def phase_multi_profile(device, frames: Path, atlas_cfg, steps: int = 40) -> None:
    """Where a V = 3 group step's time goes: the three chunks of the
    chunked phase, `steps` steps timed plain, then under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas import build_specs, load_video_data
    from deflicker_torch.atlas.multifit import (fit_atlas_multi,
                                                init_models_multi,
                                                stack_video_data)
    from deflicker_torch.cli.pipeline import _chunk_starts

    size, starts = _chunk_starts(LONG_FRAMES, LONG_CAP)
    H, W = CLIP[1] // 4, CLIP[2] // 4
    data_v = stack_video_data([load_video_data(frames, H, W, size, start_frame=s)
                               for s in starts], device)
    cfg = dataclasses.replace(atlas_cfg, iters_num=steps, steps_per_call=steps,
                              evaluate_every=10 ** 9)
    specs = build_specs(cfg)
    params = init_models_multi(specs, torch.Generator().manual_seed(0),
                               len(starts), device)
    gen = torch.Generator(device=device).manual_seed(0)
    fit_atlas_multi(params, specs, data_v, dataclasses.replace(cfg, iters_num=5), gen)
    torch.cuda.synchronize()
    t0 = time.time()
    fit_atlas_multi(params, specs, data_v, cfg, gen)
    torch.cuda.synchronize()
    wall_plain = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fit_atlas_multi(params, specs, data_v, cfg, gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
    report_profile("multi-profile", "step", steps, wall_plain, wall, prof)
    print(f"[multi-profile] {len(starts)} videos: "
          f"{len(starts) * steps / wall_plain:.2f} video-steps/s", flush=True)


def phase_batch(device):
    """The batch CLI's group mode (`cli.batch --parallel_fit`, its parser and
    `run_batch_parallel`) on two 80-frame clips: RAFT flow with the shared
    correlation body, one V = 2 fit through the video-axis stash pair
    (DEFLICKER_IMLP_STASH=1), stage 2 through `run_multi`; PSNR and E_warp
    of each output, every output frame written per video."""
    import torch

    from deflicker_torch.cli import batch
    from deflicker_torch.cli.evaluate import compute_video_metrics
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.io.media import list_frames

    root = WORK / "data_batch"
    names = ("clipa", "clipb")
    for k, name in enumerate(names):
        make_clip(root / name, seed=3 + k)
    # the CLI's own parser; `main` would build this AtlasConfig from
    # --config / --iters
    argv = ["--videos", *(str(root / n) for n in names), "--parallel_fit",
            "--root", str(root), "--results_root", str(WORK / "results_batch"),
            "--ckpt_raft", str(WORK / "raft-random.pth"),
            "--ckpt_filter", str(ROOT / "pretrained_weights" / "neural_filter.ckpt"),
            "--ckpt_local", str(ROOT / "pretrained_weights" /
                                "local_refinement_net.ckpt")]
    args = batch.build_parser().parse_args(argv)
    atlas_cfg = dataclasses.replace(AtlasConfig(), iters_num=ITERS_MULTI,
                                    evaluate_every=ITERS_MULTI - 1,
                                    pretrain_iter_number=PRETRAIN_MULTI)
    solves = len(names) * -(-(CLIP[0] - 1) // PAIR_BATCH)
    print(f"[batch] cli.batch {' '.join(argv)}; DEFLICKER_CORR_SHARED=1, "
          f"DEFLICKER_IMLP_STASH=1; cut: iters_num 10001 -> {ITERS_MULTI}, "
          f"pretrain_iter_number 100 -> {PRETRAIN_MULTI}", flush=True)
    with env(DEFLICKER_CORR_SHARED="1", DEFLICKER_IMLP_STASH="1"):
        torch.cuda.reset_peak_memory_stats(device)
        reset_counters()
        summary = batch.run_batch_parallel(args.videos, args, atlas_cfg,
                                           device=device)
        launches = read_counters()
    peak = torch.cuda.max_memory_allocated(device)
    calls = 2 * ITERS_MULTI
    if launches["lookup_shared"] != RAFT_ITERS * solves or launches["lookup"] \
            or launches["lookup_resident"]:
        raise AssertionError(f"corr launches {launches}, want "
                             f"{RAFT_ITERS * solves} shared")
    if launches["fwd_stash_v"] != calls or launches["bwd_stash_v"] != calls \
            or launches["fwd_stash"] or launches["fwd_v"]:
        raise AssertionError(f"chain launches {launches}, want {calls} stash_v")
    metrics = {}
    for name in names:
        res = WORK / "results_batch" / name
        for sub in ("stage_1/output", "neural_filter/output", "final/output"):
            if len(list_frames(res / sub)) != CLIP[0]:
                raise AssertionError(f"{name}/{sub}: not {CLIP[0]} frames")
        m = compute_video_metrics(root / name, res / "final" / "output",
                                  device=device)
        rec = next(r for r in summary["per_video"] if r["video"] == name)
        metrics[name] = {"psnr": rec["psnr"], "final_psnr": m["psnr_mean"],
                         "final_ewarp": m.get("ewarp_mean")}
        if not all(v is not None and math.isfinite(v) for v in metrics[name].values()):
            raise AssertionError(f"{name}: metrics {metrics[name]}")
    print("[batch] " + json.dumps({
        **{k: v for k, v in summary.items() if k != "per_video"},
        "metrics": metrics, "launches": launches, "peak_mem_gib": peak / 2 ** 30,
        "solves": solves}), flush=True)
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
    t_start = time.time()
    logs = build.build(["imlp_chain", "corr_lookup"], verbose=True)
    print(f"[build] nvcc {time.time() - t0:.1f} s", flush=True)
    print_build(logs)

    rows = phase_chain_kernels(device)
    stash_rows = phase_stash_kernels(device)
    corr_rows = phase_corr_kernel(device)
    body_rows = phase_corr_bodies(device)
    video_rows = phase_video_chain(device)
    t1 = time.time()
    launches, frames, atlas_cfg = phase_pipeline(device)
    print(f"[pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_profile(device, frames, atlas_cfg)
    t1 = time.time()
    raft_launches = phase_raft_pipeline(device, frames)
    print(f"[raft-pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_raft_profile(device, frames)
    t1 = time.time()
    dual_launches, dual_frames, dual_cfg = phase_dual_pipeline(device)
    print(f"[dual-pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_dual_profile(device, dual_frames, dual_cfg)
    t1 = time.time()
    long_launches, long_frames, long_cfg = phase_chunked(device)
    print(f"[chunked] wall {time.time() - t1:.1f} s", flush=True)
    phase_multi_profile(device, long_frames, long_cfg)
    t1 = time.time()
    batch_launches = phase_batch(device)
    print(f"[batch] wall {time.time() - t1:.1f} s", flush=True)

    src = "deflicker_torch/csrc/imlp_chain.cu"
    replaces = {"fwd": "deflicker_tpu/ops/pallas/imlp_kernel.py:421",
                "bwd": "deflicker_tpu/ops/pallas/imlp_kernel.py:470",
                "fwd_stash": "deflicker_tpu/ops/pallas/imlp_kernel.py:514",
                "bwd_stash": "deflicker_tpu/ops/pallas/imlp_kernel.py:547"}
    kernels = []
    for kind in ("fwd", "bwd", "fwd_stash", "bwd_stash"):
        # one fit step's calls summed: mapping1 + atlas of the single fit for
        # the remat pair (launches of the Farneback run), the four networks
        # of the dual fit for the stash pair (launches of the dual run), at
        # the shapes of a step with global rigidity; `per_shape` and the
        # error cover the later, smaller mapping calls too
        stashed = kind.endswith("_stash")
        every = (stash_rows if stashed else rows)[kind]
        r = [x for x in every if x.get("with_global", True)]
        kernels.append({
            "name": f"imlp_chain_{kind}", "route": "cuda", "source": src,
            "replaces": replaces[kind],
            "launches": (dual_launches if stashed else launches)[kind],
            "max_abs_err": max(x["max_abs_err"] for x in every),
            "ms": sum(x["ms"] for x in r),
            "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": "operations" if all(x["bound_by"] == "operations"
                                            for x in r) else "bytes",
            "library_ms": sum(x["library_ms"] for x in r),
            "per_shape": every,
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
    # the other two bodies, at the same shape and flow (+-3 px); launches of
    # the batch phase (shared) and of the chunked phase (resident)
    for body, row, launched in (("shared", 6, batch_launches["lookup_shared"]),
                                ("resident", 7, long_launches["lookup_resident"])):
        every = body_rows[body]
        r = next(x for x in every if x["spread"] == 3.0)
        kernels.append({
            "name": f"corr_lookup_{body}", "route": "cuda",
            "source": "deflicker_torch/csrc/corr_lookup.cu",
            "replaces": "deflicker_tpu/ops/pallas/corr_kernel.py:"
                        + ("459" if body == "shared" else "571"),
            "launches": launched,
            "max_abs_err": max(x["max_abs_err"] for x in every),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None, "per_shape": every,
        })
    # the chain pairs with a video axis (V = 3, mapping1 + atlas summed);
    # launches of the chunked phase (remat) and of the batch phase (stash)
    for kind in ("fwd", "bwd", "fwd_stash", "bwd_stash"):
        r = video_rows[kind + "_v"]
        launched = (batch_launches if "stash" in kind else long_launches)[kind + "_v"]
        kernels.append({
            "name": f"imlp_chain_{kind}_v", "route": "cuda", "source": src,
            "replaces": replaces[kind], "form": f"video axis, V = {VIDEOS}",
            "launches": launched,
            "max_abs_err": max(x["max_abs_err"] for x in r),
            "ms": sum(x["ms"] for x in r),
            "plain_ms": sum(x["plain_ms"] for x in r),
            "bound_ms": sum(x["bound_ms"] for x in r),
            "bound_by": "operations" if all(x["bound_by"] == "operations"
                                            for x in r) else "bytes",
            "library_ms": sum(x["library_ms"] for x in r),
            "one_video_x3_ms": sum(x["one_video_x3_ms"] for x in r),
            "per_shape": r,
        })
    print(f"[total] wall {time.time() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
