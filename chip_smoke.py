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
     D = 256, four levels, flows of +-3, +-0.5 and +-40 px, and a ragged
     7 x 9, D = 32 case) for the band body of the correlation kernel (each
     window one mma.sync product), two calls bit-equal — held against its
     plain PyTorch twin, then timed beside its bound (and the window bytes
     it reads), the plain twin and, where
     one PyTorch call computes the same function, that call; each backward
     also piece by piece (recompute, reverse pass, dW GEMM, reduction; the
     recompute at the dual fit's shapes too);
  3. the pipeline with Farneback flow: `deflicker_torch.cli.pipeline
     .run_pipeline` on a procedural flickering clip of 80 frames at 432x768,
     at the default AtlasConfig widths and batch with the shipped stage-2
     weights; only `iters_num` is cut.  The launch counters are zeroed just
     before and read just after, and the outputs are checked; every
     pipeline phase prints its peak device memory, also by stage;
  4. profile: 40 more fit steps of the same clip, timed plain and then under
     torch.profiler — device-busy time per step, idle share, top kernels —
     eager and captured as CUDA graphs (the pipeline runs captured), and a
     sweep of the mapping's pretrain steps the same way; then
     the captured fit against the eager one: configuration 1's pretrain
     (10 sweeps) and 300 fit steps across global rigidity's stop, both ways
     from one seed, bit-equal in params, Adam state, chunk logs and
     generator states, with each way's it/s, graphs and peak memory;
  5. the pipeline with RAFT flow: a seeded random RAFT saved as a `.pth`
     with the reference's keys, found by `make_flow_provider`, on a fresh
     copy of the clip: 79 pairs in batches of 4 pairs x 2 directions, 20 GRU
     iterations, bf16, the correlation kernel in every iteration; the fit is
     cut deeper.  Counters zeroed before, read after; flow files, artifacts
     and metrics checked for shape and finiteness (untrained weights give
     noise for flow, so no quality floor applies);
  6. profile of one RAFT batch (8 x 432 x 768, 20 iterations), once with
     each correlation body;
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
     pair, same seeds, in the order stash, remat, remat, stash, each eager
     and captured;
  9. the two other correlation bodies at the flow engine's shape (8 x 54 x
     96, D = 256, four levels) and flows of +-0.5, +-3 and +-40 px: one
     tensor-core kernel over 8 x 8 pixel tiles, the shared body (each tile's
     union window staged by TMA) and the resident body (level 3 held whole
     in shared memory) against the plain twin and the band body, two calls
     bit-equal, shared and resident bit-equal at every spread, every tile staged
     at +-0.5 and +-3; timed beside the band body, with the share of staged
     tiles (counted and predicted) and the resident levels;
 10. the chain kernels with a video axis, V = 3 at the single fit's shapes,
     both pairs: against the twins, bit-equal to V one-video launches, one
     V = 3 launch timed against 3 one-video launches;
 11. the chunked long-video path: `run_pipeline` on a 170-frame clip with
     `maximum_number_of_frames` 80 (3 chunks of 57, the last anchored back
     one frame), RAFT flow with DEFLICKER_CORR_RESIDENT=1, one V = 3 fit of
     the three chunks at the default widths and batch, every frame rendered,
     stage 2 over all 170 frames; then 40 profiled steps of that group fit,
     eager and captured;
 12. the batch CLI's group mode (`cli.batch --parallel_fit`) on two 80-frame
     clips: RAFT flow with DEFLICKER_CORR_SHARED=1, one V = 2 fit with
     DEFLICKER_IMLP_STASH=1, stage 2 through `FilterEngine.run_multi`;
 13. warm serving: one `Deflickerer` on the card (the seeded random RAFT
     `.pth`, stage-2 weights read from `.pth` files written here from the
     shipped `.ckpt` in the reference's layout) answers four job lines
     through `cli.serve.serve_lines`: two 40-frame clips, the first again
     with another seed (traced by DEFLICKER_PROFILE), and a line with an
     unknown key; weights load once, no kernel library is built or loaded
     after the first job, no CUDA graph is captured after it (the fit's
     graphs are kept by shape), and every job's launches are counted; the
     memory the kept states hold is freed when they are dropped; then
     `cli.evaluate.main` and `cli.stage2.main` on the second clip;
 14. stage-2 training: `cli.train_stage2.main` at the published widths and
     the JAX CLI's defaults (UNet 32 features, TransformNet nf 32 with 5
     blocks, 128x128, batch 8, clips 2 x 6, lr 2e-4 constant, bf16, seed
     0) with the serve phase's second clip as texture bank, only the
     schedule cut (200 filter and 100 refiner steps, chunks of 25); no
     chain or lookup kernel may launch, and each net's steps must be one
     CUDA graph a clip kind: two captures, two warm-up steps a kind, every
     other step one replay.  Every chunk's losses finite, each net's last
     chunk below its first, the checkpoints loaded by `load_filter_engine`
     and run by `cli.stage2.main` on the serve phase's second clip;
     steps/s; then each net captured against eager (`FitGraphs(eager=
     True)`) from one seed and bank, three chunks of 20 filter or 10
     refiner steps a route (warm-up and captures, timed, under
     torch.profiler), params bit-equal after them, each route's wall and
     device ms a step, idle share, device ops, steps/s and graphs; then
     held-out quality of the shipped weights on 8 procedural clips of
     12x128x128 (`filter_frames`, `refine_sequence`): filtered PSNR at
     least input + 10 dB, refined temporal error below the input's;
 15. parallel (`deflicker_torch.parallel` on the one card): first the chain
     pairs at one rank's shapes (5,000 and 2,500 samples a step: 2 and 4
     ranks) and the band lookup at one rank's block of a pair batch (4 and
     3 directions), each against its plain twin; (a) the sharded fit at
     world size 1 under NCCL (configuration 1's data at 108x192, default
     widths and batch, 100 steps after 10 pretrain sweeps), captured as
     CUDA graphs and eager, bit-equal to the captured unsharded fit from
     the same seed, all three timed after 5 warm-up steps (cuBLAS, NCCL's
     communicator), the all-reduce of the fit's gradients timed alone, and
     20 steps of each way under torch.profiler (the all-reduce's device
     ms inside the captured step's graph), and
     how far Adam's first update moves when one draw's gradient is summed
     from two halves and when it comes from half the draw; (b) configuration 1's pipeline on two
     ranks sharing the card under gloo (`parallel.launch`; NCCL refuses two
     ranks a card): RAFT flow from the seeded random `.pth` with each pair
     batch split, 100 fit steps with the sample batch split, the render's
     and the U-Net's frames split; each rank's counters must read 200 + 200
     chain launches and 20 batches x 20 lookups; the two ranks' fit
     params must be bit-equal, and against one rank on the same flow they
     must lie, after the first logged step, within 1e-2 of that step's
     update (Frobenius), the first step's loss within rtol 1e-5 and the
     stage-1 and final PSNR within 0.1 dB; every flow file within relative Frobenius 1e-2 of the
     raft phase's one-rank solve with the same weights; (c) `cli.batch --dcn` as two
     processes meeting at a local coordinator, the serve phase's two
     40-frame clips, one each: hello lines, disjoint outputs.  Spawned
     ranks and processes have a timeout; any failure fails the run.
Kernel, plain and library times are device times (`cuda_ms`: each run
queued behind a sleep kernel, so no host work is inside the events);
`call_ms` beside a kernel's is one call from an idle device, the wrapper's
host work included, as earlier versions of this script timed every kernel.
Each pipeline phase zeroes the launch counters just before it and reads
them just after.  The fits and pretrains of every phase, and phase 14's
training steps, run as CUDA graphs (deflicker_torch/atlas/graphs.py)
except the sample-sharded fits under gloo (phase 15b) and the eager runs
they are compared with, and a replayed step counts its launches as an
eager one does.  The second-to-last line is the kernel table as JSON, the
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
ITERS_GRAPH = 300           # fit steps of the captured-against-eager phase
PRETRAIN_GRAPH = 10         # pretrain sweeps there (default 100)
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
SERVE_FRAMES = 40            # the serve phase's clips
ITERS_SERVE = 100           # fit steps of each served job
PRETRAIN_SERVE = 25         # pretrain sweeps there (default 100)
CORR_SPREADS = (0.5, 3.0, 40.0)
VIDEOS = 3                  # video axis of the batched chain phase
TRAIN_SHAPE = {"size": 128, "batch": 8, "clip_len": 6, "clip_batch": 2}  # the CLI's defaults
TRAIN_FILTER_STEPS = 200    # stage-2 training: filter steps (CLI default 4000)
TRAIN_REFINE_STEPS = 100    # refiner steps (CLI default 1500)
TRAIN_PER_CALL = 25         # steps a chunk (CLI default 50)
TRAIN_WINDOW = {"filter": 20, "refiner": 10}  # steps a window, captured vs eager
HELDOUT = (8, 12, 128, 128)  # held-out clips x frames x height x width
HELDOUT_SEED = 10_000       # their generator's seed (no training stream uses it)
SLEEP_CYCLES = 4_000_000    # cuda_ms's sleep kernel: about 2 ms at the H100's clocks
RANKS = 2                   # the parallel phase's ranks on the one card
ITERS_PAR = 100             # fit steps of its world-1 and two-rank runs
PROFILE_PAR = 20            # profiled steps of each world-1 fit
PRETRAIN_PAR = 10           # pretrain sweeps there (default 100)
ITERS_DCN = 50              # fit steps of each --dcn process
PAR_TIMEOUT = 600           # seconds a spawned rank or process may take
# two ranks against one: after the fit's first logged step the params
# apart by at most this share of how far that step moved them (the ranks'
# partial sums round differently, which flips the sign of an Adam step
# only where a gradient is at rounding level; a gradient from the wrong
# samples or one rank's half flips it for many components); and each RAFT
# flow file apart by at most this relative Frobenius error from the
# one-rank solve (a pair gathered into the wrong place is another pair's
# flow).  The final params are reported, not bounded: over 100 Adam steps
# rounding-level differences grow to a share of the fit's movement.
FIT_RTOL_PAR = 1e-2
FLOW_RTOL_PAR = 1e-2


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5, host: bool = False) -> float:
    """Median device time of fn() over `iters` runs, by CUDA events.  Each
    run waits in the queue behind a sleep kernel of about 2 ms, so the host
    has issued all of fn's launches before the first one starts: the time
    is the device's alone.  host=True: no sleep kernel, so the time of one
    call from an idle device, the wrapper's host work (checks, descriptors,
    tensor maps, the launch) included, as earlier versions timed every kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if not host:
            torch.cuda._sleep(SLEEP_CYCLES)
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


def kernel_shapes(device, samples=None):
    """The two chain calls of one fit step at the default AtlasConfig (or
    at `samples` a step: one rank's block of a sharded fit's batch)."""
    import torch

    from deflicker_torch.atlas.engine import build_specs
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.models.imlp import imlp_init, positional_encoding

    cfg = AtlasConfig()
    specs = build_specs(cfg)
    samples = samples or cfg.samples_batch
    gen = torch.Generator().manual_seed(0)
    out = []
    # mapping1: 9 coordinate variants x 10,000 samples, no encoding, no dx
    # needed; atlas: 3 variants x 10,000, PE 10 of 2-D uv, dx needed
    for name, spec, rows, need_dx in (
            ("mapping1", specs.mapping1, 9 * samples, False),
            ("atlas", specs.atlas, 3 * samples, True)):
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


def piece_times(K, x, wb, bs, sk, g, need_dx, stash=None, names=None) -> dict:
    """CUDA-event times of the launches of one backward call, each run alone
    on a scratch that a whole call filled: the recompute (remat only), the
    reverse pass, the dW GEMM and the reduction (or only `names`)."""
    launch = K.bwd_piece_launcher(x, wb, bs, sk, g, need_dx, stash)
    if names is None:
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
    from deflicker_torch.ops.cuda import corr_kernel

    for (kname, D), (regs, local, smem) in corr_kernel.kernel_attrs().items():
        extra = " besides resident levels" if kname == "corr_lookup_tc_kernel" else ""
        print(f"[build] corr_lookup {kname} D={D}: {regs} registers, {local} local "
              f"bytes a thread, {smem} shared bytes a block{extra}", flush=True)


def phase_chain_kernels(device, samples=None, tag="kernel") -> dict:
    import torch

    from deflicker_torch.ops.cuda import imlp_kernel as K

    cases = kernel_shapes(device, samples)
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
                ms=cuda_ms(run), call_ms=cuda_ms(run, host=True), plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library_chain(case, kind)),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9))
            if kind == "bwd":
                rows[kind][-1]["pieces_ms"] = piece_times(K, x, wb, bs, sk, g, need_dx)
            print(f"[{tag}] {kind} {case['name']}: {rows[kind][-1]}", flush=True)
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
                ms=cuda_ms(run), call_ms=cuda_ms(run, host=True), remat_ms=cuda_ms(remat),
                plain_ms=cuda_ms(plain),
                library_ms=cuda_ms(library_stash_chain(case, kind)),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6,
                stash_mbytes=stash.numel() * 2 / 1e6))
            if kind == "bwd":
                # the stash backward's launches, and the remat backward's
                # recompute (the forward template without its output layer)
                rows[key][-1]["pieces_ms"] = {
                    **piece_times(K, x, wb, bs, sk, g, need_dx, stash),
                    **piece_times(K, x, wb, bs, sk, g, need_dx, names=("recompute",))}
            print(f"[kernel] {key} {name}: {rows[key][-1]}", flush=True)
    return rows


# (name, B, H, W, D, flow spread in 1/8-resolution pixels): the flow engine's
# lookup for the clip (pair_batch 4 x 2 directions, 432x768 / 8) with windows
# mostly inside the levels (+-3, +-0.5), the same with windows partly and
# wholly outside, and a ragged case whose last level is empty
CORR_CASES = (("engine+-3", 2 * PAIR_BATCH, CLIP[1] // 8, CLIP[2] // 8, 256, 3.0),
              ("engine+-0.5", 2 * PAIR_BATCH, CLIP[1] // 8, CLIP[2] // 8, 256, 0.5),
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


def corr_bound(f1, stored, coords) -> dict:
    """The lookup's least time on the H100 from these inputs: the larger of
    its bytes over the HBM rate and its operations at the rates they can
    run at — each needed dot exactly on the tensor cores (f2 is bf16, f32
    f1 three bf16 terms: 3 x 2 D flop a dot at the bf16 peak) and the 7 flop
    of each output's combination at the f32 peak.  `bound_f32_ms` is the
    bound of PRs 2-6 (every flop at the f32 peak outside the tensor cores)."""
    flops, nbytes, dots = corr_counts(f1, stored, coords)
    B, H, W, D = f1.shape
    n_out = B * H * W * len(stored) * 81
    t_ops = 3 * 2.0 * D * dots / PEAK_BF16_FLOPS + 7.0 * n_out / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_f32_ms=1e3 * max(flops / PEAK_F32_FLOPS, t_bytes),
                gflop=flops / 1e9, mbytes=nbytes / 1e6, dots=dots)


def phase_corr_kernel(device, cases=CORR_CASES, tag="kernel") -> list:
    """The band body against its plain twin, two calls bit-equal, then its
    time beside its bound, the twin and (for information: no single PyTorch
    call computes this function) the materialized path's volume build and
    lookup; beside the bound, the window bytes the per-pixel design reads
    through L1 (needed dots x 2 D)."""
    import torch

    from deflicker_torch.models import raft as R
    from deflicker_torch.ops.cuda import corr_kernel as C

    rows = []
    for name, B, H, W, D, spread in cases:
        f1, f2, stored, coords = corr_case(B, H, W, D, spread, device)
        got = C.corr_lookup_cuda(f1, stored, coords)
        again = C.corr_lookup_cuda(f1, stored, coords)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"corr {name}: two calls differ")
        want = C.corr_lookup_plain(f1, stored, coords)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"corr {name}: shape {tuple(got.shape)} or "
                                 "non-finite values")
        err, aerr, scale = rel_err(got, want), abs_err(got, want), float(want.abs().max())
        if not (err <= TOL_CORR_REL) or not (aerr <= TOL_CORR_ABS * scale):
            raise AssertionError(f"corr {name}: rel err {err} (<= {TOL_CORR_REL}), "
                                 f"max abs {aerr} (<= {TOL_CORR_ABS} x {scale})")
        row = dict(shape=name, B=B, pixels=H * W, D=D, max_abs_err=aerr,
                   rel_err=err, zero_share=float((want == 0).float().mean()),
                   ms=cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords)),
                   call_ms=cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords), host=True),
                   plain_ms=cuda_ms(lambda: C.corr_lookup_plain(f1, stored, coords)),
                   library_ms=None, **corr_bound(f1, stored, coords))
        row["window_bytes"] = 2.0 * D * row["dots"]
        # the materialized mode on the same inputs (f32 volume): what a solve
        # pays once (build) and per iteration (lookup) without the kernel
        row["materialized_build_ms"] = cuda_ms(
            lambda: R.build_corr_pyramid(f1, f2), iters=10, warmup=2)
        volume = R.build_corr_pyramid(f1, f2)
        row["materialized_lookup_ms"] = cuda_ms(lambda: R.corr_lookup(volume, coords))
        del volume
        rows.append(row)
        print(f"[{tag}] corr {name}: {row}", flush=True)
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


@contextlib.contextmanager
def stage_peaks(device):
    """Peak device memory by stage of a pipeline run: the flow, the
    pretrains, the fit (a group's pretrain and fit together), the renders
    and stage 2 (a render inside the fit counts for both); yields a dict
    that also gets "all", the run's peak."""
    import torch

    import deflicker_torch.atlas.multifit as multifit
    import deflicker_torch.cli.pipeline as pipeline

    stages = {"flow": (pipeline, "preprocess_optical_flow"),
              "pretrain": (pipeline, "pretrain_mapping"),
              "fit": (pipeline, "fit_atlas"),
              "group_fit": (multifit, "fit_group"),
              "render": (pipeline, "evaluate_and_save"),
              "group_render": (multifit, "save_group"),
              "stage2": (pipeline, "run_stage2")}
    peaks = {"all": 0}
    active = ["all"]            # the stages running, outermost first

    def credit() -> None:
        """The peak since the last reset, to every running stage."""
        torch.cuda.synchronize(device)
        p = torch.cuda.max_memory_allocated(device)
        for name in active:
            peaks[name] = max(peaks.get(name, 0), p)
        torch.cuda.reset_peak_memory_stats(device)

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            credit()
            active.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                credit()
                active.pop()
        return wrapper

    saved = {name: getattr(m, a) for name, (m, a) in stages.items()}
    for name, (m, a) in stages.items():
        setattr(m, a, wrap(name, saved[name]))
    try:
        yield peaks
    finally:
        for name, (m, a) in stages.items():
            setattr(m, a, saved[name])
        credit()


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
    with stage_peaks(device) as peaks:
        out = run_pipeline(cfg, atlas_cfg, device=device)
    launches = read_counters()
    peak = peaks.pop("all")

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
                   stage_peak_gib={k: v / 2 ** 30 for k, v in peaks.items()},
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


def profile_fit(device, tag: str, fit, steps: int) -> dict:
    """Where a fit step's time goes, eager and captured side by side:
    `fit(n, graphs)` runs n more steps of one fit (5 to warm up, `steps`
    timed plain, `steps` under torch.profiler).  The captured runs share one
    kept `FitGraphs`, so their timed and profiled windows only replay; each
    run's launches and peak device memory are printed.  Returns each
    mode's plain wall seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas.graphs import FitGraphs

    walls = {}
    for mode in ("eager", "captured"):
        graphs = FitGraphs(keep=True, eager=mode == "eager")
        fit(5, graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counters()
        t0 = time.time()
        fit(steps, graphs)
        torch.cuda.synchronize()
        wall_plain = time.time() - t0
        peak = torch.cuda.max_memory_allocated(device)
        launches = {k: v for k, v in read_counters().items() if v}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fit(steps, graphs)
            torch.cuda.synchronize()
            wall = time.time() - t0
        print(f"[{tag}-{mode}] launches {launches}, peak memory "
              f"{peak / 2 ** 30:.3f} GiB", flush=True)
        report_profile(f"{tag}-{mode}", "step", steps, wall_plain, wall, prof)
        walls[mode] = wall_plain
    return walls


def phase_dual_profile(device, frames: Path, atlas_cfg, steps: int = 20) -> None:
    """Where a dual fit step's time goes, with the stash pair and with the
    remat pair, each eager and captured (`profile_fit`): the same data,
    init and sample seeds for all, in the order stash, remat, remat, stash
    so that run order does not decide between them."""
    import torch

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data)

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
            profile_fit(device, f"dual-profile-{mode}", lambda n, g: fit_atlas(
                params, specs, data, dataclasses.replace(cfg, iters_num=n), gen,
                graphs=g), steps)


def phase_corr_bodies(device) -> dict:
    """The shared and resident bodies (the tensor-core kernel) at the flow
    engine's shape and three flow spreads: against the plain twin (the band
    body's tolerances) and the band body; two calls bit-equal; shared and
    resident bit-equal (at +-40 levels 0-1 take the band body's products in
    both); at +-0.5 and +-3 every tile of every level staged.  Then timed
    beside the band body and the twin, with the share of staged tiles by
    level (the kernel's counters, and `tile_plan`'s prediction) and the
    resident levels."""
    import torch

    from deflicker_torch.ops.cuda import corr_kernel as C

    _, B, H, W, D, _ = CORR_CASES[0]
    rows = {"shared": [], "resident": []}
    for spread in CORR_SPREADS:
        f1, _, stored, coords = corr_case(B, H, W, D, spread, device)
        shapes = [tuple(lvl.shape[1:3]) for lvl in stored]
        band = C.corr_lookup_cuda(f1, stored, coords)
        want = C.corr_lookup_plain(f1, stored, coords)
        scale = float(want.abs().max())
        bound = corr_bound(f1, stored, coords)
        band_ms = cuda_ms(lambda: C.corr_lookup_cuda(f1, stored, coords))
        plain_ms = cuda_ms(lambda: C.corr_lookup_plain(f1, stored, coords),
                           iters=5, warmup=1)
        outs = {}
        for body in ("shared", "resident"):
            staged = torch.zeros(len(stored), dtype=torch.int32, device=device)
            got = C.corr_lookup_cuda(f1, stored, coords, body=body,
                                     staged=staged if body == "shared" else None)
            again = C.corr_lookup_cuda(f1, stored, coords, body=body)
            torch.cuda.synchronize()
            err, aerr = rel_err(got, want), abs_err(got, want)
            if not (err <= TOL_CORR_REL) or not (aerr <= TOL_CORR_ABS * scale):
                raise AssertionError(f"corr {body} +-{spread}: rel err {err}, "
                                     f"max abs {aerr} (x {scale})")
            if not torch.equal(got, again):
                raise AssertionError(f"corr {body} +-{spread}: two calls differ")
            outs[body] = got
            row = dict(body=body, spread=spread, B=B, pixels=H * W, D=D,
                       max_abs_err=aerr, rel_err=err,
                       rel_err_to_band=rel_err(got, band),
                       max_abs_to_band=abs_err(got, band),
                       ms=cuda_ms(lambda: C.corr_lookup_cuda(
                           f1, stored, coords, body=body)),
                       call_ms=cuda_ms(lambda: C.corr_lookup_cuda(
                           f1, stored, coords, body=body), host=True),
                       band_ms=band_ms, plain_ms=plain_ms, library_ms=None,
                       **bound)
            if body == "shared":
                tiles = B * -(-H // 8) * -(-W // 8)
                plan = C.tile_plan(coords, shapes)
                row["staged_share_by_level"] = [int(n) / tiles
                                                for n in staged.tolist()]
                row["predicted_share_by_level"] = [
                    float(x) for x in plan.flatten(1).float().mean(1).tolist()]
                if staged.tolist() != [int(n) for n in plan.flatten(1).sum(1).tolist()]:
                    raise AssertionError(f"corr shared +-{spread}: staged {staged.tolist()}"
                                         " differs from the tile plan")
                if spread <= 3.0 and row["staged_share_by_level"] != [1.0] * len(stored):
                    raise AssertionError(f"corr shared +-{spread}: staged share "
                                         f"{row['staged_share_by_level']}, want 1.0")
            else:
                row["resident_capacity_bytes"] = C.resident_capacity()
                row["resident_levels"] = list(C.resident_levels(
                    shapes, D, row["resident_capacity_bytes"]))
            rows[body].append(row)
        same = bool(torch.equal(outs["shared"], outs["resident"]))
        if not same:
            raise AssertionError(f"corr +-{spread}: shared and resident differ")
        for body in ("shared", "resident"):
            rows[body][-1]["bit_equal_shared_resident"] = same
            print(f"[kernel] corr_{body} +-{spread}: {rows[body][-1]}", flush=True)
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
                call_ms=cuda_ms(run, host=True),
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
    """Where a V = 3 group step's time goes, eager and captured: the three
    chunks of the chunked phase (`profile_fit`)."""
    import torch

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
    walls = profile_fit(device, "multi-profile", lambda n, g: fit_atlas_multi(
        params, specs, data_v, dataclasses.replace(cfg, iters_num=n), gen,
        graphs=g), steps)
    for mode, wall in walls.items():
        print(f"[multi-profile-{mode}] {len(starts)} videos: "
              f"{len(starts) * steps / wall:.2f} video-steps/s", flush=True)


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


def write_stage2_pth(folder: Path) -> tuple:
    """`neural_filter.pth` and `local_refinement_net.pth` in the reference's
    layout, from the shipped `.ckpt`: the modules' state dicts under
    DataParallel's `module.` keys, and in the TransformNet's file the
    running stats of an InstanceNorm the reference saves and never applies."""
    import torch

    from deflicker_torch.models.refine import TransformNet
    from deflicker_torch.models.unet import UNet
    from deflicker_torch.utils.convert import load_stage2_module

    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for module, name in ((UNet(), "neural_filter"),
                         (TransformNet(), "local_refinement_net")):
        sd = load_stage2_module(module, ROOT / "pretrained_weights"
                                / f"{name}.ckpt").state_dict()
        state = {f"module.{k}": v for k, v in sd.items()}
        if name == "local_refinement_net":
            n = sd["conv1a.conv2d.weight"].shape[0]
            state["module.conv1a.norm_layer.running_mean"] = torch.zeros(n)
            state["module.conv1a.norm_layer.running_var"] = torch.ones(n)
        paths.append(folder / f"{name}.pth")
        torch.save(state, paths[-1])
    return tuple(paths)


def phase_serve(device) -> dict:
    """Warm serving through `Deflickerer` and `cli.serve.serve_lines`: four
    job lines (clip A, clip B, clip A again with another seed under
    DEFLICKER_PROFILE, a line with an unknown key) at the default widths
    and batch, RAFT from the seeded random `.pth`, stage 2 from `.pth`
    files.  Counts the loads of the warm state and each job's launches;
    then `cli.evaluate.main` and `cli.stage2.main` on clip B."""
    import io

    import torch

    import deflicker_torch.cli.pipeline as tpipe
    import deflicker_torch.filter as tfilter
    from deflicker_torch import Deflickerer
    from deflicker_torch.cli import evaluate, serve, stage2
    from deflicker_torch.config import AtlasConfig
    from deflicker_torch.io.media import list_frames
    from deflicker_torch.ops.cuda import build

    root = WORK / "data_serve"
    results = WORK / "results_serve"
    for seed, name in ((5, "clipa"), (6, "clipb")):
        make_clip(root / name, seed=seed, T=SERVE_FRAMES)
    fpath, lpath = write_stage2_pth(WORK / "weights_serve")
    solves = -(-(SERVE_FRAMES - 1) // PAIR_BATCH)

    loads = {"load_filter_engine": 0, "make_flow_provider": 0, "build": 0}
    originals = [(tfilter, "load_filter_engine"), (tpipe, "make_flow_provider"),
                 (build, "build")]

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            loads[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    saved = [getattr(m, a) for m, a in originals]
    for (m, a), fn in zip(originals, saved):
        setattr(m, a, counted(a, fn))
    try:
        d = Deflickerer(ckpt_raft=str(WORK / "raft-random.pth"),
                        ckpt_filter=str(fpath), ckpt_local=str(lpath),
                        root=str(root), results_root=str(results),
                        device=device)
        d.atlas_cfg = dataclasses.replace(AtlasConfig(),
                                          pretrain_iter_number=PRETRAIN_SERVE)
        jobs = []
        process = d.process

        def captures():
            return (d.fit_graphs.captured, d.flow_provider.graphs.captured,
                    d.filter_engine.graphs.captured)

        def process_counted(**job):
            before, graphs = read_counters(), captures()
            keys = set(d.flow_provider.graphs.entries)
            out = process(**job)
            torch.cuda.synchronize(device)
            after = read_counters()
            fit, solve, refine = (x - y for x, y in zip(captures(), graphs))
            jobs.append({"launches": {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]},
                         "graphs_captured": fit, "solve_graphs_captured": solve,
                         "refine_graphs_captured": refine,
                         "solve_keys": sorted(
                             str(k[:3]) for k in
                             set(d.flow_provider.graphs.entries) - keys),
                         "loads": dict(loads),
                         "libraries": dict(build._loaded)})
            return out

        d.process = process_counted
        a, b = str(root / "clipa"), str(root / "clipb")
        lines = [json.dumps({"frame_folder": a, "iters": ITERS_SERVE}),
                 json.dumps({"frame_folder": b, "iters": ITERS_SERVE}),
                 json.dumps({"frame_folder": a, "iters": ITERS_SERVE, "seed": 7}),
                 json.dumps({"frame_folder": b, "priority": 1})]
        prof = WORK / "profile_serve"
        print(f"[serve] Deflickerer on {device}, {SERVE_FRAMES}-frame clips "
              f"{CLIP[1]}x{CLIP[2]} (fit at /4), default widths, batch "
              f"{d.atlas_cfg.samples_batch}, RAFT random weights, stage 2 from "
              f".pth; cut: iters_num 10001 -> {ITERS_SERVE}, "
              f"pretrain_iter_number 100 -> {PRETRAIN_SERVE}; job 3 under "
              "DEFLICKER_PROFILE", flush=True)
        buf = io.StringIO()
        reset_counters()
        n = serve.serve_lines(d, lines[:2], out=buf)
        with env(DEFLICKER_PROFILE=str(prof)):
            n += serve.serve_lines(d, lines[2:], out=buf)
        launches = read_counters()
    finally:
        for (m, a), fn in zip(originals, saved):
            setattr(m, a, fn)

    res = [json.loads(line) for line in buf.getvalue().splitlines()]
    if n != 4 or [r["ok"] for r in res] != [True, True, True, False] \
            or "unknown job keys: ['priority']" not in res[3]["error"]:
        raise AssertionError(f"serve results {res}")
    for r in res[:3]:
        for key in ("psnr", "final_psnr", "final_ewarp", "input_ewarp"):
            if not math.isfinite(r.get(key, float("nan"))):
                raise AssertionError(f"{key} missing or not finite: {r}")
    # warm state: weights loaded by job 1 only, no library built or loaded
    # after it
    first, last = jobs[0], jobs[-1]
    if last["loads"] != {"load_filter_engine": 1, "make_flow_provider": 1,
                         "build": first["loads"]["build"]} \
            or any(last["libraries"][k] is not v
                   for k, v in first["libraries"].items()) \
            or set(last["libraries"]) != set(first["libraries"]):
        raise AssertionError(f"warm state reloaded: {jobs}")
    # each job fits 2 networks x ITERS_SERVE steps; jobs 1-2 solve the flow
    # of their clip, job 3 reads clip A's flow from disk
    per = 2 * ITERS_SERVE
    want_jobs = [{"fwd": per, "bwd": per, "lookup": RAFT_ITERS * solves},
                 {"fwd": per, "bwd": per, "lookup": RAFT_ITERS * solves},
                 {"fwd": per, "bwd": per}]
    if [j["launches"] for j in jobs] != want_jobs:
        raise AssertionError(f"per-job launches {[j['launches'] for j in jobs]}")
    # job 1 captures the pretrain's step and the fit's (one loss phase: global
    # rigidity stops after the cut run); jobs 2 and 3, of its shape, none
    if [j["graphs_captured"] for j in jobs] != [2, 0, 0]:
        raise AssertionError("graphs captured per job "
                             f"{[j['graphs_captured'] for j in jobs]}, want [2, 0, 0]")
    # job 1 captures a solve for its full batches and one for its tail
    # batch, and its refinement step; jobs 2 and 3, of its shapes, none
    tail = (SERVE_FRAMES - 1) % PAIR_BATCH
    want_solves = 2 if tail else 1
    if [(j["solve_graphs_captured"], j["refine_graphs_captured"])
            for j in jobs] != [(want_solves, 1), (0, 0), (0, 0)]:
        raise AssertionError("solve and refinement graphs captured per job "
                             f"{[(j['solve_graphs_captured'], j['refine_graphs_captured']) for j in jobs]}"
                             f", want [({want_solves}, 1), (0, 0), (0, 0)]")
    # job 1 makes the flow engine's pinned staging; job 2, of its frame
    # size, reuses it, and job 3 solves no flow
    made = [r["flow"].get("staging_made", 0) for r in res[:3]]
    if not (made[0] > 0 and made[1:] == [0, 0]):
        raise AssertionError(f"flow staging made per job {made}")
    want = {"fwd": 3 * per, "bwd": 3 * per, "lookup": 2 * RAFT_ITERS * solves}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"launches {launches}, want {want}")
    traces = sorted(prof.glob("*.pt.trace.json"))
    if not traces:
        raise AssertionError(f"DEFLICKER_PROFILE wrote no trace in {prof}")

    keys = ("wall_s", "iters_per_sec", "t_flow", "t_pretrain", "t_fit",
            "t_render", "t_stage2", "t_total", "psnr", "final_psnr",
            "final_ewarp", "input_ewarp")
    for k, (r, j) in enumerate(zip(res, jobs)):
        print(f"[serve] job {k + 1}" + (" (cold)" if k == 0 else " (warm)")
              + (" profiled" if k == 2 else "") + " "
              + json.dumps({**{x: r[x] for x in keys}, "launches": j["launches"],
                            "graphs_captured": j["graphs_captured"],
                            "solve_graphs_captured": j["solve_graphs_captured"],
                            "solve_keys": j["solve_keys"],
                            "refine_graphs_captured": j["refine_graphs_captured"],
                            "flow": r["flow"]}),
              flush=True)
    print(f"[serve] error line: {res[3]['error']!r}", flush=True)

    # what the Deflickerer's kept states hold on the card: freed, with the
    # garbage collector off, when its graphs are dropped
    import gc

    from deflicker_torch.atlas.graphs import FitGraphs

    n_states = len(d.fit_graphs.states)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(device), torch.cuda.memory_reserved(device)
    gc.disable()
    try:
        d.fit_graphs = FitGraphs(keep=True)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        left = (torch.cuda.memory_allocated(device),
                torch.cuda.memory_reserved(device))
    finally:
        gc.enable()
    kept_gib = [(h - l) / 2 ** 30 for h, l in zip(held, left)]
    print(f"[serve] {n_states} kept states hold {kept_gib[0]:.4f} GiB allocated, "
          f"{kept_gib[1]:.4f} GiB reserved", flush=True)
    if n_states != 2 or kept_gib[0] <= 0:
        raise AssertionError(f"{n_states} kept states freed {kept_gib} GiB "
                             "when dropped, want 2 states and memory freed")
    # the same for the engines' solve and refinement graphs (static
    # buffers and the two pools)
    from deflicker_torch.atlas.graphs import InferenceGraphs

    n_keys = (len(d.flow_provider.graphs.entries),
              len(d.filter_engine.graphs.entries))
    gc.disable()
    try:
        d.flow_provider.graphs = InferenceGraphs(device, "RAFT solves")
        d.filter_engine.graphs = InferenceGraphs(device, "refinement steps")
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        after = (torch.cuda.memory_allocated(device),
                 torch.cuda.memory_reserved(device))
    finally:
        gc.enable()
    infer_gib = [(h - a) / 2 ** 30 for h, a in zip(left, after)]
    print(f"[serve] {n_keys[0]} solve and {n_keys[1]} refinement graphs hold "
          f"{infer_gib[0]:.4f} GiB allocated, {infer_gib[1]:.4f} GiB reserved",
          flush=True)
    if infer_gib[0] <= 0 or infer_gib[1] <= 0:
        raise AssertionError(f"the engines' graphs freed {infer_gib} GiB when "
                             "dropped")

    # the stage CLIs on clip B, whose results no later job rewrote
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluate.main(["--video_name", "clipb", "--root", str(root),
                       "--results_root", str(results)], device=device)
    m = json.loads(out.getvalue().strip().splitlines()[-1])
    if m["psnr_mean"] != res[1]["final_psnr"] or m["num_frames"] != SERVE_FRAMES:
        raise AssertionError(f"evaluate {m} against job 2 {res[1]['final_psnr']}")
    t0 = time.time()
    stage2.main(["--video_name", "clipb", "--root", str(root),
                 "--results_root", str(results), "--ckpt_filter", str(fpath),
                 "--ckpt_local", str(lpath)], device=device)
    t_stage2_cli = time.time() - t0
    final = list_frames(results / "clipb" / "final" / "output")
    if len(final) != SERVE_FRAMES:
        raise AssertionError(f"stage2 CLI wrote {len(final)} final frames")
    summary = {
        "cold_wall_s": res[0]["wall_s"],
        "warm_wall_s": [r["wall_s"] for r in res[1:3]],
        "loads": last["loads"], "launches": launches, "solves_per_job": solves,
        "trace_mb": sum(t.stat().st_size for t in traces) / 2 ** 20,
        "evaluate_psnr_mean": m["psnr_mean"], "evaluate_ewarp_mean":
        m.get("ewarp_mean"), "stage2_cli_s": t_stage2_cli,
        "kept_states": n_states, "kept_states_gib": kept_gib,
        "solve_refine_graphs": n_keys, "solve_refine_graphs_gib": infer_gib}
    print("[serve] " + json.dumps(summary), flush=True)
    return launches


def temporal_err(x, clip) -> float:
    """Mean over t of |x_t - warp(x_{t-1}, flow_t)| on the clip's valid
    pixels (bench_e2e's exact-flow temporal error)."""
    from deflicker_torch.ops.sampling import flow_warp

    errs = [float(((x[t] - flow_warp(x[t - 1], clip.flow_bw[t])).abs()
                   * clip.valid[t]).sum() / (clip.valid[t].sum() * 3))
            for t in range(1, x.shape[0])]
    return float(np.mean(errs))


@contextlib.contextmanager
def counted_graphs():
    """Every warm-up step, capture and replay of the `Graphs` machinery
    (deflicker_torch/atlas/graphs.py) counted by graph state, in the order
    the states first appear: {"states": [{"warm_ups", "captured",
    "replays"}, ...]}."""
    from deflicker_torch.atlas import graphs

    counts, by_state = {"states": []}, {}
    real = {k: getattr(graphs.Graphs, k)
            for k in ("warm_up", "capture", "replay")}

    def mine(state):
        if id(state) not in by_state:
            by_state[id(state)] = {"warm_ups": 0, "captured": 0, "replays": 0}
            counts["states"].append(by_state[id(state)])
        return by_state[id(state)]

    def warm_up(self, state, fn):
        mine(state)["warm_ups"] += 1
        return real["warm_up"](self, state, fn)

    def capture(self, state, fn):
        mine(state)["captured"] += 1
        return real["capture"](self, state, fn)

    def replay(self, state, graph, n):
        mine(state)["replays"] += n
        return real["replay"](self, state, graph, n)

    for k, fn in (("warm_up", warm_up), ("capture", capture),
                  ("replay", replay)):
        setattr(graphs.Graphs, k, fn)
    try:
        yield counts
    finally:
        for k, fn in real.items():
            setattr(graphs.Graphs, k, fn)


def train_routes(device, cfg, bank, unet) -> dict:
    """Each net's training captured (its own `FitGraphs`) and eager
    (`FitGraphs(eager=True)`) from one seed and one texture bank, so both
    clip kinds occur: three chunks of `TRAIN_WINDOW[net]` steps a route,
    the first with the warm-up steps and captures, the second timed, the
    third under torch.profiler (`report_profile`); the params of the two
    routes must be bit-equal after them.  The refiner trains against
    `unet`.  Returns each net's steps/s, graphs captured and agreement."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.train.stage2_trainer import train_filter, train_refiner

    out = {}
    for net, n in TRAIN_WINDOW.items():
        c = dataclasses.replace(cfg, filter_steps=3 * n, refine_steps=3 * n,
                                steps_per_call=n)
        states = {}
        for route in ("eager", "captured"):
            graphs = FitGraphs(eager=route == "eager")
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            marks = []

            def log(name, step, rec):
                marks.append(time.perf_counter())
                if len(marks) == 2:
                    prof.start()
                    marks.append(time.perf_counter())
                elif len(marks) == 4:
                    prof.stop()

            torch.cuda.synchronize()
            if net == "filter":
                model, _ = train_filter(c, 3, log, bank, device, graphs)
            else:
                model, _ = train_refiner(c, 3, unet, log, bank, device, graphs)
            wall_plain, wall = marks[1] - marks[0], marks[3] - marks[2]
            report_profile(f"train-profile-{net}-{route}", "step", n,
                           wall_plain, wall, prof)
            states[route] = model.state_dict()
            out[f"{net}_{route}_steps_per_s"] = n / wall_plain
            out[f"{net}_{route}_graphs_captured"] = graphs.captured
        same = all(torch.equal(a, b) for a, b in zip(
            states["eager"].values(), states["captured"].values()))
        out[f"{net}_steps"] = 3 * n
        out[f"{net}_params_bit_equal"] = same
        if not same:
            raise AssertionError(f"captured {net} training differs from eager")
        if out[f"{net}_captured_graphs_captured"] != 2:
            raise AssertionError(f"{net} training captured "
                                 f"{out[f'{net}_captured_graphs_captured']} graphs")
    return out


def phase_train(device) -> dict:
    """Stage-2 training on the card through `cli.train_stage2.main` (one
    CUDA graph a net and clip kind, counted), its checkpoints run by
    `cli.stage2`, captured training against eager with both routes'
    profiles, and the held-out quality of the shipped weights."""
    import io

    import torch

    from deflicker_torch.cli import stage2, train_stage2
    from deflicker_torch.filter import (filter_frames, load_filter_engine,
                                        refine_sequence)
    from deflicker_torch.io.media import list_frames, read_image
    from deflicker_torch.metrics import psnr
    from deflicker_torch.models import unet_init
    from deflicker_torch.train import TrainConfig
    from deflicker_torch.train.synth import load_texture_bank
    from deflicker_torch.train.synth import make_clip as synth_clip

    out_dir = WORK / "train"
    shutil.rmtree(out_dir, ignore_errors=True)
    textures = WORK / "data_serve" / "clipb"
    shape = [a for k, v in TRAIN_SHAPE.items() for a in (f"--{k}", str(v))]
    args = ["--out_dir", str(out_dir), *shape, "--lr", "2e-4",
            "--lr_schedule", "constant", "--dtype", "bfloat16", "--seed", "0",
            "--filter_steps", str(TRAIN_FILTER_STEPS),
            "--refine_steps", str(TRAIN_REFINE_STEPS),
            "--steps_per_call", str(TRAIN_PER_CALL),
            "--texture_dir", str(textures)]
    print(f"[train] cli.train_stage2 on {device}: UNet(6, 3, 32), "
          f"TransformNet(32, 5), {' '.join(shape)}, lr 2e-4 constant, bf16, "
          "seed 0, the serve phase's clip B as texture bank (texture_mix "
          "0.5); cut: filter_steps 4000 -> "
          f"{TRAIN_FILTER_STEPS}, refine_steps 1500 -> {TRAIN_REFINE_STEPS}, "
          f"steps_per_call 50 -> {TRAIN_PER_CALL}", flush=True)
    buf = io.StringIO()
    reset_counters()
    t0 = time.time()
    with counted_graphs() as graph_counts, contextlib.redirect_stdout(buf):
        train_stage2.main(args, device=None)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    launches = read_counters()
    print(buf.getvalue(), end="", flush=True)
    if any(launches.values()):
        raise AssertionError(f"training launched chain or lookup kernels: "
                             f"{launches}")
    # one graph a net and clip kind; every step after a kind's two warm-up
    # steps is one replay
    nets = graph_counts["states"]
    for counts, steps in zip(nets, (TRAIN_FILTER_STEPS, TRAIN_REFINE_STEPS)):
        if not (counts["captured"] == 2 and counts["warm_ups"] == 4
                and counts["warm_ups"] + counts["replays"] == steps):
            raise AssertionError(f"training graphs {graph_counts}")
    if len(nets) != 2:
        raise AssertionError(f"training graph states {graph_counts}")

    # the run: finite chunks, each net's last chunk below its first
    rows = [json.loads(line) for line in
            (out_dir / "scalars.jsonl").read_text().splitlines()]
    summary = {"t_train_s": t_train, "graphs": dict(zip(("filter", "refiner"),
                                                        nets))}
    for net, steps, keys in (("filter", TRAIN_FILTER_STEPS, ("rec", "grad")),
                             ("refiner", TRAIN_REFINE_STEPS, ("rec", "temp"))):
        r = [x for x in rows if x["net"] == net]
        if [x["step"] for x in r] != list(range(TRAIN_PER_CALL, steps + 1,
                                                TRAIN_PER_CALL)):
            raise AssertionError(f"{net} chunks {[x['step'] for x in r]}")
        if not all(math.isfinite(x[k]) for x in r for k in ("total",) + keys):
            raise AssertionError(f"{net} losses not finite: {r}")
        if not r[-1]["total"] < r[0]["total"]:
            raise AssertionError(f"{net} loss did not descend: "
                                 f"{[x['total'] for x in r]}")
        summary[f"{net}_total_first_last"] = [r[0]["total"], r[-1]["total"]]
    # steps/s from the CLI's chunk lines, the first chunk of each net left
    # out (its warm-up steps and captures, the filter checkpoint's write)
    for net in ("filter", "refiner"):
        rates = [float(line.rsplit("(", 1)[1].split()[0])
                 for line in buf.getvalue().splitlines()
                 if line.startswith(f"[{net}] step")]
        summary[f"{net}_steps_per_s"] = float(np.mean(rates[1:]))
    fpath, lpath = out_dir / "neural_filter.ckpt", out_dir / "local_refinement_net.ckpt"
    load_filter_engine(fpath, lpath, device=device)

    # the trained checkpoints through the stage-2 CLI, on the serve phase's
    # second clip (its stage-1 output copied under a fresh results root)
    results = out_dir / "results"
    shutil.copytree(WORK / "results_serve" / "clipb" / "stage_1",
                    results / "clipb" / "stage_1")
    stage2.main(["--video_name", "clipb", "--root", str(WORK / "data_serve"),
                 "--results_root", str(results), "--ckpt_filter", str(fpath),
                 "--ckpt_local", str(lpath)], device=device)
    final = list_frames(results / "clipb" / "final" / "output")
    if len(final) != SERVE_FRAMES:
        raise AssertionError(f"stage2 CLI wrote {len(final)} final frames")
    img = read_image(final[-1])
    if not (np.isfinite(img).all() and img.std() > 0):
        raise AssertionError("the trained stage 2 wrote a flat or non-finite frame")
    summary["stage2_cli_frames"] = len(final)
    print("[train] " + json.dumps(summary), flush=True)

    # captured against eager, both nets, with each route's profile
    size = TRAIN_SHAPE["size"]
    cfg = TrainConfig(height=size, width=size, batch=TRAIN_SHAPE["batch"],
                      clip_len=TRAIN_SHAPE["clip_len"],
                      clip_batch=TRAIN_SHAPE["clip_batch"], dtype="bfloat16")
    bank = load_texture_bank(textures, 2 * size, 2 * size)
    routes = train_routes(device, cfg, bank,
                          unet_init(torch.Generator().manual_seed(0)).to(device))
    print("[train-graphs] " + json.dumps(routes), flush=True)
    summary.update(routes)

    # held-out quality of the shipped weights (bench_e2e.bench_trained_stage2)
    n_clips, T, H, W = HELDOUT
    wdir = ROOT / "pretrained_weights"
    eng = load_filter_engine(wdir / "neural_filter.ckpt",
                             wdir / "local_refinement_net.ckpt", device=device)
    gen = torch.Generator(device).manual_seed(HELDOUT_SEED)
    rows = []
    for _ in range(n_clips):
        clip = synth_clip(gen, T, H, W)
        P = filter_frames(eng.unet, clip.inp, clip.atlas)
        O = refine_sequence(eng.tnet, P).clamp(0.0, 1.0)
        clean = clip.clean.cpu().numpy()
        rows.append({
            "psnr_input": psnr(clip.inp.cpu().numpy(), clean),
            "psnr_filtered": psnr(P.clamp(0.0, 1.0).cpu().numpy(), clean),
            "psnr_refined": psnr(O.cpu().numpy(), clean),
            "temp_input": temporal_err(clip.inp, clip),
            "temp_refined": temporal_err(O, clip),
            "temp_clean": temporal_err(clip.clean, clip)})
    quality = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    print("[train] held-out, shipped weights " + json.dumps(
        {"clips": n_clips, "shape": f"{T}x{H}x{W}", **quality}), flush=True)
    if not quality["psnr_filtered"] >= quality["psnr_input"] + 10.0:
        raise AssertionError(f"shipped filter gains < 10 dB: {quality}")
    if not quality["temp_refined"] < quality["temp_input"]:
        raise AssertionError(f"refined not steadier than the input: {quality}")
    return {**summary, **quality}


@contextlib.contextmanager
def recorded_fit():
    """The pipeline's `fit_atlas` with the params recorded as one flat host
    array each: "init" as the fit starts, "first" at its first logged step
    (at "first_iteration"), "final" as it ends."""
    import torch

    import deflicker_torch.cli.pipeline as pl
    from deflicker_torch.atlas.engine import flat_params

    def flat(params):
        return torch.cat([q.detach().reshape(-1)
                          for q in flat_params(params)]).cpu().numpy()

    store, real = {}, pl.fit_atlas

    def fit(params, *args, log_callback=None, **kwargs):
        store["init"] = flat(params)

        def log(iteration, rec):
            if "first" not in store:
                store["first"], store["first_iteration"] = flat(params), iteration
            if log_callback is not None:
                log_callback(iteration, rec)

        result = real(params, *args, log_callback=log, **kwargs)
        store["final"] = flat(result.params)
        return result

    pl.fit_atlas = fit
    try:
        yield store
    finally:
        pl.fit_atlas = real


def _parallel_rank(mesh, cfg, atlas_cfg) -> dict:
    """One rank of the parallel phase's two-rank pipeline (a spawned
    process): the launch counters zeroed just before `run_pipeline` and
    read just after, and the fit's params as it starts and ends."""
    from deflicker_torch.cli.pipeline import run_pipeline

    with recorded_fit() as fit:
        reset_counters()
        out = run_pipeline(cfg, atlas_cfg, mesh=mesh)
        launches = read_counters()
    return {"launches": launches, "fit": fit,
            **{k: out[k] for k in ("psnr", "final_psnr", "final_ewarp",
                                   "iters_per_sec", "t_flow", "t_pretrain",
                                   "t_fit", "t_render", "t_stage2",
                                   "t_total")}}


def first_update_spread(params, specs, data, cfg, device) -> dict:
    """How far Adam's first update moves, over its size (Frobenius), when
    one sample draw's gradient is summed from two halves (what two ranks
    do) and when it comes from half the draw only (what a rank without the
    other's gradients takes): the two scales phase 15(b)'s FIT_RTOL_PAR
    lies between.  Adam's first step is lr * g / (|g| + eps)."""
    import torch

    from deflicker_torch.atlas.engine import flat_params, make_loss_fn

    T, (H, W), B = data.num_frames, data.res, cfg.samples_batch
    gen = torch.Generator(device).manual_seed(2)
    j, i, f = (torch.randint(0, n, (B,), generator=gen, device=device)
               for n in (W, H, T))
    packed = data.packed
    counts = packed[f, i, j, 13:15].sum(0)
    loss_fn = make_loss_fn(specs, cfg, data, include_global=True)

    def update(blocks):
        p = {k: [{kk: vv.detach().clone().requires_grad_()
                  for kk, vv in layer.items()} for layer in v]
             for k, v in params.items()}
        for lo, hi in blocks:
            loss_fn(p, packed, j[lo:hi], i[lo:hi], f[lo:hi],
                    (B, counts[0], counts[1]))[0].backward()
        g = torch.cat([q.grad.reshape(-1) for q in flat_params(p)])
        return g / (g.abs() + 1e-8)

    whole = update([(0, B)])

    def apart(blocks):
        return float((update(blocks) - whole).norm() / whole.norm())

    return {"halves_summed": apart([(0, B // 2), (B // 2, B)]),
            "half_batch": apart([(0, B // 2)])}


def first_loss(results: Path) -> float:
    """The fit's first logged loss (a one-step chunk: the fit's first
    schedule boundary is at step 1)."""
    with open(results / "stage_1" / "scalars.jsonl") as f:
        return json.loads(f.readline())["total"]


def phase_parallel(device, frames: Path, raft_flow: Path) -> dict:
    """deflicker_torch.parallel on the one card: (a) the sharded fit at
    world size 1 under NCCL, captured and eager, against the captured
    unsharded fit, bit for bit, with each way's it/s and profile and the
    gradient all-reduce's device time inside the captured step; (b) configuration 1's pipeline on
    two ranks sharing the card under gloo (RAFT pairs, fit samples, render
    frames and U-Net frames split), each rank's launches held to its share,
    its RAFT flow against `raft_flow` (one rank's solve of `frames` with
    the same weights), its fit against one rank's on the same flow; (c)
    `cli.batch --dcn` as two processes meeting at a local coordinator, one
    40-frame clip each."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data, pretrain_mapping)
    from deflicker_torch.atlas.engine import flat_params
    from deflicker_torch.atlas.graphs import FitGraphs
    from deflicker_torch.cli.pipeline import run_pipeline
    from deflicker_torch.config import AtlasConfig, PipelineConfig
    from deflicker_torch.io.media import list_frames
    from deflicker_torch.parallel import launch, make_mesh
    from deflicker_torch.parallel.mesh import all_reduce_sum, free_port

    # the kernels at one rank's shapes: rows 1-2 at 5,000 and 2,500 samples
    # a step (2 and 4 ranks), row 5 at one rank's block of a pair batch
    rank_rows = {n: phase_chain_kernels(device, samples=n, tag="kernel-rank")
                 for n in (AtlasConfig().samples_batch // 2,
                           AtlasConfig().samples_batch // 4)}
    rank_corr = phase_corr_kernel(device, cases=(
        ("rank+-3", PAIR_BATCH, CLIP[1] // 8, CLIP[2] // 8, 256, 3.0),
        ("rank-last+-3", (2 * ((CLIP[0] - 1) % PAIR_BATCH)) // RANKS,
         CLIP[1] // 8, CLIP[2] // 8, 256, 3.0)), tag="kernel-rank")

    # (a) world size 1 under NCCL: the sharded fit is the unsharded fit
    cfg = dataclasses.replace(AtlasConfig(), iters_num=ITERS_PAR,
                              evaluate_every=ITERS_PAR + 1,
                              stop_global_rigidity=ITERS_PAR // 2)
    data = load_video_data(frames, CLIP[1] // 4, CLIP[2] // 4,
                           CLIP[0]).with_packed(device)
    T, (H, W) = data.num_frames, data.res
    specs = build_specs(cfg)
    params = init_models(specs, torch.Generator().manual_seed(0), device)
    pretrain_mapping(params["mapping1"], specs.mapping1,
                     torch.Generator(device).manual_seed(1), T, H, W,
                     cfg.uv_mapping_scale, PRETRAIN_PAR)

    def fit(m, steps, graphs=None):
        """`steps` fit steps from the pretrained params and seed 2 through
        `graphs` (None: the fit's own, captured): (params, it/s,
        launches)."""
        p = {k: [{kk: vv.detach().clone().requires_grad_()
                  for kk, vv in layer.items()} for layer in v]
             for k, v in params.items()}
        c = dataclasses.replace(cfg, iters_num=steps)
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.time()
        fit_atlas(p, specs, data, c, torch.Generator(device).manual_seed(2),
                  mesh=m, graphs=graphs)
        torch.cuda.synchronize()
        return p, steps / (time.time() - t0), read_counters()

    # the runs: unsharded and sharded captured, sharded eager
    ways = (("unsharded", False), ("sharded", False), ("sharded-eager", True))
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh()
        mesh_of = {"unsharded": None, "sharded": mesh, "sharded-eager": mesh}
        for m in (None, mesh):       # first calls: cuBLAS, NCCL's communicator
            fit(m, 5)
        with counted_graphs() as graph_counts:
            runs = {name: fit(mesh_of[name], ITERS_PAR,
                              FitGraphs(eager=eager)) for name, eager in ways}
        for name, (_, _, launches) in runs.items():
            if launches["fwd"] != 2 * ITERS_PAR or launches["bwd"] != 2 * ITERS_PAR:
                raise AssertionError(f"{name} fit launched {launches}")
        # one capture a loss phase for each captured way, none eager
        if [c["captured"] for c in graph_counts["states"]] != [2, 2]:
            raise AssertionError(f"world-1 fit graphs {graph_counts}")
        same = {name: all(torch.equal(a, b) for a, b in zip(
            flat_params(runs["unsharded"][0]), flat_params(runs[name][0])))
            for name in ("sharded", "sharded-eager")}
        if not all(same.values()):
            raise AssertionError(f"world-1 sharded fits against the "
                                 f"unsharded fit, bit-equal: {same}")
        grads = [torch.randn_like(q) for q in flat_params(runs["sharded"][0])]
        flat = torch.cat([g.reshape(-1) for g in grads])
        world1 = {
            "backend": mesh.backend,
            "params_bit_equal": {f"{k}_vs_unsharded": v for k, v in same.items()},
            **{f"{name.replace('-', '_')}_it_s": runs[name][1]
               for name, _ in ways},
            "graphs": dict(zip(("unsharded", "sharded"),
                               graph_counts["states"])),
            "grad_floats": int(flat.numel()),
            "grad_reduce_ms": cuda_ms(lambda: all_reduce_sum(grads, mesh)),
            "all_reduce_ms": cuda_ms(lambda: dist.all_reduce(flat)),
            "first_update_rel": first_update_spread(params, specs, data, cfg,
                                                    device)}
        # where a step's time goes (20 steps each way, after 20 that capture
        # the kept graphs)
        per_step = {}
        for name, eager in ways:
            kept = FitGraphs(keep=True, eager=eager)
            fit(mesh_of[name], PROFILE_PAR, kept)
            wall_plain = PROFILE_PAR / fit(mesh_of[name], PROFILE_PAR, kept)[1]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = PROFILE_PAR / fit(mesh_of[name], PROFILE_PAR, kept)[1]
            report_profile(f"parallel-profile-{name}", "step", PROFILE_PAR,
                           wall_plain, wall, prof)
            per_step[name] = {k: (us / 1e3 / PROFILE_PAR, n / PROFILE_PAR)
                              for us, n, k in device_events(prof)}
        # the gradient all-reduce inside the captured sharded step: NCCL's
        # kernels, and every device op a step the sharded graph runs more
        # often than the unsharded one (the flat buffer's cat, the copies
        # back), with their device ms
        shd, uns = per_step["sharded"], per_step["unsharded"]
        extra = {k: [shd.get(k, (0.0, 0.0))[0] - uns.get(k, (0.0, 0.0))[0],
                     shd.get(k, (0.0, 0.0))[1] - uns.get(k, (0.0, 0.0))[1]]
                 for k in shd.keys() | uns.keys()
                 if shd.get(k, (0, 0))[1] != uns.get(k, (0, 0))[1]}
        world1["captured_all_reduce"] = {
            "nccl_device_ms_per_step": sum(
                v[0] for k, v in shd.items() if "nccl" in k.lower()),
            "nccl_kernels_per_step": sum(
                v[1] for k, v in shd.items() if "nccl" in k.lower()),
            "extra_device_ms_per_step": sum(v[0] for v in extra.values()),
            "extra_ops_per_step": {k[:80]: v for k, v in extra.items()}}
    finally:
        dist.destroy_process_group()
    print("[parallel] world 1, NCCL: " + json.dumps(world1), flush=True)

    # (b) two ranks on the one card (gloo: NCCL refuses two ranks a card)
    par = WORK / "data_par" / frames.name
    shutil.copytree(frames, par)
    pipe = dict(root=str(par.parent), ckpt_raft=str(WORK / "raft-random.pth"),
                ckpt_filter=str(ROOT / "pretrained_weights" / "neural_filter.ckpt"),
                ckpt_local=str(ROOT / "pretrained_weights" /
                               "local_refinement_net.ckpt"))
    pcfg = dataclasses.replace(cfg, pretrain_iter_number=PRETRAIN_PAR,
                               stop_global_rigidity=0)
    t0 = time.time()
    ranks = launch(_parallel_rank, RANKS, "cuda", (PipelineConfig(
        video_frame_folder=str(par), results_root=str(WORK / "results_par2"),
        **pipe), pcfg), timeout=PAR_TIMEOUT)
    wall2 = time.time() - t0
    # one rank on the same frames and the flow the two ranks wrote
    one = WORK / "data_par1" / frames.name
    shutil.copytree(par, one)
    shutil.copytree(par.parent / f"{par.name}_flow", one.parent / f"{one.name}_flow")
    with recorded_fit() as ref_fit:
        reset_counters()
        ref = run_pipeline(PipelineConfig(
            video_frame_folder=str(one), results_root=str(WORK / "results_par1"),
            **{**pipe, "root": str(one.parent)}), pcfg, device=device)
        ref_launches = read_counters()
    if (ref_launches["fwd"], ref_launches["bwd"], ref_launches["lookup"]) != (
            2 * ITERS_PAR, 2 * ITERS_PAR, 0):
        raise AssertionError(f"one-rank run launched {ref_launches}")
    batches = -(-(CLIP[0] - 1) // PAIR_BATCH)
    for r, out in enumerate(ranks):
        want = {k: 0 for k in out["launches"]}
        want.update(fwd=2 * ITERS_PAR, bwd=2 * ITERS_PAR, lookup=batches * RAFT_ITERS)
        if out["launches"] != want:
            raise AssertionError(f"rank {r} launched {out['launches']}, want {want}")
    # the fit: the ranks stay bit-equal (one all-reduced gradient, one Adam
    # update), and near the one-rank fit on the same flow
    fits = [out["fit"] for out in ranks]
    if not all(np.array_equal(fits[0][k], f[k]) for f in fits[1:]
               for k in ("init", "first", "final")):
        raise AssertionError("the ranks' fit params differ")

    def fit_apart(key):
        """Two ranks' params from one rank's, over one rank's movement."""
        return float(np.linalg.norm(fits[0][key] - ref_fit[key])
                     / np.linalg.norm(ref_fit[key] - ref_fit["init"]))

    fit_first, fit_final = fit_apart("first"), fit_apart("final")
    if not fit_first <= FIT_RTOL_PAR:
        raise AssertionError(f"two-rank fit params after step "
                             f"{ref_fit['first_iteration']} {fit_first} of its "
                             f"update from one rank's, bound {FIT_RTOL_PAR}")
    # the RAFT pairs: split, solved and gathered against one rank's solve
    names2 = sorted(f.name for f in (par.parent / f"{par.name}_flow").glob("*.npy"))
    names1 = sorted(f.name for f in raft_flow.glob("*.npy"))
    if names2 != names1 or len(names1) != 2 * (CLIP[0] - 1):
        raise AssertionError(f"flow files: {len(names2)} on two ranks, "
                             f"{len(names1)} on one")

    def flow_rel(a_name, b_name):
        a = np.load(par.parent / f"{par.name}_flow" / a_name)
        b = np.load(raft_flow / b_name)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    flow_err = max(flow_rel(n, n) for n in names1)
    flow_other = min(flow_rel(a, b) for a, b in zip(names1, names1[1:]))
    if not flow_err <= FLOW_RTOL_PAR:
        raise AssertionError(f"two-rank RAFT flow {flow_err} from one rank's "
                             f"solve, bound {FLOW_RTOL_PAR}")
    loss2 = first_loss(WORK / "results_par2" / frames.name)
    loss1 = first_loss(WORK / "results_par1" / frames.name)
    if not abs(loss2 - loss1) <= 1e-5 * abs(loss1):
        raise AssertionError(f"first-step loss {loss2} on two ranks, {loss1} on one")
    for key in ("psnr", "final_psnr"):
        if not abs(ranks[0][key] - ref[key]) <= 0.1:
            raise AssertionError(f"{key} {ranks[0][key]} on two ranks, {ref[key]} on one")
    for sub in ("stage_1/output", "final/output"):
        n = len(list_frames(WORK / "results_par2" / frames.name / sub))
        if n != CLIP[0]:
            raise AssertionError(f"two ranks wrote {n} frames to {sub}")
    two = {"ranks": RANKS, "backend": "gloo", "wall_s": wall2,
           "ranks_fit_bit_equal": True,
           "fit_first_iteration": ref_fit["first_iteration"],
           "fit_rel_err_first": fit_first, "fit_rel_err_final": fit_final,
           "fit_init_max_abs": float(np.abs(fits[0]["init"]
                                            - ref_fit["init"]).max()),
           "flow_rel_err_max": flow_err,
           "flow_rel_err_other_pair_min": flow_other,
           "first_loss": [loss2, loss1], "psnr": [ranks[0]["psnr"], ref["psnr"]],
           "final_psnr": [ranks[0]["final_psnr"], ref["final_psnr"]],
           "it_s_per_rank": [o["iters_per_sec"] for o in ranks],
           "it_s_one_rank": ref["iters_per_sec"],
           "t_flow": [o["t_flow"] for o in ranks], "t_stage2": [o["t_stage2"] for o in ranks],
           "t_total": [o["t_total"] for o in ranks] + [ref["t_total"]],
           "launches_per_rank": [o["launches"] for o in ranks],
           "launches_one_rank": ref_launches}
    print("[parallel] two ranks, one card: " + json.dumps(two), flush=True)

    # (c) cli.batch --dcn: two processes (hosts) on the one card, one clip each
    config = WORK / "dcn_config.json"
    config.write_text(json.dumps(dataclasses.asdict(dataclasses.replace(
        AtlasConfig(), pretrain_iter_number=PRETRAIN_PAR,
        stop_global_rigidity=ITERS_DCN // 2))))
    clips = ("clipa", "clipb")           # the serve phase's, flow on disk
    port = free_port()
    procs, t0 = [], time.time()
    for pid in range(2):
        argv = [sys.executable, "-m", "deflicker_torch.cli.batch", "--dcn",
                "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                "--process_id", str(pid), "--gpu", "0",
                "--videos", *[str(WORK / "data_serve" / f"{c}.mp4") for c in clips],
                "--root", str(WORK / "data_serve"), "--iters", str(ITERS_DCN),
                "--config", str(config),
                "--results_root", str(WORK / f"results_dcn{pid}"),
                "--ckpt_raft", str(WORK / "raft-random.pth"),
                "--ckpt_filter", pipe["ckpt_filter"], "--ckpt_local", pipe["ckpt_local"]]
        procs.append(subprocess.Popen(argv, cwd=ROOT, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs, walls = [], []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PAR_TIMEOUT)[0])
            walls.append(time.time() - t0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"dcn process {pid} exited {p.returncode}:\n{out[-3000:]}")
        recs = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
        hello = next(r for r in recs if "videos_assigned" in r)
        if hello != {"process": pid, "processes": 2, "videos_assigned": 1}:
            raise AssertionError(f"dcn process {pid} hello {hello}")
        res = WORK / f"results_dcn{pid}"
        mine, other = clips[pid], clips[1 - pid]
        n = len(list_frames(res / mine / "final" / "output"))
        if n != SERVE_FRAMES or (res / other).exists():
            raise AssertionError(f"dcn process {pid}: {n} frames of {mine}, "
                                 f"{other} present: {(res / other).exists()}")
    dcn = {"processes": 2, "walls_s": walls,
           "videos": [[r for r in (json.loads(x) for x in out.splitlines()
                                   if x.startswith("{")) if "video" in r]
                      for out in outs]}
    print("[parallel] dcn: " + json.dumps(dcn), flush=True)
    return {"world1": world1, "two_ranks": two, "dcn": dcn,
            "rank_chain": rank_rows, "rank_corr": rank_corr}


def device_events(prof):
    """Device-side events of a torch.profiler run (kernels, copies), summed
    by name: [(microseconds, count, name)], longest first.  User
    annotations on the device's timeline (`Optimizer.step#Adam.step`) span
    kernels already counted, so they are left out."""
    from torch.autograd import DeviceType

    by_name = {}
    for ev in prof.events():
        if (ev.device_type == DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    return sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)


def phase_profile(device, frames: Path, atlas_cfg, steps: int = 40) -> None:
    """Where a fit step's time goes, eager and captured (`profile_fit`):
    device-busy time (sum of kernel times) against the step's wall time
    gives the device's idle share; then the same for a pretrain step (one
    sweep of the frames timed, one profiled)."""
    import torch

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data, pretrain_mapping)

    T, H, W = CLIP[0], CLIP[1] // 4, CLIP[2] // 4
    # pack once: fit_atlas reuses a pack already on the device
    data = load_video_data(frames, H, W, atlas_cfg.maximum_number_of_frames
                           ).with_packed(device)
    cfg = dataclasses.replace(atlas_cfg, iters_num=steps, steps_per_call=steps,
                              evaluate_every=10 ** 9)
    specs = build_specs(cfg)
    params = init_models(specs, torch.Generator().manual_seed(0), device)
    gen = torch.Generator(device=device).manual_seed(0)
    profile_fit(device, "profile", lambda n, g: fit_atlas(
        params, specs, data, dataclasses.replace(cfg, iters_num=n), gen,
        graphs=g), steps)
    # the mapping's pretrain step, a sweep over the frames at a time
    g_pre = torch.Generator(device=device).manual_seed(1)
    profile_fit(device, "pretrain-profile", lambda n, g: pretrain_mapping(
        params["mapping1"], specs.mapping1, g_pre, T, H, W,
        cfg.uv_mapping_scale, max(1, n // T), graphs=g), T)


def phase_fit_graphs(device, frames: Path, atlas_cfg) -> dict:
    """Configuration 1's fit (the pipeline phase's clip at 108x192, default
    widths and batch) captured against eager from one seed: the mapping's
    pretrain (`PRETRAIN_GRAPH` sweeps) and `ITERS_GRAPH` fit steps across
    global rigidity's stop, each run both ways from the same init.  Params,
    Adam state, chunk logs and both generators' states must be bit-equal,
    the chain counters 2 x steps both ways; prints the times, it/s, graphs
    captured and peak device memory of each."""
    import torch

    from deflicker_torch.atlas import (build_specs, fit_atlas, init_models,
                                       load_video_data, pretrain_mapping)
    from deflicker_torch.atlas.engine import flat_params
    from deflicker_torch.atlas.graphs import FitGraphs

    T, H, W = CLIP[0], CLIP[1] // 4, CLIP[2] // 4
    data = load_video_data(frames, H, W, atlas_cfg.maximum_number_of_frames
                           ).with_packed(device)
    cfg = dataclasses.replace(atlas_cfg, iters_num=ITERS_GRAPH,
                              evaluate_every=ITERS_GRAPH - 1,
                              stop_global_rigidity=ITERS_GRAPH // 2)
    specs = build_specs(cfg)
    init = init_models(specs, torch.Generator().manual_seed(0), device)
    print(f"[fit-graphs] configuration 1 at {H}x{W}, {T} frames: pretrain "
          f"{PRETRAIN_GRAPH} sweeps and {ITERS_GRAPH} fit steps (global "
          f"rigidity until {cfg.stop_global_rigidity}), eager then captured "
          "from one seed", flush=True)
    runs = {}
    for mode in ("eager", "captured"):
        eager = mode == "eager"
        pre_graphs, fit_graphs = FitGraphs(eager=eager), FitGraphs(eager=eager)
        params = {k: [{kk: t.detach().clone().requires_grad_()
                       for kk, t in layer.items()} for layer in v]
                  for k, v in init.items()}
        g_pre = torch.Generator(device=device).manual_seed(1)
        g_fit = torch.Generator(device=device).manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        pretrain_mapping(params["mapping1"], specs.mapping1, g_pre, T, H, W,
                         cfg.uv_mapping_scale, PRETRAIN_GRAPH,
                         graphs=pre_graphs)
        torch.cuda.synchronize()
        t_pretrain = time.time() - t0
        reset_counters()
        t0 = time.time()
        res = fit_atlas(params, specs, data, cfg, g_fit, graphs=fit_graphs)
        torch.cuda.synchronize()
        t_fit = time.time() - t0
        launches = read_counters()
        if launches["fwd"] != 2 * ITERS_GRAPH or launches["bwd"] != 2 * ITERS_GRAPH:
            raise AssertionError(f"{mode} fit launched {launches}")
        runs[mode] = {
            "params": [q.detach().clone() for q in flat_params(params)],
            "opt": res.opt_state, "logs": res.logs,
            "gens": (g_pre.get_state(), g_fit.get_state()),
            "t_pretrain": t_pretrain,
            "pretrain_steps_per_sec": PRETRAIN_GRAPH * T / t_pretrain,
            "t_fit": t_fit, "iters_per_sec": ITERS_GRAPH / t_fit,
            "graphs_captured": pre_graphs.captured + fit_graphs.captured,
            "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
    a, b = runs["eager"], runs["captured"]
    same = (all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
            and a["logs"] == b["logs"]
            and a["opt"]["step"] == b["opt"]["step"] == ITERS_GRAPH
            and all(np.array_equal(x, y) for k in ("exp_avg", "exp_avg_sq")
                    for x, y in zip(a["opt"][k], b["opt"][k]))
            and all(torch.equal(x, y) for x, y in zip(a["gens"], b["gens"])))
    if not same:
        raise AssertionError("the captured fit differs from the eager fit")
    if (a["graphs_captured"], b["graphs_captured"]) != (0, 3):
        raise AssertionError("graphs captured eager / captured: "
                             f"{a['graphs_captured']} / {b['graphs_captured']}, "
                             "want 0 / 3 (the pretrain's, two fit phases)")
    keys = ("t_pretrain", "pretrain_steps_per_sec", "t_fit", "iters_per_sec",
            "graphs_captured", "peak_mem_gib")
    out = {"bit_equal": same, "chunks": len(a["logs"]),
           **{mode: {k: r[k] for k in keys} for mode, r in runs.items()}}
    print("[fit-graphs] " + json.dumps(out), flush=True)
    return out


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


def phase_raft_profile(device, frames: Path, solves: int = 10) -> None:
    """Where a flow solve's time goes: `RAFTFlow.compute_batch` on one batch
    of the clip (4 pairs x 2 directions at 432x768, 20 iterations, bf16),
    upload and download included, with each correlation body (band,
    shared, resident), eagerly (`capture=False`) and captured (one engine
    whose graphs of the three bodies stay kept: its first call per body
    solves eagerly and captures, its later calls replay).  Per body: both
    engines' first calls, then `solves` solves timed plain in the order
    eager, captured, captured, eager, then `solves` of each under
    torch.profiler.  The captured flow must equal the eager flow bit for
    bit, and each profile must hold the body's 20 lookups a solve."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.flow import RAFTFlow, load_flow_image
    from deflicker_torch.io.media import list_frames

    files = list_frames(frames)[:PAIR_BATCH + 1]
    ims = [load_flow_image(f) for f in files]
    a = np.stack(ims[:-1] + ims[1:])
    b = np.stack(ims[1:] + ims[:-1])
    engines = {"eager": RAFTFlow(WORK / "raft-random.pth", device=device,
                                 capture=False),
               "captured": RAFTFlow(WORK / "raft-random.pth", device=device)}
    switches = {"band": {}, "shared": {"DEFLICKER_CORR_SHARED": "1"},
                "resident": {"DEFLICKER_CORR_RESIDENT": "1"}}

    def timed(engine, n=solves):
        """(seconds of n solves, the device synchronised around them, the
        last flow)."""
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(n):
            flow = engine.compute_batch(a, b)
        torch.cuda.synchronize()
        return time.time() - t0, flow

    for body, values in switches.items():
        flows, first_ms = {}, {}
        walls = {mode: [] for mode in engines}
        with env(**values):
            for mode, engine in engines.items():   # warm-up (and capture)
                first_ms[mode] = 1e3 * timed(engine, 1)[0]
            for mode in ("eager", "captured", "captured", "eager"):
                wall, flows[mode] = timed(engines[mode])
                walls[mode].append(wall)
            for mode, engine in engines.items():
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    wall, _ = timed(engine)
                lookups = sum(n for _, n, name in device_events(prof)
                              if "corr_lookup" in name)
                if lookups != RAFT_ITERS * solves:
                    raise AssertionError(f"the {mode} {body} profile holds "
                                         f"{lookups} lookups, want "
                                         f"{RAFT_ITERS * solves}")
                report_profile(f"raft-profile-{body}-{mode}", "solve", solves,
                               sum(walls[mode]) / 2, wall, prof)
        same = np.array_equal(flows["eager"], flows["captured"])
        print(f"[raft-profile-{body}] " + json.dumps({
            "bit_equal": same, "first_call_ms": first_ms,
            "window_solve_ms": {m: [1e3 * w / solves for w in ws]
                                for m, ws in walls.items()},
            "graphs_captured": engines["captured"].graphs.captured}),
            flush=True)
        if not same:
            raise AssertionError(f"the captured {body} solve differs from "
                                 "the eager one")
    if engines["captured"].graphs.captured != 3:
        raise AssertionError("graphs captured "
                             f"{engines['captured'].graphs.captured}, want 3 "
                             "(one a body)")


def span_seconds(spans, prefix: str) -> dict:
    """Host seconds of the logged spans named `prefix<part>`, by part."""
    out = {}
    for name, _, t0, t1 in spans:
        if name.startswith(prefix):
            part = name[len(prefix):]
            out[part] = out.get(part, 0.0) + (t1 - t0) * 1e-9
    return out


def phase_stage2_profile(device, frames: Path) -> dict:
    """Where configuration 1's `t_stage2` goes: `FilterEngine.run` on the
    pipeline phase's 80 frames and stage-1 output (432x768, shipped
    weights, bf16, as `run_stage2` runs it but returning the refined
    frames), split by part through the engine's `stage2/` spans: reader
    wait, U-Net, refinement, device-to-host copies (the u8 conversions and
    the returned frames), writer wait, the three mp4 encodes.  `parts_s`
    are the spans' host walls (no sync at their edges: a part's queued
    device work may finish in a later part, and a captured refinement's
    kernels are not tied to the part that replayed them, so the device
    time is not split by part).  Run eagerly (`capture=False`), then
    captured (a fresh engine: its capture included), then captured again
    under torch.profiler for the stage's device time and idle share; the
    eager and captured refined frames must be bit-equal.
    Then one span's refinement alone (31 frames), timed eager, captured,
    captured, eager (wall ms a frame, synchronised), then each profiled
    (device ms a frame)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deflicker_torch.filter import FilterEngine, load_filter_engine
    from deflicker_torch.io.media import list_frames, read_image
    from deflicker_torch.ops.pad import Padder
    from deflicker_torch.utils import trace

    style = WORK / "results" / frames.name / "stage_1" / "output"
    ckpts = [ROOT / "pretrained_weights" / n for n in
             ("neural_filter.ckpt", "local_refinement_net.ckpt")]
    captured = load_filter_engine(*ckpts, device=device, dtype=torch.bfloat16)
    eager = FilterEngine(captured.unet, captured.tnet, device=device,
                         dtype=torch.bfloat16, capture=False)
    print(f"[stage2-profile] configuration 1's stage 2: {CLIP[0]} frames "
          f"{CLIP[1]}x{CLIP[2]}, shipped weights, bf16, span "
          f"{captured.span}, U-Net batch {captured.batch}; eager, captured, "
          "captured under the profiler", flush=True)
    runs, outs = {}, {}
    for tag, engine in (("eager", eager), ("captured", captured),
                        ("profiled", captured)):
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = engine.graphs.captured
        trace.clear()
        ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
               if tag == "profiled" else contextlib.nullcontext())
        with ctx as prof, trace.recording():
            t0 = time.time()
            outs[tag] = engine.run(frames, style, WORK / "results_s2" / tag)
            torch.cuda.synchronize(device)
            wall = time.time() - t0
        runs[tag] = {"t_stage2": wall,
                     "parts_s": span_seconds(trace.spans(), "stage2/"),
                     "graphs_captured": engine.graphs.captured - before,
                     "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30}
        if prof is not None:
            rows = device_events(prof)
            busy = sum(r[0] for r in rows) / 1e3
            runs[tag]["device_busy_ms"] = busy
            runs[tag]["idle_share"] = 1.0 - busy / (1e3 * runs["captured"]["t_stage2"])
            runs[tag]["device_ops"] = sum(r[1] for r in rows)
        print(f"[stage2-profile-{tag}] " + json.dumps(runs[tag]), flush=True)
    same = (np.array_equal(outs["eager"], outs["captured"])
            and np.array_equal(outs["eager"], outs["profiled"]))
    if not same or outs["eager"].shape[0] != CLIP[0]:
        raise AssertionError("captured stage 2 differs from the eager one")
    if [runs[t]["graphs_captured"] for t in runs] != [0, 1, 0]:
        raise AssertionError(f"refinement graphs captured {runs}")

    # one span's refinement alone: 31 frames after the first
    names = list_frames(frames)
    snames = list_frames(style)
    H, W = read_image(names[0]).shape[:2]
    padder = Padder(H, W, divisor=32, mode="other")
    content, sty = captured._load_span(names, snames, 0, captured.span, H, W)
    preds = captured._filter_all(content, sty, padder)
    body, carry = preds[None, 1:], (preds[:1], preds[:1])
    n = body.shape[1]
    engines = {"eager": eager, "captured": captured}
    walls, refined = {"eager": [], "captured": []}, {}
    for tag in ("eager", "captured", "captured", "eager"):
        torch.cuda.synchronize(device)
        t0 = time.time()
        _, refined[tag] = engines[tag].refine(carry, body, [n])
        torch.cuda.synchronize(device)
        walls[tag].append(time.time() - t0)
    step = {}
    for tag, engine in engines.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.refine(carry, body, [n])
            torch.cuda.synchronize(device)
        rows = device_events(prof)
        busy = sum(r[0] for r in rows) / 1e3
        wall = sum(walls[tag]) / 2
        step[tag] = {"frame_wall_ms": 1e3 * wall / n,
                     "window_frame_wall_ms": [1e3 * w / n for w in walls[tag]],
                     "frame_device_ms": busy / n,
                     "idle_share": 1.0 - busy / (1e3 * wall),
                     "device_ops_per_frame": sum(r[1] for r in rows) / n}
    step_same = torch.equal(refined["eager"], refined["captured"])
    if not step_same:
        raise AssertionError("the captured refinement step differs")
    summary = {"bit_equal": same and step_same, "frames": CLIP[0],
               "refine_span_frames": n, "refine_step": step,
               "engine_graphs_captured": captured.graphs.captured}
    print("[stage2-profile] " + json.dumps(summary), flush=True)
    return runs


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
    phase_fit_graphs(device, frames, atlas_cfg)
    print(f"[fit-graphs] wall {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    raft_launches = phase_raft_pipeline(device, frames)
    print(f"[raft-pipeline] wall {time.time() - t1:.1f} s", flush=True)
    phase_raft_profile(device, frames)
    t1 = time.time()
    phase_stage2_profile(device, frames)
    print(f"[stage2-profile] wall {time.time() - t1:.1f} s", flush=True)
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
    t1 = time.time()
    phase_serve(device)
    print(f"[serve] wall {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    phase_train(device)
    print(f"[train] wall {time.time() - t1:.1f} s", flush=True)
    t1 = time.time()
    phase_parallel(device, frames, WORK / "data_raft" / f"{frames.name}_flow")
    print(f"[parallel] wall {time.time() - t1:.1f} s", flush=True)

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
        "ms": main_shape["ms"], "call_ms": main_shape["call_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "bound_f32_ms": main_shape["bound_f32_ms"],
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
            "ms": r["ms"], "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "bound_f32_ms": r["bound_f32_ms"], "library_ms": None, "per_shape": every,
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
