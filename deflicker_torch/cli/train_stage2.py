"""Train the stage-2 networks from scratch on a CUDA device (no pretrained
blobs needed).

    python -m deflicker_torch.cli.train_stage2 --out_dir pretrained_weights \
        [--filter_steps 4000] [--refine_steps 1500] [--size 128] [--gpu N] ...

The reference ships `neural_filter.pth` / `local_refinement_net.pth` only as
downloads; this CLI trains replacements (`neural_filter.ckpt`,
`local_refinement_net.ckpt`, which either package's `load_filter_engine`
reads) on procedural clips (deflicker_torch/train).  Pass them to the
pipeline with `--ckpt_filter` / `--ckpt_local`.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train stage-2 networks")
    p.add_argument("--out_dir", type=str, default="pretrained_weights")
    p.add_argument("--filter_steps", type=int, default=4000)
    p.add_argument("--refine_steps", type=int, default=1500)
    p.add_argument("--size", type=int, default=128,
                   help="square training resolution (multiple of 32)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--clip_len", type=int, default=6)
    p.add_argument("--clip_batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"],
                   help="cosine: 3%% warmup then decay to lr/20, for long "
                        "runs (constant-LR Adam plateaus at an LR-bound "
                        "noise floor)")
    p.add_argument("--temporal_weight", type=float, default=2.0)
    p.add_argument("--p_layer", type=float, default=0.0,
                   help="probability of an independently moving foreground "
                        "layer per clip (layered flow with occlusions; "
                        "default 0 = the shipped weights' recipe)")
    p.add_argument("--corr_flicker", action="store_true",
                   help="AR(1)-correlated flicker series instead of iid "
                        "(for drifting-exposure footage)")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps_per_call", type=int, default=50)
    p.add_argument("--texture_dir", type=str, default=None,
                   help="optional directory of frames/images to mix in as "
                        "real-image textures (exact-flow affine clips)")
    p.add_argument("--texture_mix", type=float, default=0.5,
                   help="probability of a real-image clip per step when "
                        "--texture_dir is given")
    p.add_argument("--gpu", type=int, default=0,
                   help="CUDA device index: runs on cuda:N")
    return p


def main(argv=None, device=None) -> int:
    """`device` overrides `cuda:<--gpu>` (the tests pass "cpu")."""
    import time

    from ..train import TrainConfig, train_stage2
    from ..utils.device import resolve_device, set_fp32_matmul_precision

    args = build_parser().parse_args(argv)
    device = resolve_device(f"cuda:{args.gpu}" if device is None else device)
    set_fp32_matmul_precision()
    cfg = TrainConfig(height=args.size, width=args.size,
                      filter_steps=args.filter_steps,
                      refine_steps=args.refine_steps, batch=args.batch,
                      clip_len=args.clip_len, clip_batch=args.clip_batch,
                      learning_rate=args.lr, lr_schedule=args.lr_schedule,
                      temporal_weight=args.temporal_weight,
                      texture_mix=args.texture_mix, p_layer=args.p_layer,
                      corr_flicker=args.corr_flicker, dtype=args.dtype,
                      seed=args.seed, steps_per_call=args.steps_per_call)
    bank = None
    if args.texture_dir:
        from ..train.synth import load_texture_bank

        bank = load_texture_bank(args.texture_dir, 2 * args.size,
                                 2 * args.size)
        print(f"texture bank: {0 if bank is None else bank.shape[0]} images "
              f"from {args.texture_dir}")
    t0 = time.perf_counter()
    last = {"t": t0}

    def log(name, step, rec):
        now = time.perf_counter()
        rate = args.steps_per_call / max(now - last["t"], 1e-9)
        last["t"] = now
        print(f"[{name}] step {step}: "
              + " ".join(f"{k}={v:.4f}" for k, v in rec.items())
              + f" ({rate:.1f} it/s)", flush=True)

    fpath, lpath = train_stage2(cfg, args.out_dir, log, texture_bank=bank,
                                device=device)
    print(f"done in {time.perf_counter() - t0:.0f}s -> {fpath}, {lpath}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
