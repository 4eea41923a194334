"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches them (the CPU tests, and `calibrate.py` on the
card at the cells' own sizes).  Each is a context manager that patches the
program while it is open.

Fit cells: `state_unchanged` (every optimizer step leaves the parameters
as they were), `half_batch` (the loss takes the first half of the sampled
pixels and its means over them).  Flow cells: `state_unchanged` (the GRU
step returns its state and no flow update), `half_batch` (a solve runs the
first half of its directions and returns zeros for the rest),
`answer_altered` (one direction's flow, where it is produced, one pixel
off in x).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def fit_state_unchanged():
    def make(step):
        def frozen(self, *args, **kwargs):
            params = [p for g in self.param_groups for p in g["params"]]
            saved = [p.detach().clone() for p in params]
            out = step(self, *args, **kwargs)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return out
        return frozen
    return _patched(torch.optim.Adam, "step", make)


def fit_half_batch():
    from deflicker_torch.atlas import engine

    def make(make_loss_fn):
        def half(*args, **kwargs):
            loss_fn = make_loss_fn(*args, **kwargs)

            def on_half(params, packed, j, i, f, norm=None):
                n = j.shape[-1] // 2
                return loss_fn(params, packed, j[..., :n], i[..., :n],
                               f[..., :n], norm)
            return on_half
        return half
    return _patched(engine, "make_loss_fn", make)


def flow_state_unchanged():
    from deflicker_torch.models import raft

    def make(forward):
        def frozen(self, net, inp, corr, flow):
            return net, torch.zeros_like(flow)
        return frozen
    return _patched(raft.BasicUpdateBlock, "forward", make)


def flow_half_batch():
    from deflicker_torch.flow.engine import RAFTFlow

    def make(solve):
        def half(self, x1, x2):
            h = max(1, x1.shape[0] // 2)
            out = solve(self, x1[:h].contiguous(), x2[:h].contiguous())
            rest = torch.zeros((x1.shape[0] - h,) + tuple(out.shape[1:]),
                               dtype=out.dtype, device=out.device)
            return torch.cat([out, rest])
        return half
    return _patched(RAFTFlow, "_solve", make)


def flow_answer_altered():
    from deflicker_torch.flow.engine import RAFTFlow

    def make(compute_batch):
        def altered(self, im1, im2):
            flows = compute_batch(self, im1, im2)
            flows[0, ..., 0] += 1.0
            return flows
        return altered
    return _patched(RAFTFlow, "compute_batch", make)


FAULTS = {"fit": {"state_unchanged": fit_state_unchanged,
                  "half_batch": fit_half_batch},
          "flow": {"state_unchanged": flow_state_unchanged,
                   "half_batch": flow_half_batch,
                   "answer_altered": flow_answer_altered}}
