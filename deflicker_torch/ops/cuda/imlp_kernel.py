"""Fused IMLP linear-relu chain: CUDA kernels, their plain twins, autograd.

The CUDA source is `deflicker_torch/csrc/imlp_chain.cu` (its header says
which TPU kernels it replaces, its bound and its design).  This module:

  * `imlp_chain_fwd_cuda` / `imlp_chain_bwd_cuda` check their tensors,
    allocate outputs and scratch with `torch.empty`, launch on the current
    stream, raise on a non-zero `cudaGetLastError()`, and count launches in
    `launches["fwd"]` / `launches["bwd"]`;
  * `imlp_chain_fwd_plain` / `imlp_chain_bwd_plain` are the same arithmetic
    in plain PyTorch — bf16 operands emulated as `t.to(bf16).float()` so
    every product accumulates in f32 (a bf16 `torch.matmul` on the CPU rounds
    its output to bf16, which the kernel does not);
  * `fused_imlp_linear_chain` is the differentiable entry point.  It runs the
    plain version for CPU tensors and the kernels for CUDA tensors: there is
    no switch that sends CUDA tensors anywhere else.

Layouts follow the JAX package: x (B, E) is the already-encoded input,
weights are (in, out), and the output is the pre-tanh (B, out) chain.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

MAXL = 16
MAX_WIDTH = 256

# launches of each kernel wrapper (a bwd launch is the chain, dW and reduce
# kernels of one backward call)
launches = {"fwd": 0, "bwd": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _cast(t: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Round to the compute dtype and compute in f32 from there."""
    if compute_dtype == torch.float32:
        return t.float()
    return t.to(compute_dtype).float()


def _check_layers(E: int, weights: Sequence[torch.Tensor],
                  skip_layers: Sequence[int]) -> None:
    for i, w in enumerate(weights):
        kept = E if i == 0 else weights[i - 1].shape[1]
        want = kept + (E if (i > 0 and i in skip_layers) else 0)
        if w.dim() != 2 or w.shape[0] != want:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not take "
                             f"{want} inputs")


def imlp_chain_fwd_plain(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         skip_layers: Sequence[int],
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Pre-tanh chain output (B, out) — `_fwd_kernel` through `_layer_fwd`
    (v2 split skip) of the TPU kernel, in plain PyTorch."""
    _check_layers(xe.shape[1], weights, skip_layers)
    xc = _cast(xe, compute_dtype)
    h = xe.float()
    for i, (w, b) in enumerate(zip(weights, biases)):
        if i == 0:
            h = xc @ _cast(w, compute_dtype) + b.float()
            continue
        a = _cast(torch.relu(h), compute_dtype)
        if i in skip_layers:
            d = a.shape[1]
            h = (a @ _cast(w[:d], compute_dtype)
                 + xc @ _cast(w[d:], compute_dtype) + b.float())
        else:
            h = a @ _cast(w, compute_dtype) + b.float()
    return h


def imlp_chain_bwd_plain(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         skip_layers: Sequence[int], g: torch.Tensor,
                         need_dx: bool = True, compute_dtype=torch.bfloat16
                         ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                    List[torch.Tensor]]:
    """(dx, [dW_i], [db_i]) of the pre-tanh chain for output gradient g —
    the remat backward (`_bwd_kernel` + `_reverse_pass`, v2) in plain
    PyTorch: recompute the post-relu activations in the compute dtype, then
    dW_i = a_iᵀ·g_i, db_i = Σ g_i (f32), g ← (g_i·W_keptᵀ)·(a_i > 0); the
    skip branch of a skip layer gets no gradient."""
    _check_layers(xe.shape[1], weights, skip_layers)
    n = len(weights)
    xc = _cast(xe, compute_dtype)
    stash: List[Optional[torch.Tensor]] = [None] * n
    h = xe.float()
    for i in range(n - 1):
        w, b = weights[i], biases[i]
        if i == 0:
            h = xc @ _cast(w, compute_dtype) + b.float()
        else:
            a = stash[i]
            if i in skip_layers:
                d = a.shape[1]
                h = (a @ _cast(w[:d], compute_dtype)
                     + xc @ _cast(w[d:], compute_dtype) + b.float())
            else:
                h = a @ _cast(w, compute_dtype) + b.float()
        stash[i + 1] = _cast(torch.relu(h), compute_dtype)

    g = g.float()
    dWs: List[torch.Tensor] = [None] * n
    dbs: List[torch.Tensor] = [None] * n
    dx = None
    for i in reversed(range(n)):
        w = weights[i]
        gc = _cast(g, compute_dtype)
        dbs[i] = g.sum(0)
        a_h = xc if i == 0 else stash[i]
        if i in skip_layers:
            dWs[i] = torch.cat([a_h.t() @ gc, xc.t() @ gc], dim=0)
            wk = w[:a_h.shape[1]]
        else:
            dWs[i] = a_h.t() @ gc
            wk = w
        if i == 0:
            if need_dx:
                dx = gc @ _cast(wk, compute_dtype).t()
            break
        g = (gc @ _cast(wk, compute_dtype).t()) * (stash[i] > 0)
    return dx, dWs, dbs


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

class _ChainDesc(ctypes.Structure):
    """Mirror of `struct ChainDesc` in csrc/imlp_chain.cu."""

    _fields_ = [("n_layers", ctypes.c_int), ("E", ctypes.c_int),
                ("in_dim", ctypes.c_int * MAXL),
                ("out_dim", ctypes.c_int * MAXL),
                ("skip", ctypes.c_int * MAXL),
                ("W", ctypes.c_void_p * MAXL),
                ("b", ctypes.c_void_p * MAXL)]


def _library():
    from .build import load

    lib = load("imlp_chain")
    if not getattr(lib, "_deflicker_typed", False):
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        lib.imlp_chain_bwd_scratch_bytes.argtypes = [P, I]
        lib.imlp_chain_bwd_scratch_bytes.restype = S
        lib.imlp_chain_fwd.argtypes = [P, P, P, I, P]
        lib.imlp_chain_fwd.restype = I
        lib.imlp_chain_bwd.argtypes = [P, P, P, P, P, I, P, P]
        lib.imlp_chain_bwd.restype = I
        lib._deflicker_typed = True
    return lib


def _desc(xe: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[torch.Tensor],
          skip_layers: Sequence[int]) -> _ChainDesc:
    if not xe.is_cuda:
        raise ValueError("the CUDA chain kernel needs CUDA tensors")
    if xe.dtype != torch.float32 or xe.dim() != 2 or not xe.is_contiguous():
        raise ValueError("x must be a contiguous (B, E) float32 tensor")
    n = len(weights)
    if not 1 <= n <= MAXL or len(biases) != n:
        raise ValueError(f"need 1..{MAXL} layers with one bias each")
    E = xe.shape[1]
    if E > MAX_WIDTH:
        raise ValueError(f"input width {E} > {MAX_WIDTH}")
    _check_layers(E, weights, skip_layers)
    d = _ChainDesc()
    d.n_layers, d.E = n, E
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dtype != torch.bfloat16 or not w.is_contiguous() \
                or w.device != xe.device:
            raise ValueError(f"layer {i}: weight must be contiguous bf16 on "
                             f"{xe.device}")
        if b.dtype != torch.float32 or not b.is_contiguous() \
                or b.shape != (w.shape[1],) or b.device != xe.device:
            raise ValueError(f"layer {i}: bias must be contiguous f32 "
                             f"({w.shape[1]},) on {xe.device}")
        if w.shape[1] > MAX_WIDTH:
            raise ValueError(f"layer {i}: width {w.shape[1]} > {MAX_WIDTH}")
        if i == 0 and 0 in skip_layers:
            raise ValueError("layer 0 cannot be a skip layer")
        d.in_dim[i], d.out_dim[i] = w.shape
        d.skip[i] = int(i > 0 and i in skip_layers)
        d.W[i] = w.data_ptr()
        d.b[i] = b.data_ptr()
    return d


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def imlp_chain_fwd_cuda(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        skip_layers: Sequence[int]) -> torch.Tensor:
    """Forward kernel launch: xe (B, E) f32, bf16 (in, out) weights, f32
    biases, all contiguous on one CUDA device -> (B, out) f32."""
    d = _desc(xe, weights, biases, skip_layers)
    B = xe.shape[0]
    out = torch.empty((B, weights[-1].shape[1]), dtype=torch.float32,
                      device=xe.device)
    if B == 0:
        return out
    lib = _library()
    err = lib.imlp_chain_fwd(ctypes.byref(d), xe.data_ptr(), out.data_ptr(),
                             B, _stream(xe.device))
    _raise_on(err, "imlp_chain_fwd")
    launches["fwd"] += 1
    return out


def imlp_chain_bwd_cuda(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        skip_layers: Sequence[int], g: torch.Tensor,
                        need_dx: bool = True
                        ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                   List[torch.Tensor]]:
    """Backward kernel launch (remat): same operands as the forward plus the
    output gradient g (B, out) f32 -> (dx or None, [dW_i], [db_i]), f32."""
    d = _desc(xe, weights, biases, skip_layers)
    B = xe.shape[0]
    O = weights[-1].shape[1]
    if g.dtype != torch.float32 or g.shape != (B, O) or not g.is_contiguous() \
            or g.device != xe.device:
        raise ValueError(f"g must be a contiguous ({B}, {O}) float32 tensor "
                         f"on {xe.device}")
    shapes = [tuple(w.shape) for w in weights]
    n_w = sum(a * b for a, b in shapes)
    grads = torch.empty(n_w + sum(b for _, b in shapes), dtype=torch.float32,
                        device=xe.device)
    dx = (torch.empty((B, xe.shape[1]), dtype=torch.float32, device=xe.device)
          if need_dx else None)
    if B == 0:
        grads.zero_()
        if dx is not None:
            dx.zero_()
    else:
        lib = _library()
        scratch = torch.empty(
            lib.imlp_chain_bwd_scratch_bytes(ctypes.byref(d), B),
            dtype=torch.uint8, device=xe.device)
        err = lib.imlp_chain_bwd(
            ctypes.byref(d), xe.data_ptr(), g.data_ptr(),
            dx.data_ptr() if dx is not None else None, grads.data_ptr(), B,
            scratch.data_ptr(), _stream(xe.device))
        _raise_on(err, "imlp_chain_bwd")
        launches["bwd"] += 1
    dWs, dbs, off = [], [], 0
    for a, b in shapes:
        dWs.append(grads[off:off + a * b].view(a, b))
        off += a * b
    for _, b in shapes:
        dbs.append(grads[off:off + b])
        off += b
    return dx, dWs, dbs


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedChain(torch.autograd.Function):
    """The custom VJP of `_chain` (imlp_kernel.py:384-501) as an autograd
    Function: kernels for CUDA tensors, the plain twins for CPU tensors."""

    @staticmethod
    def forward(ctx, xe, skip_layers, compute_dtype, *params):
        ws, bs = list(params[0::2]), list(params[1::2])
        if xe.is_cuda:
            if compute_dtype != torch.bfloat16:
                raise ValueError("the CUDA chain kernel computes in bfloat16 "
                                 f"only, got {compute_dtype}")
            xe = xe.float().contiguous()
            ws = [w.to(torch.bfloat16).contiguous() for w in ws]
            bs = [b.float().contiguous() for b in bs]
            out = imlp_chain_fwd_cuda(xe, ws, bs, skip_layers)
        else:
            out = imlp_chain_fwd_plain(xe, ws, bs, skip_layers, compute_dtype)
        ctx.save_for_backward(xe, *ws, *bs)
        ctx.skip_layers = tuple(skip_layers)
        ctx.compute_dtype = compute_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        xe, *rest = ctx.saved_tensors
        n = len(rest) // 2
        ws, bs = rest[:n], rest[n:]
        need_dx = ctx.needs_input_grad[0]
        if xe.is_cuda:
            dx, dWs, dbs = imlp_chain_bwd_cuda(
                xe, ws, bs, ctx.skip_layers, g.float().contiguous(), need_dx)
        else:
            dx, dWs, dbs = imlp_chain_bwd_plain(
                xe, ws, bs, ctx.skip_layers, g, need_dx, ctx.compute_dtype)
        grads = []
        for dW, db in zip(dWs, dbs):
            grads += [dW, db]
        return (dx, None, None, *grads)


def fused_imlp_linear_chain(params, xe: torch.Tensor,
                            skip_layers: Sequence[int] = (),
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Differentiable fused chain on PRE-ENCODED input xe (B, E): returns the
    pre-tanh output (B, out).  params: list of {"w": (in, out), "b": (out,)}.
    A ragged B needs no padding: the kernel masks the edge tile."""
    flat = []
    for layer in params:
        flat += [layer["w"], layer["b"]]
    return _FusedChain.apply(xe, tuple(skip_layers), compute_dtype, *flat)
