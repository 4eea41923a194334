"""Fused IMLP linear-relu chain: CUDA kernels, their plain twins, autograd.

The CUDA source is `deflicker_torch/csrc/imlp_chain.cu` (its header says
which TPU kernels it replaces, its bound and its design).  This module:

  * `imlp_chain_fwd_cuda` / `imlp_chain_bwd_cuda` (the remat pair: the
    backward recomputes the activations into its scratch, then runs the
    stash backward's launches on them) and `imlp_chain_fwd_stash_cuda` /
    `imlp_chain_bwd_stash_cuda` (the stash pair: the forward also writes the
    bf16 post-relu input of layers 1..n-1 to one buffer that autograd keeps,
    the backward reads it) check their tensors, allocate outputs, stash and
    scratch with `torch.empty`, launch on the current stream of the
    tensors' card with that card current (`torch.cuda.device`), raise on a
    non-zero `cudaGetLastError()`, and count launches in `launches["fwd"]`,
    `["bwd"]`, `["fwd_stash"]`, `["bwd_stash"]` (and, for calls with a
    video axis, `["fwd_v"]`, `["bwd_v"]`, `["fwd_stash_v"]`,
    `["bwd_stash_v"]`);
  * `imlp_chain_fwd_plain` / `imlp_chain_bwd_plain` and
    `imlp_chain_fwd_stash_plain` / `imlp_chain_bwd_stash_plain` are the same
    arithmetic in plain PyTorch — bf16 operands emulated as
    `t.to(bf16).float()` so every product accumulates in f32 (a bf16
    `torch.matmul` on the CPU rounds its output to bf16, which the kernel
    does not).  Both pairs share one forward and one reverse pass, so stash
    gradients equal remat gradients bit for bit;
  * `fused_imlp_linear_chain` is the differentiable entry point
    (`stash_bwd` picks the pair).  It runs the plain version for CPU tensors
    and the kernels for CUDA tensors: there is no switch that sends CUDA
    tensors anywhere else.

Layouts follow the JAX package: x (B, E) is the already-encoded input,
weights are (in, out), and the output is the pre-tanh (B, out) chain.  Every
function also takes a leading video axis — x (V, B, E), weights (V, in,
out), biases (V, out) — for V independent chains of one shape: the
multi-video fit's counterpart of `jax.vmap` over the Pallas chain.  The
kernels run all V in one launch; the plain twins loop over the videos, so a
V-video twin equals V one-video twins bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

MAXL = 16
MAX_WIDTH = 256

# launches of each kernel wrapper (a bwd launch is one backward call: the
# recompute (remat only), reverse-pass, dW and reduce kernels); "_v": calls
# with a video axis, one launch for all V videos
launches = {"fwd": 0, "bwd": 0, "fwd_stash": 0, "bwd_stash": 0,
            "fwd_v": 0, "bwd_v": 0, "fwd_stash_v": 0, "bwd_stash_v": 0}


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
                  skip_layers: Sequence[int], lead: tuple = ()) -> None:
    for i, w in enumerate(weights):
        kept = E if i == 0 else weights[i - 1].shape[-1]
        want = kept + (E if (i > 0 and i in skip_layers) else 0)
        if w.dim() != 2 + len(lead) or w.shape[:-2] != lead or w.shape[-2] != want:
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} does not take "
                             f"{want} inputs (video axis {lead})")


def _per_video(fn, xe, weights, biases, skip_layers, *per_video_args, **kw):
    """fn over each video of a (V, B, E) call (per_video_args also carry the
    video axis; a list argument is split element by element)."""
    outs = []
    for v in range(xe.shape[0]):
        args = [[t[v] for t in a] if isinstance(a, (list, tuple)) else a[v]
                for a in per_video_args]
        outs.append(fn(xe[v], [w[v] for w in weights], [b[v] for b in biases],
                       skip_layers, *args, **kw))
    return outs


def _stack(items):
    """Stack per-video results: tensors, None, or lists of tensors."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    return [_stack(list(col)) for col in zip(*items)]


def _forward_plain(xe, weights, biases, skip_layers, compute_dtype,
                   last: bool):
    """The chain's forward: (xc, stash, h) with xc the cast input, stash[i]
    (i = 1..n-1) the cast post-relu, pre-concat input of layer i, and h the
    f32 output of the last layer run — layer n-1 when `last`, else layer
    n-2 (the remat backward does not need the chain's output)."""
    _check_layers(xe.shape[1], weights, skip_layers)
    n = len(weights)
    xc = _cast(xe, compute_dtype)
    stash: List[Optional[torch.Tensor]] = [None] * n
    h = xe.float()
    for i, (w, b) in enumerate(zip(weights, biases)):
        if i > 0:
            stash[i] = _cast(torch.relu(h), compute_dtype)
        if i == n - 1 and not last:
            break
        if i == 0:
            h = xc @ _cast(w, compute_dtype) + b.float()
        elif i in skip_layers:
            a = stash[i]
            d = a.shape[1]
            h = (a @ _cast(w[:d], compute_dtype)
                 + xc @ _cast(w[d:], compute_dtype) + b.float())
        else:
            h = stash[i] @ _cast(w, compute_dtype) + b.float()
    return xc, stash, h


def _reverse_plain(xc, weights, skip_layers, stash, g, need_dx, compute_dtype):
    """The reverse pass (`_reverse_pass`, v2) from the cast input and the
    stash: dW_i = a_iᵀ·g_i, db_i = Σ g_i (f32), g ← (g_i·W_keptᵀ)·(a_i > 0);
    the skip branch of a skip layer gets no gradient."""
    n = len(weights)
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


def imlp_chain_fwd_plain(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         skip_layers: Sequence[int],
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Pre-tanh chain output (B, out) — `_fwd_kernel` through `_layer_fwd`
    (v2 split skip) of the TPU kernel, in plain PyTorch.  With a video axis:
    (V, B, out), video by video."""
    if xe.dim() == 3:
        return _stack(_per_video(imlp_chain_fwd_plain, xe, weights, biases,
                                 skip_layers, compute_dtype=compute_dtype))
    return _forward_plain(xe, weights, biases, skip_layers, compute_dtype,
                          last=True)[2]


def imlp_chain_bwd_plain(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                         biases: Sequence[torch.Tensor],
                         skip_layers: Sequence[int], g: torch.Tensor,
                         need_dx: bool = True, compute_dtype=torch.bfloat16
                         ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                    List[torch.Tensor]]:
    """(dx, [dW_i], [db_i]) of the pre-tanh chain for output gradient g —
    the remat backward (`_bwd_kernel` + `_reverse_pass`, v2) in plain
    PyTorch: recompute the post-relu activations in the compute dtype, then
    walk the chain in reverse.  With a video axis, every result gains it."""
    if xe.dim() == 3:
        outs = _per_video(imlp_chain_bwd_plain, xe, weights, biases,
                          skip_layers, g, need_dx=need_dx,
                          compute_dtype=compute_dtype)
        return tuple(_stack([o[k] for o in outs]) for k in range(3))
    xc, stash, _ = _forward_plain(xe, weights, biases, skip_layers,
                                  compute_dtype, last=False)
    return _reverse_plain(xc, weights, skip_layers, stash, g, need_dx,
                          compute_dtype)


def imlp_chain_fwd_stash_plain(xe: torch.Tensor,
                               weights: Sequence[torch.Tensor],
                               biases: Sequence[torch.Tensor],
                               skip_layers: Sequence[int],
                               compute_dtype=torch.bfloat16
                               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(out, stash) — `_fwd_kernel_stash` in plain PyTorch: the chain output
    and, for layers 1..n-1, the (B, width) post-relu, pre-concat input in
    the compute dtype (held as f32 values), the very cast the remat backward
    makes.  With a video axis, every result gains it."""
    if xe.dim() == 3:
        outs = _per_video(imlp_chain_fwd_stash_plain, xe, weights, biases,
                          skip_layers, compute_dtype=compute_dtype)
        return _stack([o[0] for o in outs]), _stack([o[1] for o in outs])
    _, stash, h = _forward_plain(xe, weights, biases, skip_layers,
                                 compute_dtype, last=True)
    return h, stash[1:]


def imlp_chain_bwd_stash_plain(xe: torch.Tensor,
                               weights: Sequence[torch.Tensor],
                               biases: Sequence[torch.Tensor],
                               skip_layers: Sequence[int],
                               stash: Sequence[torch.Tensor], g: torch.Tensor,
                               need_dx: bool = True,
                               compute_dtype=torch.bfloat16
                               ) -> Tuple[Optional[torch.Tensor],
                                          List[torch.Tensor],
                                          List[torch.Tensor]]:
    """(dx, [dW_i], [db_i]) from the forward's stash, no recompute —
    `_bwd_kernel_stash` in plain PyTorch.  The skip input is cast again
    from xe.  With a video axis, the stash and every result gain it."""
    if xe.dim() == 3:
        outs = _per_video(imlp_chain_bwd_stash_plain, xe, weights, biases,
                          skip_layers, list(stash), g, need_dx=need_dx,
                          compute_dtype=compute_dtype)
        return tuple(_stack([o[k] for o in outs]) for k in range(3))
    _check_layers(xe.shape[1], weights, skip_layers)
    if len(stash) != len(weights) - 1:
        raise ValueError(f"need {len(weights) - 1} stash layers, "
                         f"got {len(stash)}")
    return _reverse_plain(_cast(xe, compute_dtype), weights, skip_layers,
                          [None, *(a.float() for a in stash)], g, need_dx,
                          compute_dtype)


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
        lib.imlp_chain_fwd.argtypes = [P, P, P, I, I, P]
        lib.imlp_chain_fwd.restype = I
        lib.imlp_chain_bwd.argtypes = [P, P, P, P, P, I, I, P, P]
        lib.imlp_chain_bwd.restype = I
        lib.imlp_chain_bwd_stash_scratch_bytes.argtypes = [P, I]
        lib.imlp_chain_bwd_stash_scratch_bytes.restype = S
        lib.imlp_chain_stash_elems.argtypes = [P, I]
        lib.imlp_chain_stash_elems.restype = S
        lib.imlp_chain_fwd_stash.argtypes = [P, P, P, P, I, I, P]
        lib.imlp_chain_fwd_stash.restype = I
        lib.imlp_chain_bwd_stash.argtypes = [P, P, P, P, P, P, I, I, P, P]
        lib.imlp_chain_bwd_stash.restype = I
        lib.imlp_chain_bwd_pieces.argtypes = [P, P, P, P, P, P, I, I, P, P, I, I]
        lib.imlp_chain_bwd_pieces.restype = I
        lib.imlp_chain_dw_slice_rows.argtypes = [P, I]
        lib.imlp_chain_dw_slice_rows.restype = I
        IP = ctypes.POINTER(ctypes.c_int)
        lib.imlp_chain_kernel_attrs.argtypes = [I, IP, IP, IP]
        lib.imlp_chain_kernel_attrs.restype = I
        lib._deflicker_typed = True
    return lib


def _desc(xe: torch.Tensor, weights: Sequence[torch.Tensor],
          biases: Sequence[torch.Tensor],
          skip_layers: Sequence[int]) -> _ChainDesc:
    """The kernels' description of a (B, E) or (V, B, E) call: every layer's
    weight (in, out) / bias (out,) carries the same video axis as x."""
    if not xe.is_cuda:
        raise ValueError("the CUDA chain kernel needs CUDA tensors")
    if xe.dtype != torch.float32 or xe.dim() not in (2, 3) \
            or not xe.is_contiguous():
        raise ValueError("x must be a contiguous (B, E) or (V, B, E) float32 "
                         "tensor")
    lead = tuple(xe.shape[:-2])
    n = len(weights)
    if not 1 <= n <= MAXL or len(biases) != n:
        raise ValueError(f"need 1..{MAXL} layers with one bias each")
    E = xe.shape[-1]
    if E > MAX_WIDTH:
        raise ValueError(f"input width {E} > {MAX_WIDTH}")
    _check_layers(E, weights, skip_layers, lead)
    d = _ChainDesc()
    d.n_layers, d.E = n, E
    for i, (w, b) in enumerate(zip(weights, biases)):
        if w.dtype != torch.bfloat16 or not w.is_contiguous() \
                or w.device != xe.device:
            raise ValueError(f"layer {i}: weight must be contiguous bf16 on "
                             f"{xe.device}")
        want = lead + (w.shape[-1],)
        if b.dtype != torch.float32 or not b.is_contiguous() \
                or tuple(b.shape) != want or b.device != xe.device:
            raise ValueError(f"layer {i}: bias must be contiguous f32 "
                             f"{want} on {xe.device}")
        if w.shape[-1] > MAX_WIDTH:
            raise ValueError(f"layer {i}: width {w.shape[-1]} > {MAX_WIDTH}")
        if i == 0 and 0 in skip_layers:
            raise ValueError("layer 0 cannot be a skip layer")
        d.in_dim[i], d.out_dim[i] = w.shape[-2:]
        d.skip[i] = int(i > 0 and i in skip_layers)
        d.W[i] = w.data_ptr()
        d.b[i] = b.data_ptr()
    return d


def _videos(xe: torch.Tensor) -> Tuple[tuple, int]:
    """(leading shape, V): ((), 1) for a 2-D call, ((V,), V) with a video
    axis."""
    return (tuple(xe.shape[:-2]), xe.shape[0] if xe.dim() == 3 else 1)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def _r16(v: int) -> int:
    return (v + 15) & ~15


def stash_views(stash: torch.Tensor, weights: Sequence[torch.Tensor],
                B: int) -> List[torch.Tensor]:
    """The (B, width) view of each layer 1..n-1 in the flat bf16 stash a
    stash forward wrote: B rows of r16(width) elements per layer, back to
    back, the padding columns zero.  (A call with a video axis returns a
    (V, n) stash; row v is video v's flat stash.)"""
    views, off = [], 0
    for w in weights[:-1]:
        width, wp = w.shape[1], _r16(w.shape[1])
        views.append(stash[off:off + B * wp].view(B, wp)[:, :width])
        off += B * wp
    return views


def _launch_fwd(xe, weights, biases, skip_layers, with_stash: bool):
    d = _desc(xe, weights, biases, skip_layers)
    lead, V = _videos(xe)
    B = xe.shape[-2]
    out = torch.empty(lead + (B, weights[-1].shape[-1]), dtype=torch.float32,
                      device=xe.device)
    n_stash = B * sum(_r16(w.shape[-1]) for w in weights[:-1])
    stash = (torch.empty(lead + (n_stash,), dtype=torch.bfloat16,
                         device=xe.device) if with_stash else None)
    if B == 0 or V == 0:
        return out, stash
    lib = _library()
    suffix = "_v" if lead else ""
    with torch.cuda.device(xe.device):
        if with_stash:
            err = lib.imlp_chain_fwd_stash(ctypes.byref(d), xe.data_ptr(),
                                           out.data_ptr(), stash.data_ptr(), B,
                                           V, _stream(xe.device))
        else:
            err = lib.imlp_chain_fwd(ctypes.byref(d), xe.data_ptr(),
                                     out.data_ptr(), B, V, _stream(xe.device))
    kind = "fwd_stash" if with_stash else "fwd"
    _raise_on(err, "imlp_chain_" + kind)
    launches[kind + suffix] += 1
    return out, stash


def imlp_chain_fwd_cuda(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        skip_layers: Sequence[int]) -> torch.Tensor:
    """Forward kernel launch: xe (B, E) f32, bf16 (in, out) weights, f32
    biases, all contiguous on one CUDA device -> (B, out) f32.  With a video
    axis (xe (V, B, E), weights (V, in, out), biases (V, out)) one launch
    runs all V chains -> (V, B, out)."""
    return _launch_fwd(xe, weights, biases, skip_layers, False)[0]


def imlp_chain_fwd_stash_cuda(xe: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor],
                              skip_layers: Sequence[int]
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stash forward kernel launch: the operands of `imlp_chain_fwd_cuda` ->
    (out (B, out) f32, stash): one flat bf16 buffer with the post-relu input
    of layers 1..n-1 (`stash_views` cuts it per layer)."""
    return _launch_fwd(xe, weights, biases, skip_layers, True)


def _launch_bwd(xe, weights, biases, skip_layers, g, need_dx,
                stash: Optional[torch.Tensor]):
    d = _desc(xe, weights, biases, skip_layers)
    lead, V = _videos(xe)
    B = xe.shape[-2]
    O = weights[-1].shape[-1]
    if g.dtype != torch.float32 or tuple(g.shape) != lead + (B, O) \
            or not g.is_contiguous() or g.device != xe.device:
        raise ValueError(f"g must be a contiguous {lead + (B, O)} float32 "
                         f"tensor on {xe.device}")
    if stash is not None:
        n_stash = lead + (B * sum(_r16(w.shape[-1]) for w in weights[:-1]),)
        if stash.dtype != torch.bfloat16 or tuple(stash.shape) != n_stash \
                or not stash.is_contiguous() or stash.device != xe.device:
            raise ValueError(f"stash must be the flat {n_stash} bfloat16 "
                             f"buffer of the stash forward on {xe.device}")
    shapes = [tuple(w.shape[-2:]) for w in weights]
    n_w = sum(a * b for a, b in shapes)
    grads = torch.empty(lead + (n_w + sum(b for _, b in shapes),),
                        dtype=torch.float32, device=xe.device)
    dx = (torch.empty(lead + (B, xe.shape[-1]), dtype=torch.float32,
                      device=xe.device) if need_dx else None)
    if B == 0 or V == 0:
        grads.zero_()
        if dx is not None:
            dx.zero_()
    else:
        lib = _library()
        dx_ptr = dx.data_ptr() if dx is not None else None
        suffix = "_v" if lead else ""
        query = (lib.imlp_chain_bwd_scratch_bytes if stash is None
                 else lib.imlp_chain_bwd_stash_scratch_bytes)
        scratch = torch.empty(V * query(ctypes.byref(d), B), dtype=torch.uint8,
                              device=xe.device)
        with torch.cuda.device(xe.device):
            if stash is None:
                err = lib.imlp_chain_bwd(
                    ctypes.byref(d), xe.data_ptr(), g.data_ptr(), dx_ptr,
                    grads.data_ptr(), B, V, scratch.data_ptr(),
                    _stream(xe.device))
            else:
                err = lib.imlp_chain_bwd_stash(
                    ctypes.byref(d), xe.data_ptr(), g.data_ptr(),
                    stash.data_ptr(), dx_ptr, grads.data_ptr(), B, V,
                    scratch.data_ptr(), _stream(xe.device))
        kind = "bwd" if stash is None else "bwd_stash"
        _raise_on(err, "imlp_chain_" + kind)
        launches[kind + suffix] += 1
    dWs, dbs, off = [], [], 0
    for a, b in shapes:
        dWs.append(grads.narrow(-1, off, a * b).view(lead + (a, b)))
        off += a * b
    for _, b in shapes:
        dbs.append(grads.narrow(-1, off, b))
        off += b
    return dx, dWs, dbs


def imlp_chain_bwd_cuda(xe: torch.Tensor, weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        skip_layers: Sequence[int], g: torch.Tensor,
                        need_dx: bool = True
                        ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor],
                                   List[torch.Tensor]]:
    """Backward kernel launch (remat): same operands as the forward plus the
    output gradient g (B, out) f32 -> (dx or None, [dW_i], [db_i]), f32.
    With a video axis, g and every result carry it (one launch)."""
    return _launch_bwd(xe, weights, biases, skip_layers, g, need_dx, None)


def imlp_chain_bwd_stash_cuda(xe: torch.Tensor,
                              weights: Sequence[torch.Tensor],
                              biases: Sequence[torch.Tensor],
                              skip_layers: Sequence[int],
                              stash: torch.Tensor, g: torch.Tensor,
                              need_dx: bool = True
                              ) -> Tuple[Optional[torch.Tensor],
                                         List[torch.Tensor],
                                         List[torch.Tensor]]:
    """Backward kernel launch (stash): the operands of `imlp_chain_bwd_cuda`
    plus the flat stash of `imlp_chain_fwd_stash_cuda` on the same operands;
    no recompute, gradients bit-identical to the remat backward's."""
    if stash is None:
        raise ValueError("the stash backward needs the stash of the stash "
                         "forward")
    return _launch_bwd(xe, weights, biases, skip_layers, g, need_dx, stash)


# the launches of one backward call, as bits of `imlp_chain_bwd_pieces`
BWD_PIECES = {"recompute": 1, "reverse": 2, "dw": 4, "reduce": 8}
KERNELS = ("chain_fwd_kernel<false,true>", "chain_fwd_kernel<true,true>",
           "chain_fwd_kernel<true,false>", "chain_reverse_kernel", "dw_kernel",
           "reduce_kernel")


def bwd_piece_launcher(xe, weights, biases, skip_layers, g, need_dx,
                       stash: Optional[torch.Tensor] = None):
    """For timing the pieces of a backward: runs one whole backward call
    (remat, or stash when `stash` is given) into a scratch it keeps, and
    returns piece(name) that launches that one kernel again on it
    (`BWD_PIECES`; "recompute" only without a stash).  Neither counts in
    `launches`."""
    d = _desc(xe, weights, biases, skip_layers)
    _, V = _videos(xe)
    B = xe.shape[-2]
    lib = _library()
    query = (lib.imlp_chain_bwd_scratch_bytes if stash is None
             else lib.imlp_chain_bwd_stash_scratch_bytes)
    scratch = torch.empty(V * query(ctypes.byref(d), B), dtype=torch.uint8,
                          device=xe.device)
    shapes = [tuple(w.shape[-2:]) for w in weights]
    grads = torch.empty(xe.shape[:-2] + (sum(a * b + b for a, b in shapes),),
                        dtype=torch.float32, device=xe.device)
    dx = torch.empty_like(xe) if need_dx else None
    args = (ctypes.byref(d), xe.data_ptr(), g.data_ptr(),
            stash.data_ptr() if stash is not None else None,
            dx.data_ptr() if dx is not None else None, grads.data_ptr(), B, V,
            scratch.data_ptr(), _stream(xe.device), int(stash is None))

    def launch(pieces: int, what: str) -> None:
        with torch.cuda.device(xe.device):
            err = lib.imlp_chain_bwd_pieces(*args, pieces)
        _raise_on(err, what)

    def piece(name: str) -> None:
        launch(BWD_PIECES[name], f"imlp_chain_bwd_pieces({name})")

    launch(sum(BWD_PIECES.values()), "imlp_chain_bwd_pieces")
    piece.keep = (d, scratch, grads, dx)   # alive as long as the launcher
    return piece


def kernel_attrs() -> dict:
    """{kernel: (registers, local bytes a thread, shared bytes a launch)} of
    the built library (`KERNELS`; the forward's shared memory at width 256)."""
    lib = _library()
    out = {}
    for i, name in enumerate(KERNELS):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        _raise_on(lib.imlp_chain_kernel_attrs(i, ctypes.byref(regs),
                                              ctypes.byref(local),
                                              ctypes.byref(smem)),
                  "imlp_chain_kernel_attrs")
        out[name] = (regs.value, local.value, smem.value)
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedChain(torch.autograd.Function):
    """The custom VJPs `_chain` and `_chain_stash` (imlp_kernel.py:384-581)
    as one autograd Function: kernels for CUDA tensors, the plain twins for
    CPU tensors; with `stash_bwd` the forward's stash is saved for the
    backward, else the backward recomputes."""

    @staticmethod
    def forward(ctx, xe, skip_layers, compute_dtype, stash_bwd, *params):
        ws, bs = list(params[0::2]), list(params[1::2])
        stash = []
        if xe.is_cuda:
            if compute_dtype != torch.bfloat16:
                raise ValueError("the CUDA chain kernel computes in bfloat16 "
                                 f"only, got {compute_dtype}")
            xe = xe.float().contiguous()
            ws = [w.to(torch.bfloat16).contiguous() for w in ws]
            bs = [b.float().contiguous() for b in bs]
            if stash_bwd:
                out, flat = imlp_chain_fwd_stash_cuda(xe, ws, bs, skip_layers)
                stash = [flat]
            else:
                out = imlp_chain_fwd_cuda(xe, ws, bs, skip_layers)
        elif stash_bwd:
            out, stash = imlp_chain_fwd_stash_plain(xe, ws, bs, skip_layers,
                                                    compute_dtype)
        else:
            out = imlp_chain_fwd_plain(xe, ws, bs, skip_layers, compute_dtype)
        ctx.save_for_backward(xe, *ws, *bs, *stash)
        ctx.n_layers = len(ws)
        ctx.skip_layers = tuple(skip_layers)
        ctx.compute_dtype = compute_dtype
        ctx.stash_bwd = bool(stash_bwd)
        return out

    @staticmethod
    def backward(ctx, g):
        xe, *rest = ctx.saved_tensors
        n = ctx.n_layers
        ws, bs, stash = rest[:n], rest[n:2 * n], rest[2 * n:]
        need_dx = ctx.needs_input_grad[0]
        sk, cdt = ctx.skip_layers, ctx.compute_dtype
        if xe.is_cuda:
            g = g.float().contiguous()
            if ctx.stash_bwd:
                dx, dWs, dbs = imlp_chain_bwd_stash_cuda(xe, ws, bs, sk,
                                                         stash[0], g, need_dx)
            else:
                dx, dWs, dbs = imlp_chain_bwd_cuda(xe, ws, bs, sk, g, need_dx)
        elif ctx.stash_bwd:
            dx, dWs, dbs = imlp_chain_bwd_stash_plain(xe, ws, bs, sk, stash,
                                                      g, need_dx, cdt)
        else:
            dx, dWs, dbs = imlp_chain_bwd_plain(xe, ws, bs, sk, g, need_dx,
                                                cdt)
        grads = []
        for dW, db in zip(dWs, dbs):
            grads += [dW, db]
        return (dx, None, None, None, *grads)


def fused_imlp_linear_chain(params, xe: torch.Tensor,
                            skip_layers: Sequence[int] = (),
                            compute_dtype=torch.bfloat16,
                            stash_bwd: bool = False) -> torch.Tensor:
    """Differentiable fused chain on PRE-ENCODED input xe (B, E): returns the
    pre-tanh output (B, out).  params: list of {"w": (in, out), "b": (out,)}.
    With a video axis — xe (V, B, E), params {"w": (V, in, out), "b": (V,
    out)} — V independent chains run in one launch each way -> (V, B, out).
    A ragged B needs no padding: the kernel masks the edge tile.

    stash_bwd=False: the backward recomputes the forward per tile (no
    activation memory between forward and backward).  stash_bwd=True: the
    forward writes the bf16 activation stash, autograd keeps it, and the
    backward reads it instead of recomputing; the gradients are
    bit-identical."""
    flat = []
    for layer in params:
        flat += [layer["w"], layer["b"]]
    return _FusedChain.apply(xe, tuple(skip_layers), compute_dtype,
                             bool(stash_bwd), *flat)
