"""The plain reference of the stage-1 atlas fit: Neural Layered Atlases as
All-In-One-Deflicker's `src/stage1_neural_atlas.py` (single atlas) and
`src/stage1_neural_atlas_seg.py` (foreground and background atlas with an
alpha network) train them, in plain PyTorch and float32.

Every network is a plain matmul chain (`linear`), queried once for each
coordinate variant as the published code does; the flow terms take the
published subsets (the samples whose consistency mask is set), not masked
means; Adam is written out.  Nothing here comes from the measured program:
the configuration's widths give the layers, and the caller gives the
initial parameters, the clips and the sampled pixels.

`precision` is that of the matmuls' operands, forward and backward (their
products accumulate in float32): "f32"; "bf16", the configuration's
bfloat16 products (inputs, activations, weights and output gradients
rounded to bfloat16 at every layer, as the configuration states them);
"fp8", float8 e4m3 with a per-tensor scale: the control, one precision below
the configuration's, that the comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

# networks of each pipeline, in the order their parameters are listed
NETWORKS = {"single": ("mapping1", "atlas"),
            "dual": ("mapping1", "atlas", "mapping2", "alpha")}
ADAM = (0.9, 0.999, 1e-8)


def network_specs(atlas: dict, dual: bool) -> Dict[str, dict]:
    """in, out, hidden width, layer count, positional frequencies (0: none)
    and skip layers of each network, from the configuration's keys."""
    specs = {
        "mapping1": dict(n_in=3, n_out=2,
                         hidden=atlas["number_of_channels_mapping1"],
                         layers=atlas["number_of_layers_mapping1"],
                         freqs=(atlas["number_of_positional_encoding_mapping1"]
                                if atlas["use_positional_encoding_mapping1"] else 0),
                         skips=()),
        "atlas": dict(n_in=2, n_out=3, hidden=atlas["number_of_channels_atlas"],
                      layers=atlas["number_of_layers_atlas"],
                      freqs=atlas["positional_encoding_num_atlas"], skips=(4, 7)),
    }
    if dual:
        specs["mapping2"] = dict(
            n_in=3, n_out=2, hidden=atlas["number_of_channels_mapping2"],
            layers=atlas["number_of_layers_mapping2"],
            freqs=(atlas["number_of_positional_encoding_mapping2"]
                   if atlas["use_positional_encoding_mapping2"] else 0),
            skips=())
        specs["alpha"] = dict(n_in=3, n_out=1,
                              hidden=atlas["number_of_channels_alpha"],
                              layers=atlas["number_of_layers_alpha"],
                              freqs=atlas["positional_encoding_num_alpha"],
                              skips=())
    return specs


def layer_dims(spec: dict) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each layer: the encoded input feeds layer 0 and
    is concatenated again before each skip layer."""
    enc = 2 * spec["n_in"] * spec["freqs"] if spec["freqs"] else spec["n_in"]
    dims = []
    for i in range(spec["layers"]):
        fan_in = enc if i == 0 else spec["hidden"] + (enc if i in spec["skips"] else 0)
        fan_out = spec["n_out"] if i == spec["layers"] - 1 else spec["hidden"]
        dims.append((fan_in, fan_out))
    return dims


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = 448.0 / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


ROUND = {"bf16": _bf16, "fp8": _fp8}


class _RoundedMatmul(torch.autograd.Function):
    """x @ w with every operand rounded by `q`, in the backward too."""

    @staticmethod
    def forward(ctx, x, w, q):
        ctx.save_for_backward(x, w)
        ctx.q = q
        return q(x) @ q(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        q = ctx.q
        gq = q(g)
        return gq @ q(w).t(), q(x).t() @ gq, None


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           precision: str) -> torch.Tensor:
    if precision in ROUND:
        return _RoundedMatmul.apply(x, w, ROUND[precision]) + b
    return x @ w + b


def encode(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """sin and cos of 2^k pi x, grouped by frequency: for each k the sines
    of every input, then their cosines."""
    if not freqs:
        return x
    b = (2.0 ** torch.arange(freqs, dtype=torch.float32, device=x.device)) * math.pi
    proj = x[:, :, None] * b                       # (N, D, F)
    both = torch.cat([torch.sin(proj), torch.cos(proj)], dim=1)
    return both.transpose(1, 2).reshape(x.shape[0], -1)


def mlp(layers: Sequence[dict], x: torch.Tensor, spec: dict,
        precision: str) -> torch.Tensor:
    """ReLU between layers, the encoded input (gradient stopped) joined
    before each skip layer, tanh on the output."""
    h = encode(x, spec["freqs"])
    skip = h.detach()
    for k, layer in enumerate(layers):
        if k > 0:
            h = torch.relu(h)
        if k in spec["skips"]:
            h = torch.cat([h, skip], dim=1)
        h = linear(h, layer["w"], layer["b"], precision)
    return torch.tanh(h)


def rigidity(uv, uv_yminus, uv_xminus, amount: float, larger: int,
             scale: float) -> torch.Tensor:
    """Equation (9): ||J^T J||_F + ||(J^T J + 0.001 I)^-1||_F a sample, with
    the port's two floors, which change no value of a Jacobian that is not
    degenerate: the determinant kept at |det| >= 1e-12 with its sign, and
    each norm's square at >= 1e-24, so that a zero Jacobian (two queries
    that round to one coordinate) has a finite gradient."""
    k = (larger / 2.0) / (scale * amount)
    du_dx = (uv[:, 0] - uv_xminus[:, 0]) * k
    du_dy = (uv[:, 0] - uv_yminus[:, 0]) * k
    dv_dx = (uv[:, 1] - uv_xminus[:, 1]) * k
    dv_dy = (uv[:, 1] - uv_yminus[:, 1]) * k
    J = torch.stack([torch.stack([du_dx, du_dy], -1),
                     torch.stack([dv_dx, dv_dy], -1)], -2)
    JtJ = J.transpose(1, 2) @ J
    a = JtJ[:, 0, 0] + 0.001
    b = JtJ[:, 0, 1]
    c = JtJ[:, 1, 0]
    d = JtJ[:, 1, 1] + 0.001
    det = a * d - b * c
    det = torch.where(det >= 0, det.clamp(min=1e-12), det.clamp(max=-1e-12))
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    inv = inv / det[:, None, None]
    return ((JtJ ** 2).sum((1, 2)).clamp(min=1e-24).sqrt()
            + (inv ** 2).sum((1, 2)).clamp(min=1e-24).sqrt()).mean()


def video_loss(params: Dict[str, list], specs: Dict[str, dict], atlas: dict,
               clip: Dict[str, torch.Tensor], j, i, f, with_global: bool,
               with_bootstrap: bool, precision: str):
    """(total, {term: value}) of one video's sampled pixels (j, i, f), each
    (B,): one iteration of the published training loop, its terms named as
    the port logs them."""
    video = clip["video"]
    T, h, w, _ = video.shape
    L = max(h, w)
    dual = "alpha" in params
    scale = atlas["uv_mapping_scale"]

    def xyt(jj, ii, ff):
        return torch.stack([jj / (L / 2.0) - 1.0, ii / (L / 2.0) - 1.0,
                            ff / (T / 2.0) - 1.0], dim=1)

    def net(name, x):
        return mlp(params[name], x, specs[name], precision)

    jf, i_f, ff = j.float(), i.float(), f.float()

    def colour(pt):
        """(rgb, uv1, uv2, alpha) at the points (jj, ii, ff)."""
        x = xyt(*pt)
        uv1 = net("mapping1", x)
        rgb1 = (net("atlas", uv1 * 0.5 + 0.5) + 1.0) * 0.5
        if not dual:
            return rgb1, rgb1, uv1, None, None
        uv2 = net("mapping2", x)
        rgb2 = (net("atlas", uv2 * 0.5 - 0.5) + 1.0) * 0.5
        a = 0.5 * (net("alpha", x) + 1.0) * 0.99 + 0.001
        return rgb1 * a + rgb2 * (1.0 - a), rgb1, uv1, uv2, a

    rgb, rgb1, uv1, uv2, a = colour((jf, i_f, ff))
    terms = {"rgb": ((rgb - video[f, i, j]) ** 2).sum(1).mean()}
    total = atlas["rgb_coeff"] * terms["rgb"]

    if atlas["use_gradient_loss"]:
        dx = torch.zeros_like(video)
        dy = torch.zeros_like(video)
        dx[:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
        dy[:, :-1] = video[:, 1:] - video[:, :-1]
        rgb_x = colour((jf + 1, i_f, ff))[0]
        rgb_y = colour((jf, i_f + 1, ff))[0]
        terms["gradient"] = (((dx[f, i, j] - (rgb_x - rgb)) ** 2).sum(1)
                             + ((dy[f, i, j] - (rgb_y - rgb)) ** 2).sum(1)).mean()
        total = total + atlas["gradient_loss_coeff"] * terms["gradient"]

    d = atlas["derivative_amount"]
    layers = [("1", "mapping1", uv1, atlas["global_rigidity_derivative_amount_fg"],
               atlas["global_rigidity_coeff_fg"], a)]
    if dual:
        layers.append(("2", "mapping2", uv2,
                       atlas["global_rigidity_derivative_amount_bg"],
                       atlas["global_rigidity_coeff_bg"], 1.0 - a))
    fwd = clip["mask_fwd"][f, i, j] > 0
    bwd = clip["mask_bwd"][f, i, j] > 0
    flows = (clip["flow_fwd"][f, i, j], clip["flow_bwd"][f, i, j])
    for n, name, uv, gd, gcoeff, weight in layers:
        amounts = [("rigidity" + n, d, atlas["rigidity_coeff"])]
        if with_global:
            amounts.append(("global_rigidity" + n, gd, gcoeff))
        for term, amount, coeff in amounts:
            uv_ym = net(name, xyt(jf, i_f - amount, ff))
            uv_xm = net(name, xyt(jf - amount, i_f, ff))
            terms[term] = rigidity(uv, uv_ym, uv_xm, amount, L, scale)
            total = total + coeff * terms[term]
        # the published subsets: samples whose flow is consistent
        parts = []
        for sel, flow, step in ((bwd, flows[1], -1.0), (fwd, flows[0], 1.0)):
            fl = flow[sel]
            match = net(name, xyt(jf[sel] + fl[:, 0], i_f[sel] + fl[:, 1],
                                  ff[sel] + step))
            err = (((match - uv[sel]) ** 2).sum(1).clamp(min=1e-24).sqrt()
                   * L / (2.0 * scale))
            if dual:
                err = err * weight[sel][:, 0]
            parts.append(err.mean())
        terms["flow" + n] = 0.5 * (parts[0] + parts[1])
        total = total + atlas["optical_flow_coeff"] * terms["flow" + n]

    if dual:
        terms["sparsity"] = ((rgb1 * (1.0 - a)) ** 2).sum(1).mean()
        total = total + atlas["sparsity_coeff"] * terms["sparsity"]
        alpha_parts = []
        for sel, flow, step, sign in ((fwd, flows[0], 1.0, 1.0),
                                      (bwd, flows[1], -1.0, -1.0)):
            fl = flow[sel]
            am = 0.5 * (net("alpha", xyt(jf[sel] + fl[:, 0], i_f[sel] + fl[:, 1],
                                         ff[sel] + step)) + 1.0) * 0.99 + 0.001
            alpha_parts.append((a[sel] - am).abs().mean())
        terms["alpha_flow"] = 0.5 * (alpha_parts[0] + alpha_parts[1])
        total = total + atlas["alpha_flow_factor"] * terms["alpha_flow"]
        if with_bootstrap:
            m = clip["mask"][f, i, j]
            a0 = a[:, 0]
            terms["alpha_bootstrap"] = (-m * torch.log(a0)
                                        - (1.0 - m) * torch.log(1.0 - a0)).mean()
            total = total + (atlas["alpha_bootstrapping_factor"]
                             * terms["alpha_bootstrap"])
    return total, terms


def phase(atlas: dict, dual: bool, iteration: int) -> Tuple[bool, bool]:
    """(global rigidity on, bootstrapping on) at `iteration`."""
    return (atlas["include_global_rigidity_loss"]
            and iteration <= atlas["stop_global_rigidity"],
            dual and iteration <= atlas["stop_bootstrapping_iteration"])


def leaves(params: Dict[str, list]) -> Dict[str, torch.Tensor]:
    """Every parameter by name (`<network>.<layer>.<w|b>`)."""
    return {f"{name}.{k}.{key}": layer[key]
            for name, layers in params.items()
            for k, layer in enumerate(layers) for key in ("w", "b")}


def fit_steps(params0: Dict[str, list], atlas: dict, clips: Dict[str, torch.Tensor],
              samples: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
              start: int = 0, precision: str = "f32") -> dict:
    """Adam steps of the fit from `params0` (leaves with a leading video
    axis of V), one step a (j, i, f) of `samples` (each (V, B)), from
    iteration `start`.  Returns {"losses": [(V,) a step], "terms": [{term:
    (V,)} a step], "grad": the first step's gradient by leaf, "params": the
    parameters after the last step by leaf}.  TF32 is off while it runs."""
    dual = "alpha" in params0
    specs = network_specs(atlas, dual)
    lr = atlas["learning_rate"]
    b1, b2, eps = ADAM
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        theta = {k: t.detach().clone().requires_grad_()
                 for k, t in leaves(params0).items()}
        m = {k: torch.zeros_like(t) for k, t in theta.items()}
        v = {k: torch.zeros_like(t) for k, t in theta.items()}
        V = next(iter(theta.values())).shape[0]
        out = {"losses": [], "terms": [], "grad": None}
        for n, (j, i, f) in enumerate(samples):
            glob, boot = phase(atlas, dual, start + n)
            totals, terms = [], []
            for vid in range(V):
                p = {name: [{key: theta[f"{name}.{k}.{key}"][vid]
                             for key in ("w", "b")} for k in range(len(layers))]
                     for name, layers in params0.items()}
                clip = {key: t[vid] for key, t in clips.items()}
                total, parts = video_loss(p, specs, atlas, clip, j[vid], i[vid],
                                          f[vid], glob, boot, precision)
                totals.append(total)
                terms.append(parts)
            totals = torch.stack(totals)
            out["terms"].append({k: torch.stack([t[k].detach() for t in terms])
                                 for k in terms[0]})
            grads = torch.autograd.grad(totals.sum(), list(theta.values()))
            out["losses"].append(totals.detach())
            if n == 0:
                out["grad"] = {k: g.detach() for k, g in zip(theta, grads)}
            t = n + 1
            with torch.no_grad():
                for (k, p), g in zip(theta.items(), grads):
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** t)
                    vhat = v[k] / (1 - b2 ** t)
                    p.sub_(lr * mhat / (vhat.sqrt() + eps))
        out["params"] = {k: p.detach() for k, p in theta.items()}
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def init_params(atlas: dict, dual: bool, videos: int, generator: torch.Generator,
                device) -> Dict[str, list]:
    """Fresh networks as torch.nn.Linear draws them, W and b uniform in
    +-1/sqrt(fan_in), (V, in, out) and (V, out) a layer, made on `device`
    from `generator` in one draw."""
    specs = network_specs(atlas, dual)
    shapes = [(name, k, fi, fo) for name in NETWORKS["dual" if dual else "single"]
              for k, (fi, fo) in enumerate(layer_dims(specs[name]))]
    total = sum(videos * (fi * fo + fo) for _, _, fi, fo in shapes)
    flat = torch.rand((total,), generator=generator, device=device) * 2 - 1
    params: Dict[str, list] = {}
    off = 0
    for name, k, fi, fo in shapes:
        bound = 1.0 / math.sqrt(fi)
        layer = {}
        for key, shape in (("w", (videos, fi, fo)), ("b", (videos, fo))):
            n = math.prod(shape)
            layer[key] = (flat[off:off + n].view(shape) * bound).clone()
            off += n
        params.setdefault(name, []).append(layer)
    return params
