"""The two other correlation bodies (TPU rows 6 and 7: the group-shared
window and the resident coarse levels) against the port's plain twin on the
CPU, and the port's body selection.

The JAX package's shared body (`pad_fmap_pyramid(..., shared=True)`) and
resident body (DEFLICKER_CORR_QUAD=0, DEFLICKER_CORR_RESIDENT=1, as
tests/test_pallas_corr.py sets them) run in interpret mode over a
bf16-stored pyramid; `corr_lookup_plain` reads the same bf16-rounded levels.
Both multiply them by f32 f1 with f32 sums, so rtol = atol = 1e-4 (the bound
tests/test_pallas_corr.py holds both bodies to against the materialized
lookup).  The CUDA bodies are held to the same twin in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deflicker_tpu.models import raft as jraft
from deflicker_tpu.ops.pallas.corr_kernel import (corr_lookup_pallas,
                                                  pad_fmap_pyramid)
from deflicker_torch.models import raft as traft
from deflicker_torch.ops.cuda import corr_kernel as C

torch.set_num_threads(2)


SPREADS = (0.5, 3.0, 40.0)


def _inputs(H=12, W=24, D=32, seed=0):
    """f1, f2 and coords = grid + uniform flow, one batch element per spread
    of SPREADS pixels: 0.5 keeps every 8-pixel group's windows together, 40
    throws them apart and out of the level.  One batch for all three
    spreads: one interpret-mode trace a body."""
    rng = np.random.default_rng(seed)
    B = len(SPREADS)
    f1 = rng.normal(size=(B, H, W, D)).astype(np.float32)
    f2 = rng.normal(size=(B, H, W, D)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    spread = np.asarray(SPREADS, np.float32)[:, None, None, None]
    coords = np.stack([xs, ys], -1)[None] + spread * rng.uniform(
        -1, 1, (B, H, W, 2)).astype(np.float32)
    return f1, f2, coords


def _twin(f1, pyr, coords):
    stored = [torch.tensor(np.asarray(lvl.astype(jnp.bfloat16)
                                     .astype(jnp.float32))).to(torch.bfloat16)
              for lvl in pyr]
    return C.corr_lookup_plain(torch.from_numpy(f1), stored,
                               torch.from_numpy(coords)).numpy()


@pytest.fixture(scope="module", params=["shared", "resident"])
def body_run(request):
    """The JAX body in interpret mode and the port's twin on all spreads."""
    body = request.param
    f1, f2, coords = _inputs()
    pyr = jraft.build_fmap_pyramid(jnp.asarray(f2))
    with pytest.MonkeyPatch.context() as mp:
        if body == "shared":
            mp.setenv("DEFLICKER_CORR_SHARED", "1")
            padded = pad_fmap_pyramid(pyr, dtype=jnp.bfloat16, shared=True)
        else:
            mp.setenv("DEFLICKER_CORR_QUAD", "0")
            mp.setenv("DEFLICKER_CORR_RESIDENT", "1")
            padded = pad_fmap_pyramid(pyr, dtype=jnp.bfloat16, quad=False,
                                      shared=False)
        ref = np.asarray(corr_lookup_pallas(jnp.asarray(f1), padded,
                                            jnp.asarray(coords),
                                            interpret=True))
    return ref, _twin(f1, pyr, coords)


@pytest.mark.parametrize("k", range(len(SPREADS)), ids=[str(s) for s in SPREADS])
def test_plain_twin_matches_jax_body(body_run, k):
    ref, got = (x[k] for x in body_run)
    assert got.shape == ref.shape == (12, 24, 4 * 81)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    if SPREADS[k] == 40.0:
        assert (got == 0).mean() > 0.2          # windows left the level


@pytest.mark.parametrize("shared,resident,body", [
    (None, None, "band"), ("1", None, "shared"), (None, "1", "resident"),
    ("1", "1", "shared"), ("0", "1", "resident"), ("0", "0", "band")])
def test_body_selection(shared, resident, body, monkeypatch):
    """The JAX package's switches pick the body; the shared body wins over
    the resident one, as in `corr_lookup_pallas`."""
    for name, val in (("DEFLICKER_CORR_SHARED", shared),
                      ("DEFLICKER_CORR_RESIDENT", resident)):
        if val is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, val)
    assert C.select_body() == body


def test_resident_levels_gate_and_capacity(monkeypatch):
    """At the flow engine's 54x96 grid, D = 256, with 226,048 bytes to
    give: levels 2 (160 KB) and 3 (37 KB) fit together, levels 0 (2.65 MB)
    and 1 (664 KB) do not; DEFLICKER_CORR_RESIDENT_MAX_MB gates each level's
    bytes below that; empty levels are never resident.  (The kernel's own
    capacity is held in tests/test_torch_cuda.py.)"""
    shapes = [(54, 96), (27, 48), (13, 24), (6, 12)]
    cap = 232_448 - 16 * 100 * 4
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT_MAX_MB", raising=False)
    assert C.resident_gate_bytes() is None
    assert C.resident_levels(shapes, 256, cap) == (2, 3)
    monkeypatch.setenv("DEFLICKER_CORR_RESIDENT_MAX_MB", "0.1")
    assert C.resident_gate_bytes() == int(0.1 * 1024 * 1024)
    assert C.resident_levels(shapes, 256, cap, C.resident_gate_bytes()) == (3,)
    # a gate above the capacity is capped by it
    assert C.resident_levels(shapes, 256, cap, 5 << 20) == (2, 3)
    assert C.resident_levels(shapes, 64, cap) == (1, 2, 3)
    assert C.resident_levels([(7, 9), (3, 4), (1, 2), (0, 1)], 32, cap) == (0, 1, 2)


def test_raft_flow_on_cpu_runs_the_twin_for_every_body(monkeypatch):
    """Every body computes the twin's function, so on CPU tensors raft_flow
    runs the plain twin whatever the switches say: the flow is the same."""
    model = traft.raft_init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    im1, im2 = (torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3))
                                 .astype(np.float32)) for _ in range(2))
    monkeypatch.delenv("DEFLICKER_CORR_SHARED", raising=False)
    monkeypatch.delenv("DEFLICKER_CORR_RESIDENT", raising=False)
    _, band = traft.raft_flow(model, im1, im2, iters=2, corr_mode="kernel")
    for env in ("DEFLICKER_CORR_SHARED", "DEFLICKER_CORR_RESIDENT"):
        monkeypatch.setenv(env, "1")
        C.reset_launches()
        _, up = traft.raft_flow(model, im1, im2, iters=2, corr_mode="kernel")
        assert torch.equal(up, band)
        assert not any(C.launches.values())
        monkeypatch.delenv(env)
