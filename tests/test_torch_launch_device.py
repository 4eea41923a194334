"""Every kernel launch of the port runs with the operands' card current.

`--gpu N` puts the tensors on `cuda:N`, while torch leaves device 0 current
between its own ops; CUDA refuses a launch on a stream of another device,
and `cudaFuncSetAttribute` acts on the current one.  So each wrapper must
enter the tensors' device around its library calls.  Needs no card: the
tensors are CPU tensors that report `cuda:1`, the runtime's current device
is simulated under `torch.cuda.device`, and the loaded library is replaced
by one that records the current device at every call."""

import numpy as np
import pytest
import torch

from deflicker_torch.ops.cuda import corr_kernel as C
from deflicker_torch.ops.cuda import imlp_kernel as K

CARD = 1


class _OnCard(torch.Tensor):
    """A CPU tensor that reports `cuda:1` (results of its ops do too)."""

    @property
    def device(self):
        return torch.device("cuda", CARD)

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().as_subclass(_OnCard)


class _RecordingLibrary:
    """Stands in for a loaded ctypes library: every function returns 0 and
    records (name, the current device at the call)."""

    def __init__(self, state):
        self.calls = []
        self._state = state

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, self._state["device"]))
            return 0
        return fn


@pytest.fixture
def fake_runtime(monkeypatch):
    """Device 0 current; torch.cuda.device switches a simulated current
    device; allocations on a card land on the CPU as _OnCard tensors."""
    state = {"device": 0}

    def exchange(idx):
        prev = state["device"]
        if idx >= 0:
            state["device"] = idx
        return prev

    class _Stream:
        cuda_stream = 0

    class _Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "_exchange_device", exchange)
    monkeypatch.setattr(torch.cuda, "_maybe_exchange_device", exchange)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["device"])
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device=None: _Props())
    real_empty = torch.empty

    def empty(*size, device=None, **kw):
        dev = torch.device(device) if device is not None else None
        if dev is not None and dev.type == "cuda":
            return real_empty(*size, **kw).as_subclass(_OnCard)
        return real_empty(*size, device=device, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    lib = _RecordingLibrary(state)
    monkeypatch.setattr(K, "_library", lambda: lib)
    monkeypatch.setattr(C, "_library", lambda: lib)
    return lib


def _chain_operands(V=None):
    rng = np.random.default_rng(0)
    lead = (V,) if V else ()
    B, E, widths = 5, 3, (16, 16, 2)
    x = _on_card(torch.from_numpy(rng.normal(size=lead + (B, E)).astype(np.float32)))
    ws, bs, fan_in = [], [], E
    for n in widths:
        w = rng.normal(size=lead + (fan_in, n)).astype(np.float32)
        ws.append(_on_card(torch.from_numpy(w).to(torch.bfloat16)))
        bs.append(_on_card(torch.zeros(lead + (n,))))
        fan_in = n
    g = _on_card(torch.from_numpy(rng.normal(size=lead + (B, widths[-1])).astype(np.float32)))
    return x, ws, bs, g


LAUNCHES = {"imlp_chain_fwd", "imlp_chain_fwd_stash", "imlp_chain_bwd",
            "imlp_chain_bwd_stash", "imlp_chain_bwd_pieces", "corr_lookup",
            "corr_resident_capacity"}


@pytest.mark.parametrize("V", [None, 3])
def test_chain_launches_run_on_the_operands_card(fake_runtime, V):
    x, ws, bs, g = _chain_operands(V)
    assert x.is_cuda and x.device == torch.device("cuda", CARD)
    K.imlp_chain_fwd_cuda(x, ws, bs, ())
    _, stash = K.imlp_chain_fwd_stash_cuda(x, ws, bs, ())
    K.imlp_chain_bwd_cuda(x, ws, bs, (), g, True)
    K.imlp_chain_bwd_stash_cuda(x, ws, bs, (), stash, g, False)
    piece = K.bwd_piece_launcher(x, ws, bs, (), g, False)
    piece("reverse")
    launched = [c for c in fake_runtime.calls if c[0] in LAUNCHES]
    assert {name for name, _ in launched} == {
        "imlp_chain_fwd", "imlp_chain_fwd_stash", "imlp_chain_bwd",
        "imlp_chain_bwd_stash", "imlp_chain_bwd_pieces"}
    assert all(dev == CARD for _, dev in launched), launched
    assert torch.cuda.current_device() == 0      # restored after each call


@pytest.mark.parametrize("body", ["band", "shared", "resident"])
def test_corr_launches_run_on_the_operands_card(fake_runtime, body):
    rng = np.random.default_rng(1)
    B, H, W, D = 1, 8, 8, 32
    f1 = _on_card(torch.from_numpy(rng.normal(size=(B, H, W, D)).astype(np.float32)))
    pyramid = [_on_card(torch.from_numpy(
        rng.normal(size=(B, H >> l, W >> l, D)).astype(np.float32)).to(torch.bfloat16))
        for l in range(4)]
    coords = _on_card(torch.from_numpy(
        rng.uniform(0, 7, size=(B, H, W, 2)).astype(np.float32)))
    C.corr_lookup_cuda(f1, pyramid, coords, body=body)
    launched = [c for c in fake_runtime.calls if c[0] in LAUNCHES]
    assert "corr_lookup" in {name for name, _ in launched}
    assert all(dev == CARD for _, dev in launched), launched
    assert torch.cuda.current_device() == 0
