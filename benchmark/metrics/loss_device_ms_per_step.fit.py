"""Device milliseconds a profiled fit step spent in kernels other than the
chain kernels: the loss's small operations, the sampling gather and Adam."""

import importlib.util
from pathlib import Path

SOURCE = "device_trace"
LAYER = "fit loss and optimizer"
MOVES = "fit_its"


def _chain():
    path = Path(__file__).with_name("chain_roofline_share.fit.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_chain", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(run):
    t = run.trace
    if not t or not t["ops"]:
        return None
    chain = _chain()
    steps = sum(e - s for s, e in t["spans"])
    other = sum(d for n, d in t["ops"] if not chain.is_chain(n)
                and not n.startswith(("Memcpy", "Memset")))
    return 1e3 * other / steps
