"""Flow models that a configuration can name, one module each.

A configuration names its model with a top-level `"flow_model"` (`raft`
where the key is absent); `benchmark/flowmodels/<name>.py` is the one
place through which the flow driver, its calibration and the flow readers
reach anything particular to that model.  A module gives (`API`):

  * `settings(config)`: the model's block of the configuration, with
    `iters`, `dtype` and `pair_batch`;
  * `make_weights(seed, device, dtype)`: its state dict at the published
    widths, drawn on the device from the seed;
  * `program(weights, config, device)`: the measured flow entry, an
    engine with `compute_batch(im1, im2)`;
  * `reference(weights, precision)`: the plain reference over the same
    weights (`"f32"`, or `"fp8"` for the control), and
    `reference_flow(model, image1, image2, config, trace)`: its solve,
    `trace` receiving the coordinates each correlation lookup reads;
  * `direction_flops(config)`: model FLOPs of one flow direction;
  * `needed_dots(coords, H8, W8)`, `lookup_bound_s(directions, H8, W8,
    dots)`: the correlation lookup's work and bound;
  * `faults()`: the model's own faults under the timed path, name ->
    context manager factory.
"""

from __future__ import annotations

import importlib

DEFAULT = "raft"
API = ("settings", "make_weights", "program", "reference", "reference_flow",
       "direction_flops", "needed_dots", "lookup_bound_s", "faults")


def of(config: dict):
    """The module of the flow model that `config` names."""
    return importlib.import_module(f"{__name__}.{config.get('flow_model', DEFAULT)}")
