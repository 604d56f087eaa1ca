"""The reference side of each model family, one module per family:
a configuration's ``family`` key names ``reference/families/<family>.py``
(and the program side ``programs/<family>.py``).  Nothing here imports
the program.

A family module gives:

* ``KEYS``: the configuration keys of its own, beside :data:`COMMON_KEYS`;
* ``param_shapes(model)``: ``(name, shape)`` of every parameter, in
  draw order; ``parameters`` in the configuration is their sum;
* ``make_state_dict(model, seed, device)``: the float32 weights of
  ``param_shapes`` on ``device``, drawn from ``seed``;
* ``reference(model, mix, sd, crops, device)``: the plain forward of
  ``mix``'s path, NHWC [-1, 1] -> NHWC SR (``crops``: the mix's
  calibration crops, NHWC [-1, 1] numpy, or None);
* ``control(model, mix, sd, crops, device)``: the same one precision
  below the path's, or None where the program's own lower path
  (``programs/<family>.py`` ``CONTROL_PATHS``) serves as the control;
* ``ops_per_lr_px(model, path)``: ``(low, bf16)`` operations per LR
  pixel of the path, at the low precision's peak (int8) and at bf16's.
"""

from __future__ import annotations

import importlib

COMMON_KEYS = ("name", "family", "scale", "precision", "assumed", "source",
               "reduced", "parameters")


def load(model: dict):
    """The reference module of ``model``'s family."""
    return importlib.import_module(f"{__name__}.{model['family']}")
