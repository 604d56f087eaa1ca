"""The program side of each model family, one module per family: a
configuration's ``family`` key names ``programs/<family>.py``, which
builds the port's apply from the benchmark's weights (the reference
side is ``reference/families/<family>.py``).

A family module gives:

* ``apply(model, mix, sd, crops, device, path)``: the port's apply for
  the batch engine (``BatchTiledUpscaler``), NHWC [-1, 1] -> NHWC SR,
  on ``path`` (``crops``: the mix's calibration crops, or None);
* ``launches()``: the family's kernel launch counters, name -> count
  since the process started;
* ``CONTROL_PATHS``: path -> the program's own path one precision
  below it, which serves as the control where the reference side gives
  none.
"""

from __future__ import annotations

import importlib


def load(model: dict):
    """The program module of ``model``'s family."""
    return importlib.import_module(f"{__name__}.{model['family']}")
