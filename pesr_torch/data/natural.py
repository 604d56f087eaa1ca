"""The ``natural`` corpus: real photographs that ship as data files inside
installed third-party packages (the port's copy of the registry of
``pesr_tpu/metrics/natural_images.py``, same entries, names, treatments
and holdouts).

Nothing is downloaded and no image is committed: an entry resolves only
where its package is installed.  Lossless PNG textures are used as they
are; ``grace_hopper`` (a JPEG of quality ~78) is halved with the
MATLAB-bicubic antialias kernel to suppress its block artifacts.  The
holdouts were never fitted by the metric models; training leaves them
out, evaluation includes them.  JPEG entries need Pillow, as in the JAX
package; PNGs go through the native libpng decoder when it builds.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import List, Optional, Tuple

import numpy as np

_FULL, _HALVE = "full", "halve"


@dataclasses.dataclass(frozen=True)
class NaturalImage:
    module: str     # top-level package whose install dir holds the file
    relpath: str    # path relative to the package directory
    treatment: str  # _FULL or _HALVE
    holdout: bool = False  # never fitted; evaluation only

    @property
    def name(self) -> str:
        return os.path.splitext(os.path.basename(self.relpath))[0]


_ADROIT = "envs/assets/adroit_hand/resources/textures/"
_KITCHEN = "envs/assets/kitchen_franka/kitchen_assets/textures/"
REGISTRY: Tuple[NaturalImage, ...] = (
    NaturalImage("sklearn", "datasets/images/china.jpg", _FULL),
    NaturalImage("sklearn", "datasets/images/flower.jpg", _FULL),
    NaturalImage("matplotlib", "mpl-data/sample_data/grace_hopper.jpg",
                 _HALVE),
    NaturalImage("dm_control", "locomotion/arenas/assets/outdoor_natural/"
                 "OutdoorGrassFloorD.png", _FULL),
    NaturalImage("gymnasium_robotics", _ADROIT + "foil.png", _FULL),
    NaturalImage("gymnasium_robotics", _ADROIT + "marble.png", _FULL),
    NaturalImage("gymnasium_robotics", _ADROIT + "silverRaw.png", _FULL),
    NaturalImage("gymnasium_robotics", _ADROIT + "darkwood.png", _FULL),
    NaturalImage("gymnasium_robotics", _ADROIT + "skin.png", _FULL),
    NaturalImage("gymnasium_robotics", _KITCHEN + "tile1.png", _FULL),
    NaturalImage("gymnasium_robotics", _KITCHEN + "wood1.png", _FULL),
    # holdouts: a noisy webcam photo and two tile photographs
    NaturalImage("pygame", "docs/generated/_images/camera_rgb.jpg", _FULL,
                 holdout=True),
    NaturalImage("gymnasium_robotics", _KITCHEN + "white_marble_tile2.png",
                 _FULL, holdout=True),
    NaturalImage("gymnasium_robotics", _KITCHEN + "marble1.png", _FULL,
                 holdout=True),
)


def _package_dir(module: str) -> Optional[str]:
    """Install directory of a top-level package, found without importing
    it."""
    try:
        spec = importlib.util.find_spec(module)
    except (ImportError, ValueError):
        return None
    if spec is None:
        return None
    if spec.submodule_search_locations:
        return list(spec.submodule_search_locations)[0]
    return os.path.dirname(spec.origin) if spec.origin else None


def resolve(entry: NaturalImage) -> Optional[str]:
    """Absolute path of a registry entry, or None if it is not installed."""
    base = _package_dir(entry.module)
    if not base:
        return None
    path = os.path.join(base, *entry.relpath.split("/"))
    return path if os.path.isfile(path) else None


def _load(entry: NaturalImage, path: str) -> np.ndarray:
    from pesr_torch.data.datasets import decode_image, host_bicubic_resize
    try:
        img = decode_image(path)
    except ImportError as e:
        raise ImportError(f"the natural corpus's {entry.name} "
                          f"({os.path.basename(path)}) needs Pillow to "
                          f"decode: {e}") from e
    if entry.treatment == _HALVE:
        h, w = img.shape[:2]
        img = host_bicubic_resize(img, h // 2, w // 2)
    return img


def load_natural_images(include_holdout: bool = False
                        ) -> List[Tuple[str, np.ndarray]]:
    """Every installed registry image as (name, HWC uint8), in registry
    order; entries whose package is absent are skipped."""
    return [(e.name, _load(e, path)) for e in REGISTRY
            if include_holdout or not e.holdout
            for path in [resolve(e)] if path]


def holdout_names() -> List[str]:
    """Names of the holdout entries, installed or not."""
    return [e.name for e in REGISTRY if e.holdout]


def missing_error() -> FileNotFoundError:
    """The error when no registry image resolves on this machine."""
    mods = sorted({e.module for e in REGISTRY})
    return FileNotFoundError(
        "no natural images available: the corpus reads photographs that "
        f"ship inside the packages {', '.join(mods)}, and no registered "
        "file was found in an installed one (nothing is downloaded); use "
        "--train_dataset / --dataset synthetic, or a folder of images")
