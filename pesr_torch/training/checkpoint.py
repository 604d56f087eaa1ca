"""Training checkpoints of the port (counterpart of
``pesr_tpu/training/checkpoint.py``, which writes orbax; the port cannot).

A snapshot is a directory, ``<check_point>/step_<K>/`` or
``<check_point>/best/``, holding:

* ``generator.pth`` -- the generator's state_dict in the EDSR
  convention (the shared weight format: ``pesr_tpu.convert`` reads it,
  ``python -m pesr_torch.test --model_path`` loads it);
* ``ema.pth`` -- the EMA copy's state_dict, when ``--ema_decay > 0``;
* ``discriminator.pth`` -- in the GAN phase, the discriminator's
  state_dict in the SRGAN registration order (``pesr_tpu.convert.
  load_discriminator_weights`` reads it; ``--pretrained_d`` takes it);
* ``train_state.pt`` -- the optimizer state (and the discriminator's),
  the step, the best validation PSNR so far, the parameters' dtype
  (``param_dtype``; loading into a model of the other dtype converts
  the parameters and Adam's moments), the seed of the data stream,
  the state of the augmentation generator and, in the GAN phase, of the
  gradient penalty's generator.

A snapshot is written into a temporary directory and renamed into
place, so an interrupted save leaves the previous one intact.  On a
mesh of several processes (``state.mesh``) rank 0 writes and every rank
then waits at a barrier, so no rank reads a snapshot before it is
there; every rank must call the save (a save on rank 0 alone would
leave the others waiting forever).
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from pesr_torch import parallel
from pesr_torch.convert import load_discriminator_pth
from pesr_torch.training.state import TrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
GENERATOR, EMA, TRAIN_STATE = "generator.pth", "ema.pth", "train_state.pt"
DISCRIMINATOR = "discriminator.pth"


def _to_abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _step_dirs(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted((int(m.group(1)), os.path.join(ckpt_dir, e))
                  for e in os.listdir(ckpt_dir) if (m := _STEP_RE.match(e)))


def latest_step_dir(ckpt_dir: str) -> Optional[str]:
    """The ``step_<K>`` directory with the largest K, or None."""
    steps = _step_dirs(_to_abs(ckpt_dir))
    return steps[-1][1] if steps else None


def _save(path: str, state: TrainState, best_psnr: Optional[float],
          extra: Optional[Dict[str, Any]]) -> str:
    if parallel.is_primary(state.mesh):
        _write(path, state, best_psnr, extra)
    parallel.barrier(state.mesh)
    return path


def _write(path: str, state: TrainState, best_psnr: Optional[float],
           extra: Optional[Dict[str, Any]]) -> None:
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(state.generator.state_dict(), os.path.join(tmp, GENERATOR))
    if state.ema is not None:
        torch.save(state.ema.state_dict(), os.path.join(tmp, EMA))
    ts = {"step": state.step, "best_psnr": best_psnr,
          "param_dtype": str(next(state.generator.parameters()).dtype
                             ).replace("torch.", ""),
          "optimizer": state.optimizer.state_dict(), **(extra or {})}
    if state.discriminator is not None:
        torch.save(state.discriminator.state_dict(),
                   os.path.join(tmp, DISCRIMINATOR))
        ts["d_optimizer"] = state.d_optimizer.state_dict()
        ts["gp_rng"] = state.gp_rng.get_state()
    torch.save(ts, os.path.join(tmp, TRAIN_STATE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_train_ckpt(ckpt_dir: str, state: TrainState,
                    best_psnr: Optional[float] = None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<ckpt_dir>/step_<state.step>``; ``extra`` adds entries to
    ``train_state.pt`` (the loop's data seed and augmentation state)."""
    return _save(os.path.join(_to_abs(ckpt_dir), f"step_{state.step}"),
                 state, best_psnr, extra)


def save_best_ckpt(ckpt_dir: str, state: TrainState,
                   best_psnr: Optional[float] = None,
                   extra: Optional[Dict[str, Any]] = None) -> str:
    """Overwrite ``<ckpt_dir>/best``, the best-validation copy."""
    return _save(os.path.join(_to_abs(ckpt_dir), "best"), state, best_psnr,
                 extra)


def prune_snapshots(ckpt_dir: str, keep: int) -> list:
    """Remove the oldest ``step_<K>`` directories beyond the newest
    ``keep``; ``best`` is never touched and ``keep <= 0`` keeps all.
    Returns the removed paths."""
    if keep <= 0:
        return []
    steps = _step_dirs(_to_abs(ckpt_dir))
    pruned = [p for _, p in steps[:-keep]] if len(steps) > keep else []
    for p in pruned:
        shutil.rmtree(p, ignore_errors=True)
    return pruned


def resolve(path: str) -> str:
    """A snapshot directory (one holding ``generator.pth``: a
    ``step_<K>``, ``best``, or any such directory), or an experiment
    directory, resolved to its newest ``step_<K>``.  Raises
    FileNotFoundError when neither holds a port snapshot."""
    path = _to_abs(path)
    if os.path.isfile(os.path.join(path, GENERATOR)):
        return path
    latest = latest_step_dir(path)
    if latest is None or not os.path.isfile(os.path.join(latest, GENERATOR)):
        raise FileNotFoundError(f"no pesr_torch checkpoint ({GENERATOR}) "
                                f"at {path}")
    return latest


def _load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_train_state(path: str, state: TrainState
                        ) -> Tuple[int, Optional[float], Dict[str, Any]]:
    """Load a snapshot into ``state`` in place (generator, optimizer,
    step; the EMA copy when both hold one; the discriminator, its
    optimizer and the penalty's generator when both are of the GAN
    phase).  Returns ``(step, best_psnr, train_state)``, the last the
    whole ``train_state.pt`` dict; its ``"has_ema"`` and ``"has_d"`` say
    whether the EMA copy and the discriminator were restored."""
    path = resolve(path)
    ts = _load(os.path.join(path, TRAIN_STATE))
    state.generator.load_state_dict(_load(os.path.join(path, GENERATOR)))
    state.optimizer.load_state_dict(ts["optimizer"])
    state.step = int(ts["step"])
    ema_path = os.path.join(path, EMA)
    ts["has_ema"] = state.ema is not None and os.path.isfile(ema_path)
    if ts["has_ema"]:
        state.ema.load_state_dict(_load(ema_path))
    d_path = os.path.join(path, DISCRIMINATOR)
    ts["has_d"] = (state.discriminator is not None
                   and os.path.isfile(d_path))
    if ts["has_d"]:
        state.discriminator.load_state_dict(_load(d_path))
        state.d_optimizer.load_state_dict(ts["d_optimizer"])
        state.gp_rng.set_state(ts["gp_rng"])
    return state.step, ts.get("best_psnr"), ts


def restore_generator_params(path: str, prefer_ema: bool = True
                             ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Just the generator's state_dict and its step: the EMA copy when
    the snapshot has one (the serving weights) unless ``prefer_ema`` is
    False.  ``path`` as :func:`resolve` takes it."""
    path = resolve(path)
    ema_path = os.path.join(path, EMA)
    sd = _load(ema_path if prefer_ema and os.path.isfile(ema_path)
               else os.path.join(path, GENERATOR))
    ts_path = os.path.join(path, TRAIN_STATE)
    step = int(_load(ts_path)["step"]) if os.path.isfile(ts_path) else 0
    return sd, step


def restore_discriminator_params(path: str, hr_size: int
                                 ) -> Dict[str, torch.Tensor]:
    """``--pretrained_d``: the discriminator's state_dict from a port
    snapshot (``path`` as :func:`resolve` takes it; its
    ``discriminator.pth``) or from an SRGAN-order ``.pth``."""
    if os.path.isdir(path):
        try:
            snap = resolve(path)
        except FileNotFoundError:
            snap = None   # not a port snapshot: the loader says what to pass
        if snap is not None:
            path = os.path.join(snap, DISCRIMINATOR)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"{snap} holds no {DISCRIMINATOR} "
                                        f"(a pretrain snapshot?)")
    return load_discriminator_pth(path, hr_size)


def interpolate_params(base: Dict[str, torch.Tensor],
                       other: Dict[str, torch.Tensor],
                       alpha: float) -> Dict[str, torch.Tensor]:
    """Network interpolation (ESRGAN section 4.4): ``(1 - a) * base + a *
    other`` per tensor, computed in float32 and cast back to base's dtype.
    Blending a PSNR-oriented generator with its GAN fine-tune in weight
    space trades PSNR for perceptual quality without retraining.  Raises
    ValueError when the two state_dicts differ in names or shapes."""
    validate_params_compat(base, other)
    a = float(alpha)
    return {k: ((1.0 - a) * v.float() + a * other[k].float()).to(v.dtype)
            for k, v in base.items()}


def validate_params_compat(expected: Dict[str, torch.Tensor],
                           restored: Dict[str, Any],
                           what: str = "generator") -> None:
    """Raise a readable ValueError when a restored state_dict does not
    match the configured model (e.g. a --num_blocks / --num_channels
    mismatch), instead of a bare size error from ``load_state_dict``."""
    exp = {k: tuple(v.shape) for k, v in expected.items()}
    got = {k: tuple(v.shape) for k, v in restored.items()}
    problems = []
    for k in sorted(exp.keys() | got.keys()):
        if k not in got:
            problems.append(f"  missing in checkpoint: {k} {exp[k]}")
        elif k not in exp:
            problems.append(f"  unexpected in checkpoint: {k} {got[k]}")
        elif exp[k] != got[k]:
            problems.append(f"  shape mismatch at {k}: model wants "
                            f"{exp[k]}, checkpoint has {got[k]}")
    if problems:
        raise ValueError(
            f"checkpoint is incompatible with the configured {what} "
            f"(check --num_blocks/--num_channels/--scale):\n"
            + "\n".join(problems[:12])
            + ("" if len(problems) <= 12
               else f"\n  ... and {len(problems) - 12} more"))
