"""Host-side datasets (counterpart of parts of
``pesr_tpu/data/datasets.py``): the classic procedural ``synthetic``
corpus, MATLAB-bicubic host resizing, benchmark folders in the
``<name>/HR`` + ``<name>/LR_bicubic/X<scale>`` layout, and the training
stream (:class:`PatchIterator` of random aligned uint8 crops behind a
:class:`Prefetcher` thread).

Not ported yet: the native multithreaded sampler, the per-process
streams of a multi-process run, the ``hard`` synthetic variants, the
``natural`` corpus and device-side rendering.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pesr_torch.ops.resize import resize_kernel_matrix
from pesr_torch.utils.image_io import imread_uint8

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


class SyntheticImages:
    """Procedural HR images: smooth low-frequency fields + fine texture
    (the classic variant of the JAX package's corpus, identical draws).

    Deterministic per (seed, index); a pipeline exerciser, NOT a quality
    benchmark."""

    def __init__(self, num_images: int = 32, height: int = 480,
                 width: int = 480, seed: int = 0) -> None:
        self.num_images = num_images
        self.height, self.width = height, width
        self.seed = seed
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_images

    def name(self, idx: int) -> str:
        return f"synthetic_{idx:04d}"

    def _render(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.height, self.width
        img = np.zeros((h, w, 3), np.float64)
        # Sum of smooth random cosine gratings at mixed frequencies.
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        for _ in range(6):
            fy, fx = rng.uniform(0.5, 24.0, 2)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.05, 0.35)
            grating = np.cos(2 * np.pi * (fy * yy / h + fx * xx / w) + phase)
            img += amp * grating[:, :, None] * rng.uniform(0.3, 1.0, 3)
        # Piecewise structure: a few random rectangles (edges for SR).
        for _ in range(8):
            y0, x0 = rng.integers(0, max(1, h - 8)), \
                rng.integers(0, max(1, w - 8))
            y1 = y0 + int(rng.integers(min(8, max(2, h // 3) - 1),
                                       max(9, h // 3)))
            x1 = x0 + int(rng.integers(min(8, max(2, w // 3) - 1),
                                       max(9, w // 3)))
            img[y0:y1, x0:x1] += rng.uniform(-0.4, 0.4, 3)
        # Fine noise texture.
        img += rng.normal(0, 0.02, (h, w, 3))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        return (img * 255.0).round().astype(np.uint8)

    def get(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            self._cache[idx] = self._render(idx)
        return self._cache[idx]


class PairedImageFolder:
    """HR image dir with an optional aligned LR dir (DIV2K layout).

    ``lr_dir=None`` means no LR files exist; the training stage then
    synthesizes LR from the HR crop.  LR file names tried, in order: the
    same name, DIV2K's ``<stem>x<scale><ext>``.  Decoded images are
    cached in RAM (DIV2K's ~800 x ~8 MB fit)."""

    def __init__(self, hr_dir: str, lr_dir: Optional[str] = None,
                 scale: int = 4) -> None:
        self.hr_dir, self.lr_dir, self.scale = hr_dir, lr_dir, scale
        self.files = sorted(f for f in os.listdir(hr_dir)
                            if f.lower().endswith(_IMG_EXTS))
        if not self.files:
            raise FileNotFoundError(f"no images under {hr_dir}")
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.files)

    def name(self, idx: int) -> str:
        return os.path.splitext(self.files[idx])[0]

    def _read(self, path: str) -> np.ndarray:
        if path not in self._cache:
            self._cache[path] = imread_uint8(path)
        return self._cache[path]

    def get_hr(self, idx: int) -> np.ndarray:
        return self._read(os.path.join(self.hr_dir, self.files[idx]))

    def lr_path(self, idx: int) -> Optional[str]:
        if self.lr_dir is None:
            return None
        stem, ext = os.path.splitext(self.files[idx])
        for cand in (self.files[idx], f"{stem}x{self.scale}{ext}"):
            p = os.path.join(self.lr_dir, cand)
            if os.path.exists(p):
                return p
        return None

    def get_lr(self, idx: int) -> Optional[np.ndarray]:
        p = self.lr_path(idx)
        return self._read(p) if p else None


def host_bicubic_resize(img: np.ndarray, out_h: int,
                        out_w: int) -> np.ndarray:
    """MATLAB-bicubic resize on host (numpy matmuls) with uint8
    requantization -- LR synthesis and the bicubic upscale baseline."""
    mh = resize_kernel_matrix(img.shape[0], out_h).astype(np.float64)
    mw = resize_kernel_matrix(img.shape[1], out_w).astype(np.float64)
    x = img.astype(np.float64)
    x = np.einsum("oh,hwc->owc", mh, x, optimize=True)
    x = np.einsum("ow,hwc->hoc", mw, x, optimize=True)
    # floor(x + 0.5): MATLAB im2uint8 rounds ties half-AWAY, np.round
    # half-to-even (ties below 0.5 clip to 0, so away == up here).
    return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)


def host_bicubic_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    """MATLAB-bicubic downsample on host -- how DIV2K LR files were made."""
    h, w = hr.shape[:2]
    h2, w2 = (h // scale) * scale, (w // scale) * scale
    return host_bicubic_resize(hr[:h2, :w2], h2 // scale, w2 // scale)


class PatchIterator:
    """Infinite iterator of random aligned uint8 crop batches:
    ``(lr_batch or None, hr_batch)``.  LR crops come from LR files when
    the source has them, else None (the training stage synthesizes LR).
    LR window [y, y+p) maps to HR window [y*s, (y+p)*s).  The draws are
    the JAX package's, from ``np.random.default_rng(seed)``, so the same
    seed gives the same crops."""

    def __init__(self, source, patch_size: int, scale: int,
                 batch_size: int, seed: int = 0) -> None:
        self.src = source
        self.p, self.s, self.b = patch_size, scale, batch_size
        self.rng = np.random.default_rng(seed)
        self.use_lr_files = bool(getattr(source, "lr_dir", None))

    def __iter__(self) -> Iterator[Tuple[Optional[np.ndarray], np.ndarray]]:
        return self

    def __next__(self) -> Tuple[Optional[np.ndarray], np.ndarray]:
        p, s = self.p, self.s
        hr_batch = np.empty((self.b, p * s, p * s, 3), np.uint8)
        lr_batch = (np.empty((self.b, p, p, 3), np.uint8)
                    if self.use_lr_files else None)
        for i in range(self.b):
            idx = int(self.rng.integers(len(self.src)))
            hr = (self.src.get_hr(idx) if hasattr(self.src, "get_hr")
                  else self.src.get(idx))
            if self.use_lr_files:
                lr = self.src.get_lr(idx)
                if lr is None:
                    raise FileNotFoundError(
                        f"LR-file mode: image index {idx} has no LR file "
                        f"under {self.src.lr_dir}; fix the LR set or remove "
                        f"the LR directory to synthesize LR from HR")
                lh, lw = lr.shape[:2]
                y = int(self.rng.integers(0, lh - p + 1))
                x = int(self.rng.integers(0, lw - p + 1))
                lr_batch[i] = lr[y:y + p, x:x + p]
                hr_batch[i] = hr[y * s:(y + p) * s, x * s:(x + p) * s]
            else:
                hh, hw = hr.shape[:2]
                y = int(self.rng.integers(0, hh - p * s + 1))
                x = int(self.rng.integers(0, hw - p * s + 1))
                hr_batch[i] = hr[y:y + p * s, x:x + p * s]
        return lr_batch, hr_batch


class Prefetcher:
    """Background-thread prefetch of an iterator, ``depth`` items ahead.
    An error in the worker is raised in the consumer; :meth:`close`
    stops and joins the thread."""

    _SENTINEL = object()

    def __init__(self, it: Iterator, depth: int = 4) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._done = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # noqa: BLE001 -- re-raised in __next__
            self._error = e
        finally:
            # Deliver the sentinel on exhaustion or error, but do not
            # block for good once close() has set _stop.
            while True:
                try:
                    self._q.put(self._SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    if self._stop.is_set():
                        break

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise RuntimeError("Prefetcher is closed")
        if not self._done:
            item = self._q.get()
            if item is not self._SENTINEL:
                return item
            self._done = True
        if self._error is not None:
            raise self._error
        raise StopIteration

    def close(self) -> None:
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)


def _resolve_train_source(opts):
    """``synthetic`` (32 procedural images from ``--seed``), the DIV2K
    layout ``<data_root>/DIV2K/DIV2K_train_HR`` (+
    ``DIV2K_train_LR_bicubic/X<scale>`` when present) for ``DIV2K``, or
    ``<data_root>/<name>`` as a plain HR folder."""
    name = opts.train_dataset.lower()
    if name == "synthetic":
        return SyntheticImages(num_images=32, seed=opts.seed)
    div2k_hr = os.path.join(opts.data_root, "DIV2K", "DIV2K_train_HR")
    div2k_lr = os.path.join(opts.data_root, "DIV2K",
                            "DIV2K_train_LR_bicubic", f"X{opts.scale}")
    if name == "div2k" and os.path.isdir(div2k_hr):
        return PairedImageFolder(
            div2k_hr, div2k_lr if os.path.isdir(div2k_lr) else None,
            opts.scale)
    plain = os.path.join(opts.data_root, opts.train_dataset)
    if os.path.isdir(plain):
        return PairedImageFolder(plain, None, opts.scale)
    raise FileNotFoundError(
        f"train dataset {opts.train_dataset!r} not found under "
        f"{opts.data_root!r} (use --train_dataset synthetic for the "
        f"procedural corpus)")


def train_num_images(opts) -> int:
    """Images in the training corpus (a listing, no decode): one epoch
    visits them ``num_repeats`` times (DIV2K 800 x 20 / 16 = 1000
    steps)."""
    return len(_resolve_train_source(opts))


def make_train_iterator(opts, start_step: int = 0
                        ) -> Tuple[Prefetcher, bool]:
    """The prefetched train-batch stream of one process:
    ``(iterator, lr_from_files)``.  ``start_step`` (a resume) is folded
    into the seed, as the JAX package does, so a resumed run continues on
    fresh crops instead of replaying the ones already trained on."""
    seed = opts.seed
    if start_step:
        seed = seed * 2_147_483_647 + start_step
    it = PatchIterator(_resolve_train_source(opts), opts.patch_size,
                       opts.scale, opts.batch_size, seed=seed)
    return Prefetcher(it), it.use_lr_files


@dataclasses.dataclass
class EvalSample:
    name: str
    lr: np.ndarray            # HWC uint8
    hr: Optional[np.ndarray]  # HWC uint8 (None if no ground truth)


def _sample(name: str, hr: np.ndarray, lr: Optional[np.ndarray],
            scale: int) -> EvalSample:
    if lr is None:
        lr = host_bicubic_downsample(hr, scale)
    h, w = lr.shape[:2]
    return EvalSample(name, lr, hr[:h * scale, :w * scale])


def _image_files(folder: str, max_images: Optional[int]) -> List[str]:
    files = sorted(f for f in os.listdir(folder)
                   if f.lower().endswith(_IMG_EXTS))
    if not files:
        raise FileNotFoundError(f"no images under {folder}")
    return files if max_images is None else files[:max_images]


def load_eval_set(opts, dataset: Optional[str] = None,
                  max_images: Optional[int] = None) -> List[EvalSample]:
    """Load a benchmark set as full images.

    ``synthetic``: the procedural corpus (5 images of 480 x 480, seed
    ``opts.seed + 1``, as the JAX package).  Otherwise
    ``<data_root>/<name>/HR`` with LR from ``LR_bicubic/X<scale>`` (same
    name or DIV2K's ``<stem>x<scale><ext>``), synthesized on host with
    MATLAB bicubic where that folder or file is missing; without ``HR``,
    the images of ``<name>/LR`` (or ``LR_bicubic/X<scale>``) with no
    ground truth (``hr`` None), as the JAX package."""
    name = dataset or opts.test_dataset
    scale = opts.scale
    if name.lower() == "synthetic":
        src = SyntheticImages(num_images=max_images or 5, seed=opts.seed + 1)
        return [_sample(src.name(i), src.get(i), None, scale)
                for i in range(len(src))]

    hr_dir = os.path.join(opts.data_root, name, "HR")
    lr_dir = os.path.join(opts.data_root, name, "LR_bicubic", f"X{scale}")
    lr_only = os.path.join(opts.data_root, name, "LR")
    if not os.path.isdir(hr_dir):
        # No ground truth (the PIRM-SR test set's layout): the images are
        # the model's input as they are, and only PI can score them.
        src = next((d for d in (lr_only, lr_dir) if os.path.isdir(d)), None)
        if src is None:
            raise FileNotFoundError(
                f"eval dataset {name!r} not found: expected {hr_dir} (with "
                f"an optional {lr_dir}), or LR only in {lr_only}; or use "
                f"--dataset synthetic")
        return [EvalSample(os.path.splitext(f)[0],
                           imread_uint8(os.path.join(src, f)), None)
                for f in _image_files(src, max_images)]
    files = _image_files(hr_dir, max_images)
    samples = []
    for f in files:
        stem, ext = os.path.splitext(f)
        lr = None
        for cand in (f, f"{stem}x{scale}{ext}"):
            p = os.path.join(lr_dir, cand)
            if os.path.exists(p):
                lr = imread_uint8(p)
                break
        samples.append(_sample(stem, imread_uint8(os.path.join(hr_dir, f)),
                               lr, scale))
    return samples
