"""Host-side datasets (counterpart of ``pesr_tpu/data/datasets.py``):
the procedural ``synthetic``, ``synthetic_hard`` and ``synthetic_hard_x4``
corpora, the ``natural`` photographs of installed packages
(``data/natural.py``), MATLAB-bicubic host resizing, DIV2K-layout and
plain image folders, benchmark folders in the ``<name>/HR`` +
``<name>/LR_bicubic/X<scale>`` layout, and the training stream.

The stream of one process (:func:`make_train_iterator`): in HR-crop mode
the native multithreaded sampler (``data/native``) over the decoded
corpus, when its library builds and the corpus fits
``_NATIVE_CACHE_BYTES``; otherwise, and always with LR files, the Python
:class:`PatchIterator`; either behind a :class:`Prefetcher` thread, as
the JAX package chooses.  It prints which one feeds the run.
``synthetic_device`` renders HR batches on the training device
(``data/device_synth.py``).  PNGs decode through the native libpng core
when it builds, other files (and PNGs without it) through Pillow.

Not ported yet: the per-process streams of a multi-process run.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pesr_torch.data import native
from pesr_torch.ops.resize import resize_kernel_matrix
from pesr_torch.utils.image_io import imread_uint8

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp")
# RAM budget for decoding a whole corpus for the native sampler (the
# JAX package's; DIV2K's train HR is ~6.6 GB decoded).
_NATIVE_CACHE_BYTES = 12 << 30


def decode_image(path: str) -> np.ndarray:
    """An image file as HWC uint8 RGB: a PNG through the native libpng
    core when its library builds, anything else (or a PNG without it)
    through Pillow."""
    if path.lower().endswith(".png") and native.available():
        return native.decode_png(path)
    try:
        return imread_uint8(path)
    except ImportError as e:
        why = native.unavailable_reason()
        raise ImportError(f"{e}" + (f"; the native PNG decoder is "
                                    f"unavailable too ({why})"
                                    if why else "")) from e


class SyntheticImages:
    """Procedural HR images, deterministic per (seed, index); the JAX
    package's corpus with identical draws, so the renders are equal bit
    for bit.  A pipeline exerciser, NOT a quality benchmark.

    ``variant``: ``"classic"`` (``synthetic``: smooth low-frequency
    fields, rectangles and fine noise); ``"hard"`` (``synthetic_hard``:
    glyph strokes, fine oriented line textures, small-period
    checkerboards and step edges, rendered at 2x and area-averaged down,
    with energy in the 0.1-0.35 cycles/px band that x2 SR restores; at x4
    that band lies above the LR Nyquist, a negative control);
    ``"hard_x4"`` (``synthetic_hard_x4``: the same features 4x coarser,
    ~0.044-0.12 cycles/px, below the x4 LR Nyquist of 0.125)."""

    def __init__(self, num_images: int = 32, height: int = 480,
                 width: int = 480, seed: int = 0,
                 variant: str = "classic") -> None:
        if variant not in ("classic", "hard", "hard_x4"):
            raise ValueError(f"unknown synthetic variant {variant!r}")
        self.num_images = num_images
        self.height, self.width = height, width
        self.seed = seed
        self.variant = variant
        self._cache: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return self.num_images

    def name(self, idx: int) -> str:
        tag = {"classic": "synthetic", "hard": "synthhard",
               "hard_x4": "synthhardx4"}[self.variant]
        return f"{tag}_{idx:04d}"

    def _render(self, idx: int) -> np.ndarray:
        if self.variant != "classic":
            return self._render_hard(idx)
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

    def _render_hard(self, idx: int) -> np.ndarray:
        # Per-variant feature bands.  "hard" targets the x2 restoration
        # band; "hard_x4" scales every feature ~4x coarser so the
        # energy sits below the x4 LR Nyquist (0.125 cyc/px final).
        # Same rng stream and literal ranges as the JAX package's, so
        # the renders are byte-identical.
        x4 = self.variant == "hard_x4"
        # (lo, hi) in cycles/px at the 2x render; final band is 2x.
        f_rng = (0.022, 0.06) if x4 else (0.05, 0.175)
        per_rng = (16, 53) if x4 else (4, 13)     # checker period @2x
        thick_rng = (8.0, 24.0) if x4 else (2.0, 6.0)   # stroke @2x
        len_rng = (32, 240) if x4 else (8, 60)
        strokes_rng = (15, 40) if x4 else (60, 120)
        rng = np.random.default_rng(self.seed * 100003 + idx
                                    + (778002 if x4 else 777001))
        # Render at 2x, then 2x2 area-average: edges/strokes come out
        # antialiased (camera-like) instead of aliased 1-px staircases.
        h2, w2 = self.height * 2, self.width * 2
        img = np.zeros((h2, w2, 3), np.float64)
        yy, xx = np.mgrid[0:h2, 0:w2].astype(np.float64)

        # Smooth base (weaker than classic: detail is the point here).
        for _ in range(3):
            fy, fx = rng.uniform(0.5, 12.0, 2)
            phase = rng.uniform(0, 2 * np.pi)
            g = np.cos(2 * np.pi * (fy * yy / h2 + fx * xx / w2) + phase)
            img += rng.uniform(0.05, 0.2) * g[:, :, None] \
                * rng.uniform(0.3, 1.0, 3)

        # Windowed oriented gratings: energy at 2*f_rng cycles/px in
        # FINAL-resolution units (x0.5 here pre-downsample) — 0.1-0.35
        # for "hard", 0.044-0.12 (sub-x4-Nyquist) for "hard_x4".
        for _ in range(6):
            f = rng.uniform(*f_rng)           # cycles/px at 2x res
            theta = rng.uniform(0, np.pi)
            cy, cx = rng.uniform(0.1, 0.9) * h2, rng.uniform(0.1, 0.9) * w2
            sig = rng.uniform(0.04, 0.15) * h2
            window = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                            / (2 * sig ** 2))
            carrier = np.cos(2 * np.pi * f * (np.cos(theta) * yy
                                              + np.sin(theta) * xx)
                             + rng.uniform(0, 2 * np.pi))
            img += (rng.uniform(0.25, 0.5) * window * carrier)[:, :, None] \
                * rng.uniform(0.5, 1.0, 3)

        # Step edges at many orientations: half-plane fills inside
        # random circular regions.
        for _ in range(8):
            cy, cx = rng.uniform(0, h2), rng.uniform(0, w2)
            r = rng.uniform(0.05, 0.25) * h2
            ny, nx = np.sin(t := rng.uniform(0, np.pi)), np.cos(t)
            region = ((yy - cy) ** 2 + (xx - cx) ** 2) < r ** 2
            half = (ny * (yy - cy) + nx * (xx - cx)) > 0
            img[region & half] += rng.uniform(-0.5, 0.5, 3)

        # Checkerboard patches, period 4-12 px at 2x (2-6 px final).
        # The range clamps keep small canvases legal (low < high) and
        # change no draw at the default 480x480.
        for _ in range(3):
            y0, x0 = int(rng.integers(0, max(1, h2 - 64))), \
                int(rng.integers(0, max(1, w2 - 64)))
            ph = min(int(rng.integers(min(48, max(2, h2 // 4) - 1),
                                      max(49, h2 // 4))), h2 - y0)
            pw = min(int(rng.integers(min(48, max(2, w2 // 4) - 1),
                                      max(49, w2 // 4))), w2 - x0)
            per = int(rng.integers(*per_rng))
            ys, xs = np.mgrid[0:ph, 0:pw]
            board = (((ys // per) + (xs // per)) % 2).astype(np.float64)
            img[y0:y0 + ph, x0:x0 + pw] += (
                rng.uniform(0.3, 0.6) * (board - 0.5))[:, :, None] \
                * rng.uniform(0.5, 1.0, 3)

        # Text-like glyph strokes: short high-contrast segments with
        # 2-6 px thickness (1-3 px final), drawn via distance-to-segment
        # inside each stroke's bounding box.
        n_strokes = int(rng.integers(*strokes_rng))
        for _ in range(n_strokes):
            y0, x0 = rng.uniform(0, h2), rng.uniform(0, w2)
            length = rng.uniform(*len_rng)
            t = rng.uniform(0, np.pi)
            y1 = np.clip(y0 + length * np.sin(t), 0, h2 - 1)
            x1 = np.clip(x0 + length * np.cos(t), 0, w2 - 1)
            thick = rng.uniform(*thick_rng)
            lo_y, hi_y = int(max(0, min(y0, y1) - thick - 1)), \
                int(min(h2, max(y0, y1) + thick + 1))
            lo_x, hi_x = int(max(0, min(x0, x1) - thick - 1)), \
                int(min(w2, max(x0, x1) + thick + 1))
            if hi_y <= lo_y or hi_x <= lo_x:
                continue
            ly, lx = np.mgrid[lo_y:hi_y, lo_x:hi_x].astype(np.float64)
            dy, dx = y1 - y0, x1 - x0
            den = dy * dy + dx * dx + 1e-9
            tt = np.clip(((ly - y0) * dy + (lx - x0) * dx) / den, 0, 1)
            dist = np.hypot(ly - (y0 + tt * dy), lx - (x0 + tt * dx))
            mask = np.clip(thick / 2 + 0.5 - dist, 0, 1)  # soft edge
            img[lo_y:hi_y, lo_x:hi_x] += (
                rng.uniform(-0.9, 0.9) * mask)[:, :, None]

        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        # 2x2 area-average down to the final resolution.
        img = img.reshape(self.height, 2, self.width, 2, 3).mean((1, 3))
        return (img * 255.0).round().astype(np.uint8)

    def get(self, idx: int) -> np.ndarray:
        if idx not in self._cache:
            self._cache[idx] = self._render(idx)
        return self._cache[idx]


class NaturalImages:
    """The ``natural`` corpus (``data/natural.py``) as a source: training
    leaves the holdout photographs out, evaluation
    (``include_holdout=True``) takes them.  Raises ``FileNotFoundError``
    when no registered photograph is installed on this machine."""

    def __init__(self, include_holdout: bool = False) -> None:
        from pesr_torch.data.natural import load_natural_images, missing_error
        self._images = load_natural_images(include_holdout=include_holdout)
        if not self._images:
            raise missing_error()

    def __len__(self) -> int:
        return len(self._images)

    def name(self, idx: int) -> str:
        return self._images[idx][0]

    def get(self, idx: int) -> np.ndarray:
        return self._images[idx][1]


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
            self._cache[path] = decode_image(path)
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


_SYNTH_VARIANTS = {"synthetic": "classic", "synthetic_hard": "hard",
                   "synthetic_hard_x4": "hard_x4"}


def _resolve_train_source(opts):
    """``synthetic`` / ``synthetic_hard`` / ``synthetic_hard_x4`` (32
    procedural images from ``--seed``), ``natural`` (the installed
    photographs without the holdouts), the DIV2K layout
    ``<data_root>/DIV2K/DIV2K_train_HR`` (+ ``DIV2K_train_LR_bicubic/
    X<scale>`` when present) for ``DIV2K``, or ``<data_root>/<name>`` as a
    plain HR folder."""
    name = opts.train_dataset.lower()
    if name in _SYNTH_VARIANTS:
        return SyntheticImages(num_images=32, seed=opts.seed,
                               variant=_SYNTH_VARIANTS[name])
    if name == "natural":
        return NaturalImages(include_holdout=False)
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
    steps).  ``synthetic_device`` has no list and takes the in-memory
    corpus's 32."""
    if opts.train_dataset.lower() == "synthetic_device":
        return 32
    return len(_resolve_train_source(opts))


def _decode_within_budget(src) -> Optional[List[np.ndarray]]:
    """Every HR image of ``src``, decoded in parallel chunks of 8, or None
    once their bytes pass ``_NATIVE_CACHE_BYTES`` (the check runs between
    chunks, so the overshoot is one chunk; the source's cache is then
    dropped)."""
    getter = src.get_hr if hasattr(src, "get_hr") else src.get
    images, total, chunk = [], 0, 8
    with ThreadPoolExecutor(max_workers=4) as pool:
        for i0 in range(0, len(src), chunk):
            ims = list(pool.map(getter, range(i0, min(i0 + chunk,
                                                      len(src)))))
            images.extend(ims)
            total += sum(im.nbytes for im in ims)
            if total > _NATIVE_CACHE_BYTES:
                if hasattr(src, "_cache"):
                    src._cache.clear()
                return None
    return images


def make_train_iterator(opts, start_step: int = 0, mesh=None
                        ) -> Tuple[Iterator, bool]:
    """The train-batch stream of one process: ``(iterator,
    lr_from_files)``; the iterator yields ``(lr_u8 or None, hr_u8)`` and
    has ``close()``.  ``start_step`` (a resume) is folded into the seed,
    as the JAX package does, so a resumed run continues on fresh data
    instead of replaying what it already trained on.

    On a ``mesh`` of P processes (JAX: ``jax.process_count()``) the
    batch is this rank's ``batch_size / P`` (the global batch must
    divide) from a stream of its own, seeded ``seed * 1_000_003 + rank``
    before the resume's re-seed: identical seeds would train on P copies
    of one block.  ``synthetic_device`` keeps one key on every rank
    instead and renders this rank's block of the global batch, each
    sample fixed by its global index.

    ``synthetic_device``: :class:`DeviceSyntheticStream` on
    ``opts.device`` (the batches are device tensors).  Otherwise, in
    HR-crop mode, the native sampler over the decoded corpus when its
    library builds and the corpus fits ``_NATIVE_CACHE_BYTES``; else, and
    always with LR files, :class:`PatchIterator`; behind a
    :class:`Prefetcher`.  Prints the ``HR source`` chosen and why."""
    if opts.train_dataset.lower() == "synthetic_device":
        from pesr_torch.data.device_synth import DeviceSyntheticStream
        print("HR source: rendered on the device (synthetic_device), "
              "no batch upload")
        return (DeviceSyntheticStream(opts, opts.device, start_step, mesh),
                False)
    n_proc = mesh.size if mesh is not None else 1
    batch, seed = opts.batch_size, opts.seed
    if n_proc > 1:
        if opts.batch_size % n_proc:
            raise ValueError(
                f"--batch_size {opts.batch_size} must be divisible by "
                f"the process count {n_proc} (it is the GLOBAL batch)")
        batch = opts.batch_size // n_proc
        seed = opts.seed * 1_000_003 + mesh.rank
    if start_step:
        seed = seed * 2_147_483_647 + start_step
    src = _resolve_train_source(opts)
    it = PatchIterator(src, opts.patch_size, opts.scale, batch, seed=seed)
    if it.use_lr_files:
        why = "LR files: each HR crop pairs with its LR file's crop"
    elif not native.available():
        why = f"native data library unavailable: {native.unavailable_reason()}"
    else:
        images = _decode_within_budget(src)
        why = (f"decoded corpus over the native sampler's "
               f"{_NATIVE_CACHE_BYTES >> 30} GiB budget")
        if images is not None:
            try:
                sampler = native.NativePatchSampler(
                    images, opts.hr_patch_size, batch, seed=seed)
            except ValueError as e:
                why = f"native sampler refused the corpus: {e}"
            else:
                print(f"HR source: native sampler ({len(sampler)} images, "
                      f"{sampler.threads} threads)")
                return Prefetcher(sampler), False
    print(f"HR source: PatchIterator ({why})")
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

    ``synthetic``, ``synthetic_hard``, ``synthetic_hard_x4``: the
    procedural corpus (``max_images`` or 5 images of 480 x 480, seed
    ``opts.seed + 1``, as the JAX package); ``natural``: the installed
    photographs with the holdouts; ``synthetic_device``: ``max_images``
    or 5 images of 480 x 480 rendered on ``opts.device`` from the key
    ``opts.seed + 1``, named ``device_<i>``.  Their LR is the host's
    MATLAB bicubic.  Otherwise ``<data_root>/<name>/HR`` with LR from
    ``LR_bicubic/X<scale>`` (same name or DIV2K's
    ``<stem>x<scale><ext>``), synthesized on host with MATLAB bicubic
    where that folder or file is missing; without ``HR``, the images of
    ``<name>/LR`` (or ``LR_bicubic/X<scale>``) with no ground truth
    (``hr`` None), as the JAX package."""
    name = dataset or opts.test_dataset
    scale = opts.scale
    key = name.lower()
    if key == "synthetic_device":
        from pesr_torch.data.device_synth import render_hr_batch
        n = max_images or 5
        hrs = render_hr_batch(opts.seed + 1, n, 480, scale,
                              opts.device).cpu().numpy()
        return [_sample(f"device_{i:03d}", hrs[i], None, scale)
                for i in range(n)]
    if key in _SYNTH_VARIANTS or key == "natural":
        src = (NaturalImages(include_holdout=True) if key == "natural"
               else SyntheticImages(num_images=max_images or 5,
                                    seed=opts.seed + 1,
                                    variant=_SYNTH_VARIANTS[key]))
        n = len(src) if max_images is None else min(len(src), max_images)
        return [_sample(src.name(i), src.get(i), None, scale)
                for i in range(n)]

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
                           decode_image(os.path.join(src, f)), None)
                for f in _image_files(src, max_images)]
    files = _image_files(hr_dir, max_images)
    samples = []
    for f in files:
        stem, ext = os.path.splitext(f)
        lr = None
        for cand in (f, f"{stem}x{scale}{ext}"):
            p = os.path.join(lr_dir, cand)
            if os.path.exists(p):
                lr = decode_image(p)
                break
        samples.append(_sample(stem, decode_image(os.path.join(hr_dir, f)),
                               lr, scale))
    return samples
