"""RCAN x4 in the port (Zhang et al., ECCV 2018): the plain module
(``models/rcan.py``), the fused RCAB's plain version against the published
equations, the kernel path ``RCANKernelApply`` (the kernels' plain
versions on the CPU) against the module and against the benchmark's
plain float32 reference (``port_bench/reference/rcan.py``, written apart
from the port), the batch engine against the reference's tiling, the
official key naming, the test CLI, and two faults that must fail the
cell's limits.  No JAX: the JAX package has no RCAN.  One test runs on a
card (``cuda``): the kernel against its plain version at the engine's
tile shapes."""

import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from pesr_torch import convert
from pesr_torch.models.rcan import RCAN, count_parameters
from pesr_torch.models.rcan_apply import RCANKernelApply
from pesr_torch.ops import kernels
from pesr_torch.ops.kernels import rcab as K
from pesr_torch.ops.kernels.resblock import pack_resblock
from pesr_torch.ops.tiling import BatchTiledUpscaler
from port_bench.reference import rcan as reference
from port_bench.reference import tiling
from port_bench.reference.compare import Tally
from port_bench.reference.families import rcan as family
from port_bench.traffic.generate import Traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CONFIG = json.loads((ROOT / "port_bench/configs/rcan_x4.json").read_text())
MIX = json.loads((ROOT / "port_bench/mixes/batch_bf16.json").read_text())
LIMITS = json.loads((ROOT / "port_bench/checks/rcan_x4.batch_bf16.json")
                    .read_text())["limits"]
SMALL = {**CONFIG, "num_groups": 2, "num_blocks": 2}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these tests run thousands of small ops, whose
    thread-pool barriers stall for whole scheduler slices when the test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rcan(model: dict, seed: int = 7) -> tuple:
    """The module with the benchmark's weights for ``model``."""
    sd = family.make_state_dict(model, seed, CPU)
    net = RCAN(model["scale"], model["num_groups"], model["num_blocks"],
               model["num_channels"], model["reduction"], device=CPU,
               seed=None)
    net.load_state_dict({**net.state_dict(), **sd}, strict=True)
    return net, sd


def _x(b, h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, h, w, 3, generator=g) * 2 - 1


def test_rcan_x4_has_the_published_size_and_names():
    """RCAN x4's defaults (on the meta device: shapes only): 15,592,355
    parameters in the official names, the MeanShifts' fixed 24 numbers
    apart; a seeded model keeps its MeanShifts (RGB mean x 255, identity
    weight)."""
    net = RCAN(device="meta", seed=None)
    assert count_parameters(net) == 15_592_355
    names = convert.rcan_conv_names(10, 20, 4)
    want = [f"{m}.{leaf}" for m in ("sub_mean", "add_mean") + tuple(names)
            for leaf in ("weight", "bias")]
    assert sorted(net.state_dict()) == sorted(want)
    assert list(net.state_dict())[:4] == ["sub_mean.weight", "sub_mean.bias",
                                          "add_mean.weight", "add_mean.bias"]
    small = RCAN(4, 1, 1, device=CPU, seed=0)
    assert torch.equal(small.sub_mean.bias,
                       -255 * torch.tensor([0.4488, 0.4371, 0.4040]))
    assert torch.equal(small.add_mean.weight.view(3, 3), torch.eye(3))


def test_official_state_dict_loads_strictly(tmp_path):
    """A state dict in RCAN_BIX4.pt's naming (a DataParallel ``module.``
    prefix, the MeanShifts in it) loads strictly and serves the same
    forward; a missing or unknown entry is refused by name."""
    net, _ = _rcan(SMALL)
    official = {f"module.{k}": v.clone() for k, v in net.state_dict().items()}
    path = tmp_path / "RCAN_BIX4.pt"
    torch.save(official, path)
    sd = convert.load_rcan_pth(str(path), 2, 2, 4)
    other = RCAN(4, 2, 2, device=CPU, seed=None)
    other.load_state_dict(sd, strict=True)
    x = _x(1, 9, 11)
    with torch.no_grad():
        assert torch.equal(other(x), net(x))
    del official["module.body.1.body.0.body.3.conv_du.2.bias"]
    official["module.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="conv_du.2.bias.*extra.weight"):
        convert.rcan_state_dict_from_torch(official, 2, 2, 4)


def test_module_is_the_reference():
    """The port's plain module and the benchmark's plain reference, both
    float32 from one state dict: the same arithmetic up to the order of
    float32 sums (~1e-6 of the output's scale)."""
    net, sd = _rcan(SMALL)
    x = _x(2, 13, 17)
    with torch.no_grad():
        got = net(x)
    want = reference.forward(x, sd, SMALL)
    assert torch.allclose(got, want, rtol=0, atol=2e-5)


def _squeeze(c=64, cr=4, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(cr, c, 1, 1, generator=g) * 0.3,
            torch.randn(cr, generator=g) * 0.1,
            torch.randn(c, cr, 1, 1, generator=g) * 0.5,
            torch.randn(c, generator=g) * 0.1)


def test_fused_rcab_plain_version_is_the_published_rcab():
    """In float32, two blocks of ``fused_rcab`` (each applying the one
    before as it loads its input) and the excite are RCAB_2(RCAB_1(h)) as
    RCAN's own modules compute them: mean over H x W, 1x1 convs, ReLU,
    sigmoid, ``h + s * r``.  float32 sums in another order: 1e-5."""
    net = RCAN(4, 1, 2, device=CPU, seed=3)
    blocks = [net.body[0].body[0], net.body[0].body[1]]
    for b in blocks:  # channel attention that is not ~0.5 everywhere
        for m, t in zip((b.body[3].conv_du[0], b.body[3].conv_du[2]),
                        _squeeze()[::2]):
            m.weight.data.copy_(t)
    h = torch.randn(2, 9, 14, 64)
    packs = []
    for b in blocks:
        c1, c2, ca = b.body[0], b.body[2], b.body[3]
        packs.append((pack_resblock(c1.weight, c1.bias, c2.weight, c2.bias,
                                    torch.float32),
                      K.pack_squeeze(ca.conv_du[0].weight, ca.conv_du[0].bias,
                                     ca.conv_du[2].weight,
                                     ca.conv_du[2].bias)))
    kernels.reset_launch_counts()
    x1, r1, p1 = K.fused_rcab(h, None, None, *packs[0][1], *packs[0][0])
    x2, r2, p2 = K.fused_rcab(x1, r1, p1, *packs[0][1], *packs[1][0])
    out = K.rcab_excite(x2, r2, p2, *packs[1][1])
    with torch.no_grad():
        y1 = blocks[0](h.permute(0, 3, 1, 2))
        want = blocks[1](y1).permute(0, 2, 3, 1)
    assert torch.equal(x1, h)
    assert torch.allclose(x2, y1.permute(0, 2, 3, 1), rtol=0, atol=1e-5)
    assert torch.allclose(out, want, rtol=0, atol=1e-5)
    assert p2.shape == (2, 1, 64)
    assert torch.allclose(p2[:, 0], r2.sum((1, 2)), rtol=1e-6, atol=1e-4)
    assert kernels.launch_counts()["fused_rcab"] == 0  # CPU: plain version


def test_apply_is_the_module_and_the_reference():
    """``RCANKernelApply`` (bf16, folded) against the float32 module and
    the reference on the interior (the fold is exact ``min_halo`` LR px
    inside a zero-padded border): bf16 activations through 4 RCAB and 2
    group convs cost at most a few LSB on the 0..255 scale.  Its uint8
    variant is bitwise the float output quantised."""
    net, sd = _rcan(SMALL)
    x = _x(2, 24, 20)
    with torch.no_grad():
        plain = net(x)
    ref = reference.forward(x, sd, SMALL)
    folded = RCANKernelApply(net)
    assert folded.min_halo == 3 and folded.forwards == 0
    got = folded(x)
    k = 4 * folded.min_halo
    for want in (plain, ref):
        d = 127.5 * (got - want)[:, k:-k, k:-k].abs()
        assert d.max() < 4.0 and d.mean() < 0.3
    from pesr_torch.data.augment import denormalize_to_uint8
    assert torch.equal(folded.uint8_variant(x), denormalize_to_uint8(got))
    assert folded.forwards == 2


def _engine_run(model, seed, tile, hw=None, fault=None,
                dtype=torch.bfloat16, images=2):
    """The batch engine on ``RCANKernelApply`` in ``dtype`` against the
    reference's tiling at the engine's grid, on two of the cell's rendered
    photos (CPU rehearsal size, cropped to ``hw``): the cell's numbers."""
    net, sd = _rcan(model, seed)
    traffic = Traffic(MIX, model["scale"], seed, CPU, 8)
    imgs = [np.ascontiguousarray(im[:hw[0], :hw[1]]) if hw else im
            for im in traffic.images[0][:images]]
    engine = BatchTiledUpscaler(RCANKernelApply(net, dtype), model["scale"],
                                tile, MIX["overlap"], device=CPU)
    grid = engine.grid(len(imgs), *imgs[0].shape[:2])
    halos = tiling.halos(grid, MIX["overlap"], engine.min_halo)
    with fault(halos) if fault else contextlib.nullcontext():
        outs = engine.upscale_many(imgs, images)
    ref = tiling.upscale(torch.from_numpy(np.stack(imgs)), grid,
                         MIX["overlap"], engine.min_halo, model["scale"],
                         family.reference(model, MIX, sd, None, CPU))
    tally = Tally()
    for out, want in zip(outs, ref):
        tally.add(torch.from_numpy(out), want)
    return tally.numbers(), grid


def test_engine_is_the_reference_tiling():
    """Through ``BatchTiledUpscaler`` at the cell's mix (tile "auto",
    overlap 8), 2 groups x 2 RCAB: within the cell's limits, at the grid
    the reference is given."""
    numbers, grid = _engine_run(SMALL, 2 ** 31 + 3, "auto")
    assert grid[0] * grid[1] >= 1
    for name, limit in LIMITS.items():
        assert numbers[name] <= limit, (name, numbers)


class _ones:
    """Channel attention removed: s = 1 everywhere."""

    def __init__(self, halos):
        self.real = K.squeeze_excite

    def __enter__(self):
        K.squeeze_excite = lambda pool, hw, wd, bd, wu, bu: torch.ones(
            pool.shape[0], wu.shape[0])

    def __exit__(self, *exc):
        K.squeeze_excite = self.real


class _core_pool:
    """The pool taken over the tile's core, without its halo."""

    def __init__(self, halos):
        self.real, (self.oh, self.ow) = K.rcab_reference, halos

    def __enter__(self):
        real, oh, ow = self.real, self.oh, self.ow

        def core(*args):
            x, rn, _ = real(*args)
            c = rn[:, oh:rn.shape[1] - oh, ow:rn.shape[2] - ow].float()
            scale = rn.shape[1] * rn.shape[2] / (c.shape[1] * c.shape[2])
            return x, rn, c.sum((1, 2))[:, None, :] * scale
        K.rcab_reference = core

    def __exit__(self, *exc):
        K.rcab_reference = self.real


@pytest.mark.parametrize("fault", [None, _ones, _core_pool],
                         ids=["sound", "no_attention", "core_pool"])
def test_attention_faults_fail_the_cells_limits(fault):
    """At half the cell's depth (5 x 20 RCAB, its ``branch_gain``), in
    float32 (so that only the fault moves the output), on a 24 x 24 LR
    crop in tiles of 12 with the cell's overlap: the sound path holds the
    limits; without channel attention, or with the pool over each tile's
    core only, some limit fails (core only: ~4% of subpixels off).  Here
    the halo is most of a tile; in the cell's [144, 342] tiles it is ~11%,
    and a core-only pool moves the output by less than bf16's own drift,
    so there the kernel's pooled sums, held to the whole tile's on the
    card, are what keep the pool's region."""
    model = {**CONFIG, "num_groups": 5}
    numbers, grid = _engine_run(model, 2 ** 31 + 11, 12, (24, 24), fault,
                                torch.float32, images=1)
    assert grid == (2, 2, 12, 12)
    held = all(numbers[k] <= v for k, v in LIMITS.items())
    assert held == (fault is None), numbers


def _parent_critical(b, h, w, clusters=66):
    """Steps of the busiest CTA slot under equal segments, one per CTA:
    ``rows`` (a multiple of 4) minimising (waves of ``2 clusters`` CTAs)
    x (rows / 4 + 1), ties to longer segments; waves x (rows / 4 + 1
    conv1 + rows / 4 conv2 steps)."""
    strips, best = -(-w // 62), None
    for rows in range(4, -(-h // 4) * 4 + 1, 4):
        ctas = -(-b * strips * -(-h // rows) // 2) * 2
        waves = -(-ctas // (2 * clusters))
        if best is None or waves * (rows // 4 + 1) <= best[0]:
            best = (waves * (rows // 4 + 1), waves * (2 * (rows // 4) + 1))
    return best[1]


@pytest.mark.parametrize("shape", [
    (8, 144, 342, 66), (2, 37, 70, 66), (1, 2, 2, 66), (3, 9, 130, 66),
    (8, 72, 516, 66), (3, 139, 300, 66), (1, 103, 553, 60), (7, 53, 200, 5)],
    ids=lambda s: "x".join(map(str, s)))
def test_schedule_is_one_wave_of_runs_in_steps_of_four_rows(shape):
    """Every (image, strip, 4-row step) of the batch is covered exactly
    once; the two CTAs of each cluster run segments of the same lengths;
    the CTAs are one wave of the clusters; the busiest CTA runs no more
    steps than equal segments in waves would; and the pooled partials, as
    a plain emulation of the kernel writes them (a row per segment, zeros
    in the rows after an image's last), fill every row once and add up to
    the tile's sums per image.  (3, 139, 300): odd B, ragged, runs that
    cross strips and images; (1, 103, 553) on 60 clusters: equal
    segments win."""
    b, h, w, clusters = shape
    s = K.rcab_schedule(b, h, w, clusters)
    assert s.ctas == len(s.segments) == 2 * clusters
    assert (s.strips, s.steps) == (-(-w // 62), -(-h // 4))
    assert K.rcab_work(b, h, w, clusters)[:3] == (s.ctas, 1, s.critical)
    count = np.zeros((b * s.strips, s.steps), int)
    for segs in s.segments:
        for g, j0, n, _, _ in segs:
            assert n >= 1 and 0 <= j0 < s.steps
            if g < b * s.strips:
                count[g, j0:j0 + n] += 1
    assert (count == 1).all()
    for c in range(clusters):
        assert ([n for _, _, n, _, _ in s.segments[2 * c]]
                == [n for _, _, n, _, _ in s.segments[2 * c + 1]])
    steps = [sum(2 * n + 1 for _, _, n, _, _ in segs) for segs in s.segments]
    assert s.critical == max(steps) <= _parent_critical(b, h, w, clusters)
    g = torch.Generator().manual_seed(b * h * w)
    r = torch.randn(b, h, w, 3, generator=g, dtype=torch.float64)
    pool = torch.zeros(b, s.pool_rows, 3, dtype=torch.float64)
    written = np.zeros((b, s.pool_rows), int)
    for segs in s.segments:
        for g, j0, n, row, fill in segs:
            i, k = divmod(g, s.strips)
            if i < b:
                pool[i, row] = r[i, 4 * j0:4 * (j0 + n),
                                 62 * k:62 * k + 62].sum((0, 1))
                written[i, row:row + fill + 1] += 1
    assert (written == 1).all()
    assert torch.allclose(pool.sum(1), r.sum((1, 2)), rtol=1e-12, atol=1e-9)
    if shape[:3] == (3, 139, 300):
        images = [{g // s.strips for g, *_ in segs if g < b * s.strips}
                  for segs in s.segments]
        strips = [{g for g, *_ in segs if g < b * s.strips}
                  for segs in s.segments]
        assert max(map(len, images)) > 1 and max(map(len, strips)) > 1


def test_schedule_at_the_cells_tile_is_one_wave():
    """The cell's tile batch [8, 144, 342] (4 positions of a 510 x 336
    photo batch) on the H100's 66 clusters: 132 CTAs in one wave, the
    busiest running 29 steps of 4 rows, against 34 for 240 CTAs of equal
    32-row segments in two waves of 132; 22 pooled partials per image;
    3,626 steps run for the 3,456 the tile needs."""
    s = K.rcab_schedule(8, 144, 342)
    assert (s.ctas, s.strips, s.steps, s.pool_rows, s.critical) == \
        (132, 6, 36, 22, 29)
    assert _parent_critical(8, 144, 342) == 34
    assert K.rcab_work(8, 144, 342) == (132, 1, 29, 3626, 3456)


def test_schedule_never_loses_to_equal_segments():
    """At 300 seeded shapes and cluster counts, the busiest CTA runs no
    more steps than under equal segments in waves."""
    rng = np.random.default_rng(23)
    for _ in range(300):
        b, h, w = (int(v) for v in rng.integers(1, (9, 160, 400)))
        clusters = int(rng.choice([1, 2, 5, 33, 60, 66]))
        assert (K.rcab_schedule(b, h, w, clusters).critical
                <= _parent_critical(b, h, w, clusters)), (b, h, w, clusters)


def test_waves_counter_resets_with_the_launch_counts():
    """``fused_rcab.waves`` counts CUDA launches' waves only (the plain
    version on the CPU adds none); ``reset_launch_counts`` zeroes it and
    ``launch_counts()`` keeps its four keys."""
    K.fused_rcab.waves = K.fused_rcab.launches = 3
    kernels.reset_launch_counts()
    assert K.fused_rcab.waves == 0
    assert set(kernels.launch_counts()) == {
        "fused_resblock", "fused_upsampler_stage", "fused_rcab",
        "rcab_excite"}
    g = torch.Generator().manual_seed(4)
    convs = pack_resblock(*(torch.randn(64, 64, 3, 3, generator=g) / 24,
                            torch.zeros(64)) * 2)
    h = torch.randn(1, 5, 7, 64, generator=g).bfloat16()
    K.fused_rcab(h, None, None, *K.pack_squeeze(*_squeeze()), *convs)
    assert K.fused_rcab.waves == 0 and K.fused_rcab.launches == 0


def test_cli_arch_rcan_on_the_cpu(tmp_path, capsys):
    from pesr_torch import test as cli
    out = cli.run(["--arch", "rcan", "--dataset", "synthetic", "--device",
                   "cpu", "--num_groups", "1", "--num_blocks", "1",
                   "--output_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "RCAN 1 groups x 1 RCAB x 64 channels, reduction 16" in text
    assert "RCAN on fused_rcab, folded upsampler" in text
    assert out["precision"] == "folded-bfloat16" and out["forwards"] >= 1
    assert len(list((tmp_path / "synthetic").glob("*.png"))) == out["images"]
    for flags, refused in ((["--quant", "int8"], "--quant int8"),
                           (["--no_fold"], "--no_fold")):
        with pytest.raises(SystemExit, match=refused):
            cli.run(["--arch", "rcan", *flags, "--device", "cpu",
                     "--dataset", "synthetic"])
    opts = cli.opts_from_args(["--arch", "rcan"])
    assert (opts.num_groups, opts.num_blocks, opts.num_channels,
            opts.reduction) == (10, 20, 64, 16)
    edsr = cli.opts_from_args([])
    assert (edsr.arch, edsr.num_blocks, edsr.num_channels) == ("edsr", 32, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 144, 342), (2, 37, 70), (3, 9, 130),
                                   (1, 2, 2), (3, 139, 300)])
def test_fused_rcab_kernel_is_its_plain_version(shape):
    """On a card, C = 64: ``x`` within one bf16 ulp of ``h + s r`` (``s``
    is summed in another order), ``r`` within bf16's rounding of float32
    math on the same operands, the pooled partials' sum within 1e-4, one
    wave a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(0)
    b, h, w = shape
    c1w, c2w = (torch.randn(64, 64, 3, 3, generator=g, device=dev) / 24
                for _ in range(2))
    c1b, c2b = (torch.randn(64, generator=g, device=dev) * 0.1
                for _ in range(2))
    convs = pack_resblock(c1w, c1b, c2w, c2b)
    sq = K.pack_squeeze(*(t.to(dev) for t in _squeeze()))
    hh = torch.randn(b, h, w, 64, generator=g, device=dev).bfloat16()
    rr = torch.randn(b, h, w, 64, generator=g, device=dev).bfloat16()
    pool = torch.randn(b, 3, 64, generator=g, device=dev) * h * w / 3
    for prev in (False, True):
        waves = K.fused_rcab.waves
        x, rn, pn = K.fused_rcab(hh, rr if prev else None,
                                 pool if prev else None, *sq, *convs)
        assert K.fused_rcab.waves == waves + 1
        want_x = K.excite_reference(hh, rr, pool, *sq) if prev else hh
        s = K.squeeze_excite(pool, h * w, *sq)[:, None, None]
        tol = (hh.float().abs() + (s * rr.float()).abs()) * 2 ** -7
        assert ((x.float() - want_x.float()).abs() <= tol).all()
        t = torch.relu(torch.nn.functional.conv2d(
            x.float().permute(0, 3, 1, 2), c1w.bfloat16().float(),
            convs[1], padding=1)).bfloat16().float()
        want = torch.nn.functional.conv2d(t, c2w.bfloat16().float(),
                                          convs[3], padding=1)
        want = want.permute(0, 2, 3, 1)
        assert (rn.float() - want).abs().max() <= 1e-2 * want.abs().max()
        total = want.sum((1, 2))
        assert (pn.sum(1) - total).abs().max() <= 1e-4 * total.abs().max()
    e = K.rcab_excite(hh, rr, pool, *sq)
    assert ((e.float() - K.excite_reference(hh, rr, pool, *sq).float()).abs()
            <= tol).all()
