"""The port's training ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both.  Gradients of
the kernels' differentiable forms (kernel forward, a backward of library
convolution gradients) are held against ``jax.grad`` of the Pallas
kernels in interpret mode, in f32, to the tolerance tests/test_pallas.py
holds the Pallas kernels' own gradients to (atol 2e-5, rtol 1e-4: the
same convs in f32 with another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pesr_tpu import losses as jax_losses
from pesr_tpu.data import augment as jax_augment
from pesr_tpu.models import Generator as JaxGenerator
from pesr_tpu.models.pallas_apply import make_pallas_apply
from pesr_tpu.ops.pallas import fused_resblock as jax_fused_resblock
from pesr_tpu.ops.pallas import fused_upsampler_stage as jax_fused_up
from pesr_tpu.ops.resize import imresize as jax_imresize
from pesr_torch import losses
from pesr_torch.convert import state_dict_from_jax
from pesr_torch.data import augment
from pesr_torch.models.generator import Generator
from pesr_torch.models.kernel_apply import KernelApply, KernelTrainApply
from pesr_torch.ops import kernels
from pesr_torch.ops.kernels import (fused_resblock_train,
                                    fused_upsampler_stage_train,
                                    resblock_reference,
                                    upsampler_stage_reference)
from pesr_torch.ops.resize import imresize
from torch.utils._python_dispatch import TorchDispatchMode

T = torch.from_numpy
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _hwio(t: torch.Tensor) -> np.ndarray:
    """OIHW torch gradient -> HWIO numpy, the JAX layout."""
    return t.permute(2, 3, 1, 0).numpy()


def _leaves(*arrays):
    return [T(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("b,h,w,res_scale", [(2, 13, 10, 0.3),
                                             (1, 8, 8, 1.0)])
def test_resblock_train_grads_match_jax_pallas(b, h, w, res_scale):
    rng = np.random.default_rng(h)
    c = 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    w1, w2 = ((rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32)
              for _ in range(2))
    b1, b2 = ((rng.standard_normal((c,)) * 0.1).astype(np.float32)
              for _ in range(2))

    def loss(x, w1, b1, w2, b2):
        return jnp.sum(jnp.sin(jax_fused_resblock(
            x, w1, b1, w2, b2, res_scale=res_scale, tile=(8, 8),
            interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (x, w1, b1, w2, b2)))
    args = _leaves(x, w1.transpose(3, 2, 0, 1).copy(), b1,
                   w2.transpose(3, 2, 0, 1).copy(), b2)
    kernels.reset_launch_counts()
    torch.sin(fused_resblock_train(*args, res_scale=res_scale)).sum() \
        .backward()
    got = [args[0].grad.numpy(), _hwio(args[1].grad), args[2].grad.numpy(),
           _hwio(args[3].grad), args[4].grad.numpy()]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **GRAD_TOL)
    assert kernels.launch_counts()["fused_resblock"] == 0  # CPU: plain


@pytest.mark.parametrize("b,h,w", [(1, 9, 7), (2, 6, 11)])
def test_upsampler_train_grads_match_jax_pallas(b, h, w):
    rng = np.random.default_rng(11 + h)
    c = 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, 4 * c)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((4 * c,)) * 0.1).astype(np.float32)

    def loss(x, w, b):
        return jnp.sum(jnp.cos(jax_fused_up(x, w, b, tile=(8, 8),
                                            interpret=True)))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, wt, bias)))
    args = _leaves(x, wt.transpose(3, 2, 0, 1).copy(), bias)
    torch.cos(fused_upsampler_stage_train(*args)).sum().backward()
    got = [args[0].grad.numpy(), _hwio(args[1].grad), args[2].grad.numpy()]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **GRAD_TOL)


class _ConvCount(TorchDispatchMode):
    """Counts the convolutions and convolution gradients dispatched."""

    def __init__(self):
        super().__init__()
        self.counts = {"convolution": 0, "convolution_backward": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _stage_inputs(kind, dtype, seed=4):
    rng = np.random.default_rng(seed)
    c, b, h, w = 8, 2, 7, 9
    x = rng.standard_normal((b, h, w, c))
    if kind == "resblock":
        shapes = [(c, c, 3, 3), (c,), (c, c, 3, 3), (c,)]
        cot = (b, h, w, c)
    else:
        shapes = [(4 * c, c, 3, 3), (4 * c,)]
        cot = (b, 2 * h, 2 * w, c)
    ins = [x] + [rng.standard_normal(s) * 0.1 for s in shapes]
    return ([torch.tensor(a, dtype=dtype) for a in ins],
            torch.tensor(rng.standard_normal(cot), dtype=dtype))


def _plain(kind, x, *ws):
    if kind == "resblock":
        w1, b1, w2, b2 = ws
        return resblock_reference(x, w1.permute(2, 3, 1, 0), b1,
                                  w2.permute(2, 3, 1, 0), b2, 0.3)
    w, b = ws
    return upsampler_stage_reference(x, w.permute(2, 3, 1, 0), b)


def _ours(kind, *args):
    if kind == "resblock":
        return fused_resblock_train(*args, res_scale=0.3)
    return fused_upsampler_stage_train(*args)


@pytest.mark.parametrize("kind,convs,conv_grads", [("resblock", 1, 2),
                                                   ("upsampler", 0, 1)])
def test_backward_recomputes_only_what_the_gradient_reads(kind, convs,
                                                          conv_grads):
    """The Functions' backward runs the ops JAX's compiled backward keeps:
    the resblock recomputes conv1 (for the hidden activation and the
    ReLU mask) but not conv2, whose output no gradient reads; the
    upsampler is linear and recomputes nothing."""
    ins, cot = _stage_inputs(kind, torch.float32)
    leaves = [t.requires_grad_() for t in ins]
    out = _ours(kind, *leaves)
    with _ConvCount() as mode:
        torch.autograd.grad(out, leaves, cot)
    assert mode.counts == {"convolution": convs,
                           "convolution_backward": conv_grads}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["resblock", "upsampler"])
def test_backward_is_bitwise_autograd_of_the_plain_version(kind, dtype):
    """On the CPU the backward makes the same convolution_backward calls
    as autograd of the plain version, so its gradients are bitwise
    those, in f32 and bf16; a frozen input gets none."""
    ins, cot = _stage_inputs(kind, dtype)
    ours = [t.clone().requires_grad_() for t in ins]
    got = torch.autograd.grad(_ours(kind, *ours), ours, cot)
    ref_in = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(_plain(kind, *ref_in), ref_in, cot)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)
    part = [t.clone() for t in ins]
    part[-1].requires_grad_()
    part[-2].requires_grad_()
    got = torch.autograd.grad(_ours(kind, *part), part[-2:], cot)
    for g, r in zip(got, want[-2:]):
        assert torch.equal(g, r)


def test_train_functions_grad_only_what_is_asked():
    """A frozen input gets no gradient, and the forward of the
    differentiable form equals the inference wrapper's."""
    rng = np.random.default_rng(3)
    x = T(rng.standard_normal((1, 5, 6, 8)).astype(np.float32))
    w = T((rng.standard_normal((32, 8, 3, 3)) * 0.1).astype(np.float32))
    b = T(np.zeros(32, np.float32)).requires_grad_()
    out = fused_upsampler_stage_train(x, w, b)
    out.sum().backward()
    assert b.grad is not None and w.grad is None and x.grad is None
    want = kernels.fused_upsampler_stage(
        x, *kernels.pack_upsampler_stage(w.permute(2, 3, 1, 0), b.detach(),
                                         torch.float32))
    assert torch.equal(out.detach(), want)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_train_apply_grads_match_the_plain_generator(scale):
    """The differentiable apply (f32, CPU: plain versions under the
    Functions) gives the plain Generator's output and gradients; the x3
    stage takes the conv + pixel shuffle path."""
    gen = Generator(scale, num_blocks=2, num_channels=8, device="cpu",
                    seed=scale)
    x = T(np.random.default_rng(scale).uniform(
        -1, 1, (2, 7, 6, 3)).astype(np.float32))
    cot = torch.randn((2, 7 * scale, 6 * scale, 3),
                      generator=torch.Generator().manual_seed(scale))
    apply_fn = KernelTrainApply(gen, torch.float32)
    out = apply_fn(x)
    got = torch.autograd.grad((out * cot).sum(), list(gen.parameters()))
    ref_out = gen(x)
    want = torch.autograd.grad((ref_out * cot).sum(),
                               list(gen.parameters()))
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().numpy(), atol=1e-5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5,
                                   rtol=1e-4)
    assert apply_fn.forwards == 1
    # the inference apply gives the same forward on the same weights
    np.testing.assert_allclose(KernelApply(gen, torch.float32)(x).numpy(),
                               out.detach().numpy(), atol=1e-6)


def test_train_apply_grads_match_jax_pallas_apply():
    """The slice's forward as a whole: grads of an L1 loss through the
    port's differentiable apply against jax.grad through
    ``make_pallas_apply`` (interpret mode) on carried-across weights."""
    scale = 2
    gen_j = JaxGenerator(scale=scale, num_blocks=2, num_channels=8,
                         dtype=jnp.float32)
    rng = np.random.default_rng(5)
    lr = rng.uniform(-1, 1, (2, 10, 10, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (2, 20, 20, 3)).astype(np.float32)
    params = gen_j.init(jax.random.key(1), jnp.asarray(lr))["params"]
    pallas = make_pallas_apply(scale, 0.1, jnp.float32, tile=(8, 8),
                               interpret=True)

    def loss(p):
        return jax_losses.l1_loss(pallas({"params": p}, jnp.asarray(lr)),
                                  jnp.asarray(hr))

    l_j, g_j = jax.value_and_grad(loss)(params)
    gen = Generator(scale, 2, 8, device="cpu", seed=None)
    gen.load_state_dict(state_dict_from_jax(jax.device_get(params), scale))
    sd_grad = state_dict_from_jax(jax.device_get(g_j), scale)
    l_t = losses.l1_loss(KernelTrainApply(gen, torch.float32)(T(lr)), T(hr))
    l_t.backward()
    assert abs(float(l_t.detach()) - float(l_j)) <= 1e-6
    for name, p in gen.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), sd_grad[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def test_pixel_losses_match_jax_and_compute_in_f32():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
            for _ in range(2))
    for ours, theirs in ((losses.l1_loss, jax_losses.l1_loss),
                         (losses.l2_loss, jax_losses.l2_loss)):
        np.testing.assert_allclose(float(ours(T(a), T(b))),
                                   float(theirs(a, b)), rtol=1e-6)
        # bf16 inputs: the difference is taken in f32, as in JAX
        got = ours(T(a).bfloat16(), T(b).bfloat16())
        assert got.dtype == torch.float32
        np.testing.assert_allclose(
            float(got), float(theirs(jnp.asarray(a, jnp.bfloat16),
                                     jnp.asarray(b, jnp.bfloat16))),
            rtol=1e-6)


@pytest.mark.parametrize("shape,out_hw", [((2, 48, 48, 3), (12, 12)),
                                          ((1, 20, 30, 3), (40, 60)),
                                          ((1, 17, 23, 3), (8, 11)),
                                          ((3, 9, 14, 1), (18, 7))])
def test_imresize_matches_jax(shape, out_hw):
    x = np.random.default_rng(len(shape)).uniform(
        -1, 1, shape).astype(np.float32)
    got = imresize(T(x), out_hw)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_imresize(jnp.asarray(x),
                                                       out_hw)), atol=1e-5)


def test_dihedral_matches_jax_on_the_same_bits():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 6, 6, 3)).astype(np.float32)
    # all 8 symmetries, one per sample
    bits = np.array([[(i >> k) & 1 for i in range(8)] for k in range(3)],
                    bool)
    got = augment._dihedral(T(x), T(bits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_augment._dihedral(
        jnp.asarray(x), jnp.asarray(bits))))
    assert len({got[i].tobytes() for i in range(8)}) == 8


@pytest.mark.parametrize("with_lr", [False, True])
def test_prepare_train_batch_matches_jax_on_the_same_bits(with_lr):
    rng = np.random.default_rng(7)
    hr = rng.integers(0, 256, (4, 24, 24, 3), dtype=np.uint8)
    lr = rng.integers(0, 256, (4, 6, 6, 3), dtype=np.uint8)
    key = jax.random.key(3)
    bits = np.array(jax.random.bernoulli(key, 0.5, (3, 4)))
    j_lr, j_hr = jax_augment.prepare_train_batch(
        key, jnp.asarray(hr), 4, lr_u8=jnp.asarray(lr) if with_lr else None)
    t_lr, t_hr = augment.prepare_train_batch(
        T(bits), T(hr), 4, T(lr) if with_lr else None)
    np.testing.assert_array_equal(t_hr.numpy(), np.asarray(j_hr))
    if with_lr:
        np.testing.assert_array_equal(t_lr.numpy(), np.asarray(j_lr))
    else:
        np.testing.assert_allclose(t_lr.numpy(), np.asarray(j_lr),
                                   atol=1e-5)


def test_dihedral_bits_come_from_the_generator():
    a = augment.dihedral_bits(torch.Generator().manual_seed(5), 16)
    b = augment.dihedral_bits(torch.Generator().manual_seed(5), 16)
    assert a.shape == (3, 16) and a.dtype == torch.bool
    assert torch.equal(a, b)
    assert 0 < int(a.sum()) < 48
