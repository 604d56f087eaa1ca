"""The port's GAN step against the JAX package's with the gradient
penalty and spectral norm, and with two accumulated microbatches (the
cases and tolerances of tests/test_torch_gan_step.py, split off so that
each file stays short on one worker)."""

import pytest

from test_torch_gan_step import run_case


@pytest.mark.parametrize("case", ["GP+SN", "accum2"])
def test_two_gan_steps_match_jax(case):
    run_case(case)
