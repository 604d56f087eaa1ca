"""The control comes out not correct: on an int8 cell the reference in
W4A4 put in the program's place, on a bf16 cell the program's own int8
path.  On the card at the cells' widths and shapes (few requests); on
the CPU the int8 cell's control at the rehearsal size."""

import pytest

from port_bench import control
from port_bench.tests.helpers import need_card


@pytest.mark.card
@pytest.mark.parametrize("cell, requests", [("pesr_x4.batch_int8", 1),
                                            ("edsr_x2.batch_bf16", 1),
                                            ("pesr_x4.single_photo", 20)])
def test_control_fails_on_the_card(cell, requests):
    need_card()
    r = control.readings(cell, 2 ** 31 + 7, True, requests)
    assert not r["holds"], r


@pytest.mark.card
@pytest.mark.parametrize("cell, requests", [("pesr_x4.batch_int8", 1),
                                            ("pesr_x4.single_photo", 20)])
def test_program_holds_on_the_card(cell, requests):
    need_card()
    r = control.readings(cell, 2 ** 31 + 8, False, requests)
    assert r["holds"], r


def test_int8_control_fails_at_the_rehearsal_size():
    r = control.readings("pesr_x4.batch_int8", 5, True, 1, rehearse=True)
    assert not r["holds"], r


# control.readings(cell, seed, False, 1, rehearse=True) before the
# configurations named a family: the harness's wiring moved, the
# weights, the program, the sample and the references did not.
BEFORE_FAMILIES = {
    ("pesr_x4.batch_int8", 11): dict(
        images=3, clamped_pct=2.400111279079533, rms_lsb=0.31215595029494,
        off_pct=0.0, max_lsb=1.24627685546875),
    ("pesr_x4.batch_int8", 12): dict(
        images=3, clamped_pct=3.4270807088267405,
        rms_lsb=0.3081693248951121, off_pct=0.0,
        max_lsb=1.4724664688110352),
    ("edsr_x2.batch_bf16", 11): dict(
        images=2, clamped_pct=2.7578583927009124,
        rms_lsb=0.34879478011334136, off_pct=0.004686914135733034,
        max_lsb=1.8000259399414062),
    ("edsr_x2.batch_bf16", 12): dict(
        images=2, clamped_pct=1.92749343832021, rms_lsb=0.34277740749007407,
        off_pct=0.00703037120359955, max_lsb=2.052886962890625),
    ("pesr_x4.single_photo", 11): dict(
        images=1, clamped_pct=5.138888888888889,
        rms_lsb=0.43566535342258095, off_pct=0.05555555555555555,
        max_lsb=1.5572471618652344),
    ("pesr_x4.single_photo", 12): dict(
        images=1, clamped_pct=4.798719618055555,
        rms_lsb=0.38479070389111947, off_pct=0.0244140625,
        max_lsb=1.9795703887939453),
}


@pytest.mark.parametrize("cell, seed", sorted(BEFORE_FAMILIES))
def test_edsr_readings_are_unmoved(cell, seed):
    r = control.readings(cell, seed, False, 1, rehearse=True)
    assert r["holds"]
    assert {k: r[k] for k in BEFORE_FAMILIES[cell, seed]} == \
        BEFORE_FAMILIES[cell, seed]
