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
