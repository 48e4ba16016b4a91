"""The control, the reference in the program's place one precision step
below the configuration's (TF32 for tica_f32, float8 for tica_bf16), comes
out not correct against the committed limits: on the card, at the cells'
own sizes, on three seeds."""
import pytest

from dpmld_bench import calibrate

CELLS = ["tica_f32.train_s512", "tica_bf16.sweep5_s80", "tica_bf16.eval_s80",
         "tica_f32.sweep5_s80"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    for reading in calibrate.readings(cell, [2**31 + 1, 2**31 + 2, 2**31 + 3], ["control"],
                                      2.0, card):
        assert reading["correct"] is False, reading
