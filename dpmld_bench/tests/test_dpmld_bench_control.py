"""The control, the reference in the program's place one precision step
below the configuration's (TF32 for tica_f32, float8 for tica_bf16), comes
out not correct against the committed limits: on the card, at the cells'
own sizes, on three seeds; every cell of BENCHMARK.json."""
import pytest

from dpmld_bench import calibrate, run

CELLS = [w["name"] for w in run.load_json(run.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    for reading in calibrate.readings(cell, [2**31 + 1, 2**31 + 2, 2**31 + 3], ["control"],
                                      2.0, card):
        assert reading["correct"] is False, reading
