"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, a whole run driven at a small size on
the CPU with the committed limits, once for each fault the cell can have
(one card, so no exchange between cards to leave out). The cells are
BENCHMARK.json's, each with the faults of its traffic's driver."""
import pytest
import torch

from dpmld_bench import calibrate, run

FAULTS = {"train": ("unchanged", "half_batch", "altered"), "eval": ("half_batch", "altered")}
CASES = [(w["name"], f) for w in run.load_json(run.ROOT, "BENCHMARK.json")["workloads"]
         for f in FAULTS[run.load_json(run.HERE, "traffic", w["traffic"] + ".json")["driver"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault):
    def edit(cfg, traffic):
        tiny(cfg, traffic)
        if len(traffic["epsilons"]) > 1:
            traffic["epsilons"] = [0.1, 3.0]

    with calibrate.fault(fault):
        result, lines = run.run_cell(cell, 2**31 + 101, 0.2, False, torch.device("cpu"),
                                     edit=edit)
    assert result["correct"] is False, lines
    assert list(result)[-1] == "checks"


def test_the_sound_f32_path_is_correct(tiny):
    result, lines = run.run_cell("tica_f32.sweep5_s80", 2**31 + 101, 0.2, False,
                                 torch.device("cpu"), edit=tiny)
    assert result["correct"] is True, lines
