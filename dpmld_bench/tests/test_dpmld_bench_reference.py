"""The plain reference agrees with the program's CPU path at a small size:
one alternating step (three, in fact: the check's first steps) and the eval
epochs, every draw made again from the seed on both sides."""
import pytest
import torch

from dpmld_bench import run

LIMITS = {"loss_gap": 1e-5, "grad1_gap": 1e-5, "change3_gap": 1e-3,
          "score_gap": 1e-5, "vote_flip_margin": 0.0, "f1_gap": 0.0}


def as_f32(tiny):
    def edit(cfg, traffic):
        tiny(cfg, traffic)
        cfg["program"].update(compute_dtype="float32", adam_mu_dtype="float32",
                              adam_nu_dtype="float32", precast_params=False)
    return edit


@pytest.mark.parametrize("fused", [True, False])
def test_reference_follows_the_program_step(tiny, fused):
    edit = as_f32(tiny)

    def fused_or_not(cfg, traffic):
        edit(cfg, traffic)
        cfg["program"]["fused_dp_kernel"] = fused

    result, _ = run.run_cell("tica_f32.sweep5_s80", 2**31 + 5, 0.2, False, torch.device("cpu"),
                             edit=fused_or_not)
    for name, check in result["checks"].items():
        # Adam's first steps move an element by lr * g / (|g| + eps): a
        # gradient near eps moves with its last bits, hence change3's limit
        assert check["value"] <= LIMITS[name], (name, check)


def test_reference_follows_the_program_eval(tiny):
    result, _ = run.run_cell("tica_bf16.eval_s80", 2**31 + 9, 0.2, False, torch.device("cpu"),
                             edit=as_f32(tiny))
    assert result["attempted"] >= 1
    for name, check in result["checks"].items():
        assert check["value"] <= LIMITS[name], (name, check)


def test_reference_follows_each_sweep_member(tiny):
    def edit(cfg, traffic):
        as_f32(tiny)(cfg, traffic)
        traffic["epsilons"] = [0.1, 3.0]

    result, _ = run.run_cell("tica_bf16.sweep5_s80", 17, 0.2, False, torch.device("cpu"),
                             edit=edit)
    for name, check in result["checks"].items():
        assert check["value"] <= LIMITS[name], (name, check)
