"""The benchmark's count of a step's and an eval forward's operations
equals FlopCounterMode's over the plain reference, and the bounds are
bounds."""
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dpmld_bench.metrics import counts
from dpmld_bench.reference import draws, follow, model, weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def specs(name="tica_f32"):
    with open(os.path.join(ROOT, "dpmld_bench", "configs", name + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "dpmld_bench", "traffic", "train_s80.json")) as f:
        traffic = json.load(f)
    cfg["num_hidden_layers"] = 2
    traffic.update(n_train=24, n_eval=10, valid_tokens=[6, 13])
    return cfg, traffic


@pytest.mark.parametrize("rows", [1, 4])
def test_step_and_eval_counts_equal_flop_counter(rows):
    cfg, traffic = specs()
    train, _ = follow.inputs(cfg, traffic, 3, "cpu")
    S = train["input_ids"].shape[1]
    params = weights.make_weights(cfg, 3, "cpu")
    stepper = model.Stepper(params, cfg, model.Precision())
    gen = draws.epoch_generator(3, 0, "train")
    batch = {k: v[:rows] for k, v in train.items()}
    with FlopCounterMode(display=False) as fc:
        stepper.step(batch, torch.ones(rows), 0.1, draws.Draws(gen, gen, "cpu", True))
    assert fc.get_total_flops() == counts.step_flops(cfg, S, rows)
    with FlopCounterMode(display=False) as fc:
        model.eval_logits(params, batch, cfg, 0.1, draws.Draws(None, gen, "cpu", False),
                          model.Precision())
    assert fc.get_total_flops() == counts.eval_flops(cfg, S, rows)


def test_bounds_take_the_larger_of_operations_and_bytes():
    cfg, _ = specs("tica_bf16")
    cfg["num_hidden_layers"] = 12
    # S = 512, batch 8, bf16: the forward reads q, k, v and writes the
    # output (2 bytes each), 25.2 MB, longer at 3.35 TB/s than its 4 B S^2 H
    # operations at 989 TFLOP/s; so does the backward's 50.4 MB
    act = 8 * 512 * 768 * 2
    fwd_bytes = 4 * act + 2 * 8 * 12 * 512 * 4 + 8 * 512 * 4
    fwd = counts.attention_bound_s(cfg, 512, 8, True)
    assert fwd == pytest.approx(fwd_bytes / 3.35e12)
    assert fwd > 4 * 8 * 512 * 512 * 768 / 989e12
    bwd = counts.attention_bound_s(cfg, 512, 8, False)
    assert bwd == pytest.approx((8 * act + 2 * 8 * 12 * 512 * 4 + 8 * 512 * 4) / 3.35e12)
    assert bwd > 8 * 8 * 512 * 512 * 768 / 989e12
    # a one-row product of a 2304 x 2304 f32 weight is bound by its bytes
    head = counts.product_bound_s(cfg, (1, 1, 2304, 2304, counts.HEAD))
    assert head == pytest.approx((2304 + 2304 * 2304 + 2304) * 4 / 3.35e12)
    # no count exceeds what the card's peak allows over the step's products
    prods = counts.step_products(cfg, 80, 8)
    total = sum(counts.product_bound_s(cfg, p) for p in prods)
    assert total >= counts.step_flops(cfg, 80, 8) / 989e12
