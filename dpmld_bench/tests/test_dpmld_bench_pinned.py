"""What the harness reads stays what it read before the text encoder became
a part looked up by ``model_type``: the rows, every weight, the plain
reference's records and the counts, held exactly to values pinned on the
tree before the split (``pinned.json``). On the CPU at the ``tiny`` sizes,
on one host thread, as a run has it (on more, the CPU's products sum in
another order from run to run); the counts at the published sizes."""
import hashlib
import json
import os

import pytest
import torch

from dpmld_bench import rows as R
from dpmld_bench.metrics import counts
from dpmld_bench.reference import encoders, follow, weights

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**31 + 5
CONFIGS = ["tica_bf16", "tica_f32"]
TRAFFIC = ["train_s80", "sweep5_s80", "eval_s80", "train_s512"]
SHAPES = [(80, 8), (80, 40), (512, 8), (16, 3), (80, 601)]

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "pinned.json")) as _f:
    PINS = json.load(_f)


def load(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def specs(config, traffic):
    """The configuration and traffic at the ``tiny`` sizes (one encoder
    layer, 24 / 10 rows of 6-13 tokens), two sweep members."""
    cfg, tr = load("configs", config + ".json"), load("traffic", traffic + ".json")
    cfg["num_hidden_layers"] = 1
    tr.update(n_train=24, n_eval=10, valid_tokens=[6, 13])
    if len(tr["epsilons"]) > 1:
        tr["epsilons"] = [0.1, 3.0]
    return cfg, tr


def digest(a):
    return f"{hashlib.sha256(a.tobytes()).hexdigest()}/{a.shape}/{a.dtype}"


def rows_values(config):
    out = {}
    for name in TRAFFIC:
        cfg, tr = specs(config, name)
        train, test = R.make_rows(SEED, tr, encoders.of(cfg).TOKENS)
        out[name] = {k: [digest(train[k]), digest(test[k])] for k in train}
    return out


def weight_values(config):
    cfg, _ = specs(config, "train_s80")
    tree = weights.make_weights(cfg, SEED, "cpu")
    return {p: [float(t.double().norm()), float(t.double().sum())]
            for p, t in weights.leaves(tree)}


def train_values(config, traffic):
    cfg, tr = specs(config, traffic)
    return follow.train_records(cfg, tr, SEED, "cpu", "float32", 3)


def eval_values(config):
    cfg, tr = specs(config, "eval_s80")
    rec = follow.eval_records(cfg, tr, SEED, "cpu", [0, 2])
    return {"logits": [x.double().reshape(-1).tolist() for x in rec["logits"]],
            "weight": rec["weight"].tolist(), "labels": rec["labels"].tolist()}


def products_digest(products):
    return hashlib.sha256(json.dumps([list(p) for p in products]).encode()).hexdigest()


def count_values(config):
    cfg = load("configs", config + ".json")
    out = {}
    for S, rows in SHAPES:
        prods = counts.step_products(cfg, S, rows)
        out[f"{S}.{rows}"] = {
            "step_flops": counts.step_flops(cfg, S, rows),
            "eval_flops": counts.eval_flops(cfg, S, rows),
            "step_products": products_digest(prods),
            "attn_fwd": counts.attention_bound_s(cfg, S, rows, True),
            "attn_bwd": counts.attention_bound_s(cfg, S, rows, False),
            "attn_calls": [list(counts.attention_calls(cfg, t)) for t in (True, False)],
            "gemm_bound": sum(counts.product_bound_s(cfg, p) for p in prods
                              if p[4] != counts.ATTN)}
    return out


VALUES = {"rows": rows_values, "weights": weight_values,
          "train_s80": lambda c: train_values(c, "train_s80"),
          "sweep5_s80": lambda c: train_values(c, "sweep5_s80"),
          "eval": eval_values, "counts": count_values}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("what", list(VALUES))
@pytest.mark.parametrize("config", CONFIGS)
def test_the_harness_reads_what_it_read_before(one_thread, config, what):
    got = json.loads(json.dumps(VALUES[what](config)))
    assert got == PINS[config][what]
