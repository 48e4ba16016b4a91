"""What a text-encoder part may now bring, shown through a toy part in a
folder of its own (``tests/toy/``): a configuration cut to one chip's share
passes ``run.check_config``, and a cut of a width or of a count the part
does not name, a cut below the part's floor or a missing ``published``
does not, nor does any cut of BERT's; a causal part's attention counts S (S + 1) / 2 query-key pairs
while BERT's counts all S x S; the ``tiny`` fixture takes the part's own
CPU cut."""
import copy
import os

import pytest

from dpmld_bench import run
from dpmld_bench.metrics import counts
from dpmld_bench.reference import encoders
from dpmld_bench.tests.conftest import _tiny

TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
PROGRAM = encoders.load(os.path.join(TOY, "program"), "toy.program", "toy_moe")
REFERENCE = encoders.load(os.path.join(TOY, "reference"), "toy.reference", "toy_moe")

# 8 of 64 experts and 5 of 27 layers held here; every width as published
CUT = {"model_type": "toy_moe", "hidden_size": 64, "expert_width": 32,
       "num_attention_heads": 4, "qk_width": 24, "v_width": 16, "num_hidden_layers": 5,
       "first_k_dense_replace": 1, "n_routed_experts": 8, "num_experts_per_tok": 6,
       "n_shared_experts": 2, "vocab_size": 1000,
       "program": {"compute_dtype": "bfloat16"},
       "published": {"num_hidden_layers": 27, "n_routed_experts": 64},
       "deployment": "8 chips share each expert layer, its 64 experts divided 8 ways; this "
                     "chip holds experts 0-7 of each, the other layers on further stages"}
CONF = {"name": "toy_cut", "source": "a toy", "file": "dpmld_bench/configs/toy_cut.json",
        "reduced": ["n_routed_experts", "num_hidden_layers"], "why": "a cut configuration"}


@pytest.fixture
def toy(monkeypatch):
    """The toy's parts in place of the lookup by ``model_type``."""
    real_parts, real_of = run.encoder_parts, encoders.of

    def parts(model_type):
        return (PROGRAM, REFERENCE) if model_type == "toy_moe" else real_parts(model_type)

    def of(cfg):
        return REFERENCE if cfg["model_type"] == "toy_moe" else real_of(cfg)

    monkeypatch.setattr(run, "encoder_parts", parts)
    monkeypatch.setattr(encoders, "of", of)


def _at_the_floors(cfg, conf):
    cfg["published"]["vocab_size"] = 1000
    cfg["vocab_size"] = 125
    conf["reduced"].append("vocab_size")


@pytest.mark.parametrize("edit", [None, _at_the_floors])
def test_a_cut_configuration_passes(toy, edit):
    cfg, conf = copy.deepcopy(CUT), copy.deepcopy(CONF)
    if edit:
        edit(cfg, conf)
    run.check_config(conf, cfg)
    run.check_config({**conf, "reduced": conf["reduced"][::-1]}, cfg)


def _without_published(cfg, conf):
    del cfg["published"]


def _width_cut(cfg, conf):
    cfg["hidden_size"] = 32
    cfg["published"]["hidden_size"] = 64
    conf["reduced"].append("hidden_size")


def _count_not_named(cfg, conf):
    cfg["n_shared_experts"] = 1
    cfg["published"]["n_shared_experts"] = 2
    conf["reduced"].append("n_shared_experts")


def _missing_from_the_file(cfg, conf):
    del cfg["n_routed_experts"]


def _layers_below_the_floor(cfg, conf):
    cfg["num_hidden_layers"] = 4


def _experts_below_the_floor(cfg, conf):
    cfg["n_routed_experts"] = 4


def _vocab_below_the_floor(cfg, conf):
    _at_the_floors(cfg, conf)
    cfg["vocab_size"] = 124


def _not_below(cfg, conf):
    cfg["n_routed_experts"] = 64


def _not_whole(cfg, conf):
    cfg["n_routed_experts"] = 8.0


def _not_listed(cfg, conf):
    conf["reduced"].remove("num_hidden_layers")


def _without_deployment(cfg, conf):
    del cfg["deployment"]


def _deployment_uncut(cfg, conf):
    del cfg["published"]
    conf["reduced"].clear()


def _program_width(cfg, conf):
    cfg["hidden_size"] = 32


@pytest.mark.parametrize("edit,names", [
    (_without_published, "published"),
    (_width_cut, "'hidden_size' is not a count that the 'toy_moe' part lets a cut change"),
    (_count_not_named, "'n_shared_experts' is not a count that the 'toy_moe' part"),
    (_missing_from_the_file, "'n_routed_experts' is not in the configuration file"),
    (_layers_below_the_floor, "'num_hidden_layers': 4 is not a whole number from the floor 5"),
    (_experts_below_the_floor, "'n_routed_experts': 4 is not a whole number from the floor 8"),
    (_vocab_below_the_floor, "'vocab_size': 124 is not a whole number from the floor 125"),
    (_not_below, "'n_routed_experts': 64 is not a whole number from the floor 8 to below the "
                 "published 64"),
    (_not_whole, "'n_routed_experts': 8.0"),
    (_not_listed, "published"),
    (_without_deployment, "deployment"),
    (_deployment_uncut, "deployment"),
    (_program_width, "the program runs 64"),
])
def test_a_faulty_cut_is_refused_by_name(toy, edit, names):
    cfg, conf = copy.deepcopy(CUT), copy.deepcopy(CONF)
    edit(cfg, conf)
    with pytest.raises(ValueError, match=names):
        run.check_config(conf, cfg)


@pytest.mark.parametrize("key,value", [("num_hidden_layers", 6), ("vocab_size", 15261),
                                       ("hidden_size", 384)])
def test_berts_part_lets_no_cut(key, value):
    conf = next(c for c in run.load_json(run.ROOT, "BENCHMARK.json")["configs"]
                if c["name"] == "tica_f32")
    cfg = run.load_json(run.ROOT, conf["file"])
    run.check_config(conf, copy.deepcopy(cfg))
    cfg["published"], cfg[key] = {key: cfg[key]}, value
    cfg["deployment"] = "2 chips share each layer; this chip holds half"
    with pytest.raises(ValueError, match=f"{key!r} is not a count that the 'bert' part"):
        run.check_config({**conf, "reduced": [key]}, cfg)


@pytest.mark.parametrize("S,rows", [(4096, 2), (80, 8)])
@pytest.mark.parametrize("forward", [True, False])
def test_a_causal_part_counts_half_the_pairs(toy, S, rows, forward):
    cfg = copy.deepcopy(CUT)
    nh, qk, v = 4, 24, 16
    ops = 2 * rows * nh * (S * (S + 1) // 2) * (qk + v) * (1 if forward else 2)
    qk_b, v_b = rows * S * nh * qk * 2, rows * S * nh * v * 2
    nbytes = ((2 * qk_b + 2 * v_b) if forward else (4 * qk_b + 4 * v_b)) \
        + 2 * rows * nh * S * 4 + rows * S * 4
    expect = max(ops / counts.PEAKS["flops"]["bfloat16"], nbytes / counts.PEAKS["bytes_per_s"])
    assert counts.attention_bound_s(cfg, S, rows, forward) == expect
    if S == 4096:  # bound by its operations, so the causal count decides it
        assert expect == ops / counts.PEAKS["flops"]["bfloat16"]


def test_berts_attention_still_counts_every_pair():
    cfg = run.load_json(run.ROOT, "dpmld_bench", "configs", "tica_bf16.json")
    assert "causal" not in encoders.of(cfg).attention(cfg)
    S, rows = 4096, 8  # bound by its operations at this length
    ops = 2 * rows * 12 * S * S * (64 + 64)
    assert counts.attention_bound_s(cfg, S, rows, True) == ops / counts.PEAKS["flops"]["bfloat16"]


def test_tiny_takes_the_parts_own_cut(toy):
    cfg = copy.deepcopy(CUT)
    traffic = {"n_train": 2402, "n_eval": 601, "valid_tokens": [20, 65]}
    _tiny(cfg, traffic)
    assert cfg["num_hidden_layers"] == 2
    assert traffic == {"n_train": 24, "n_eval": 10, "valid_tokens": [6, 13]}
    bert = run.load_json(run.ROOT, "dpmld_bench", "configs", "tica_f32.json")
    _tiny(bert, {})
    assert bert["num_hidden_layers"] == 1
