"""Every name in BENCHMARK.json resolves to its files, and the file keeps to
the contract's shapes."""
import json
import os
import re

import pytest

from dpmld_bench import drivers, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dpmld_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_resolves_to_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200
    bench, found, cfg, traffic, limits = run.cell_spec(cell["name"])
    assert found == cell
    assert os.path.exists(os.path.join(ROOT, "dpmld_bench", "drivers", traffic["driver"] + ".py"))
    assert limits and all(isinstance(v, (int, float)) for v in limits.values())
    reported = run.metrics_of(bench, cell, False) + run.metrics_of(bench, cell, True)
    assert {m["name"] for m in run.metrics_of(bench, cell, False)} >= {"setup_s"}
    assert len(run.metrics_of(bench, cell, False)) >= 2 and run.metrics_of(bench, cell, True)
    for m in reported:
        assert hasattr(run.reader(m["name"]), "read")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_traffic_key_is_read(cell):
    traffic = run.cell_spec(cell["name"])[3]
    assert drivers.driver(traffic).KEYS <= set(traffic)
    with pytest.raises(ValueError, match="does not read"):
        drivers.driver({**traffic, "eval_every_epoch": True})


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    run.check_config(conf, cfg)
    if cfg["model_type"] == "bert":  # BERT-base's published sizes
        assert (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"],
                cfg["intermediate_size"], cfg["vocab_size"]) == (768, 12, 12, 3072, 30522)
    assert any(c["config"] == conf["name"] for c in BENCH["workloads"])


def test_metrics_keep_to_the_contract():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert "workloads" not in moved or w in moved["workloads"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
