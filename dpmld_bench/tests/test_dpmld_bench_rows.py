"""The rows are a function of the seed alone, and truncate to S = 80."""
import json
import os

import numpy as np
import pytest

from dpmld_bench import rows as R
from dpmld_bench.reference import encoders
from eeg_multimodal_torch.data import datasets as D

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT = encoders.part("bert")


def traffic(name="train_s80"):
    with open(os.path.join(HERE, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
def test_rows_are_a_function_of_the_seed(seed):
    a, b = R.make_rows(seed, traffic(), BERT.TOKENS), R.make_rows(seed, traffic(), BERT.TOKENS)
    other = R.make_rows(seed + 1, traffic(), BERT.TOKENS)
    for x, y, z in zip(a, b, other):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["input_ids"], z["input_ids"])
    train, test = a
    assert train["input_ids"].shape == (2402, 512) and test["input_ids"].shape == (601, 512)
    assert train["act"].shape == (2402, 512) and train["act"].dtype == np.float32


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_rows_truncate_to_s80_and_keep_the_law(seed):
    train, test = R.make_rows(seed, traffic(), BERT.TOKENS)
    for split in (train, test):
        n = split["attention_mask"].sum(1)
        assert n[0] == 65 and n.min() >= 20 and n.max() == 65
        ids = split["input_ids"]
        assert (ids[:, 0] == BERT.TOKENS["first"]).all()
        assert (ids[np.arange(len(n)), n - 1] == BERT.TOKENS["last"]).all()
        assert len(np.unique(ids[:, 1:][split["attention_mask"][:, 1:] == 1])) <= 602
    pair = [D.build_pairing("ti", s["labels"], eeg_txt={"input_ids": s["input_ids"],
                                                       "attention_mask": s["attention_mask"]},
                            act_img=s["act"]) for s in (train, test)]
    cut = D.truncate_pair(*pair)
    assert cut[0].eeg_input.shape[1] == 80 == R.seq_len(train, test, True)
    assert R.seq_len(train, test, False) == 512
