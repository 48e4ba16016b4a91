"""The benchmark's own tests: ``python -m pytest dpmld_bench/tests -q`` from
the checkout's root. Tests marked ``card`` need a CUDA card and skip
without one; the fixture decides, never the import."""
import pytest

from dpmld_bench.reference import encoders


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _tiny(cfg, traffic):
    part = encoders.of(cfg)
    if hasattr(part, "tiny"):
        part.tiny(cfg)
    else:
        cfg["num_hidden_layers"] = 1
    small = dict(n_train=24, n_eval=10, valid_tokens=[6, 13], truncate=True, warmup_steps=4,
                 warmup_epochs=1, span_steps=2, span_epochs=2)
    traffic.update({k: v for k, v in small.items() if k in traffic})


@pytest.fixture
def tiny():
    """An edit of a cell's specs to small sizes for the CPU: the encoder cut
    by its reference part's ``tiny(cfg)``, or to one layer where it has none
    (BERT's), 24 / 10 rows of 6-13 tokens (S = 16), few warm-up steps; every
    width as published."""
    return _tiny
