"""The drivers a traffic mix names: ``train`` and ``eval``.

A traffic file holds the rows' parameters (``ROWS``), its ``driver`` and a
``why``, and the driver's own parameters (its module's ``KEYS``); any other
key would be read by nothing, and is refused."""
from __future__ import annotations

import importlib

ROWS = {"n_train", "n_eval", "word_pool", "valid_tokens", "truncate", "epsilons"}


def driver(traffic: dict):
    """The module ``dpmld_bench/drivers/<driver>.py`` of ``traffic``, once
    every key of the traffic is one that is read."""
    mod = importlib.import_module(f"dpmld_bench.drivers.{traffic['driver']}")
    unread = set(traffic) - ROWS - mod.KEYS - {"driver", "why"}
    if unread:
        raise ValueError(f"traffic keys that the {traffic['driver']} driver does not read: "
                         f"{sorted(unread)}")
    return mod
