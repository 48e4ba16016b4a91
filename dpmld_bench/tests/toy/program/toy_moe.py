"""A toy program part for the tests: the widths it runs, and a counter of
the rows routed to the experts held here, which a test advances."""
from __future__ import annotations

ROUTED = {"routed_rows": 0}


def check_widths(cfg: dict):
    if cfg["hidden_size"] != 64:
        raise ValueError(f"configuration hidden_size={cfg['hidden_size']}, the program runs 64")


def counters() -> dict:
    return dict(ROUTED)
