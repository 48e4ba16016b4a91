"""The program's side of each text encoder, one part to each ``model_type``
(``encoders/<model_type>.py``; the reference's side is
``reference/encoders/<model_type>.py``).

A program part holds:

- ``check_widths(cfg)``: raise unless the widths the program runs for this
  architecture are the configuration's;
- ``fusion_settings(cfg, vocab_size)``: the ``FusionConfig`` fields that set
  up the port's encoder from the configuration, at ``vocab_size`` word ids
  (the compact vocab's where the program keeps one);
- ``cut_to_vocab(params, vocab, device)``: the run's weights with the
  encoder's word table cut to the compact vocab's rows;
- optionally ``counters()``: the program's counters of this encoder (a dict
  of name to number, such as the rows routed to the experts held here),
  read just before and just after a traced run's profiled span; the readers
  find the change over the span as ``ctx["counters"]``, which is {} for a
  part that defines none.
"""
from __future__ import annotations

import os

from ..reference.encoders import load

HERE = os.path.dirname(os.path.abspath(__file__))


def part(model_type: str):
    """The program's part of ``model_type``."""
    return load(HERE, __name__, model_type)


def of(cfg: dict):
    """The program's part of the configuration's text encoder."""
    return part(cfg["model_type"])
