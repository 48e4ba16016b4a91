"""The text encoder's parts, one to each ``model_type``.

A configuration names its text encoder by its ``model_type``. The reference's
part of that architecture is ``reference/encoders/<model_type>.py`` (plain
PyTorch; it imports torch and ``reference/`` only), the program's is
``encoders/<model_type>.py``; ``run.cell_spec`` looks both up, and a new
architecture is new files beside ``bert.py``. Everything else the reference
runs (the act encoder, the cross-attention decoder, the DP block, the head,
the step, the draws, the check) is shared.

A reference part holds:

- ``KEY``: the encoder's subtree in the weight tree;
- ``TOKENS``: the rows' token law: ``first`` and ``last``, the ids that open
  and close a row, and ``words``, the [lo, hi) id range the word pool is
  drawn from;
- ``width(cfg)``: the width of the encoder's outputs, at which the fusion
  runs;
- ``plan(cfg)``: (normal (shape, std) pairs, uniform (shape, bound) pairs),
  in draw order;
- ``build(cfg, take)``: the subtree from ``take`` (``weights.Take``), which
  hands out the plan's tensors in its order;
- ``forward(params, ids, mask, cfg, draws, prec)``: (the sequence output
  (B, S, width), the pooled output (B, width));
- ``products(cfg, S, rows)``: the products of one forward over ``rows``
  rows, each (count, m, k, n, part), ``part`` :data:`ENCODER` or
  :data:`ATTN`, as the reference computes them. Routed experts count at
  the expected load: the experts held here take tokens x experts a token
  takes x held / routed of the ``rows * S`` tokens' rows, so that the
  counts stay a function of the model's structure (the real load is the
  program part's counter to read);
- ``attention(cfg)``: a forward's attention calls: ``calls``, and each
  call's ``heads`` and their ``qk`` and ``v`` widths; ``causal``: True
  where each query attends only to the keys up to its own position, so
  that ``counts.attention_bound_s`` counts the S (S + 1) / 2 query-key
  pairs a causal kernel computes in place of S x S.

It may also hold:

- ``cuts(published)``: the counts that a configuration of this architecture
  may cut to one chip's share (experts held, layers, rows of the
  vocabulary; never a width), each with the least it may keep, from the
  published configuration: of the layers, the leading dense ones and after
  them a whole period of the layer pattern and no fewer than four; 8
  routed experts; an eighth of the vocabulary. ``run.check_config`` refuses every other
  cut; a part without ``cuts``, as ``bert``, lets none;
- ``tiny(cfg)``: the configuration cut in place to what the CPU tests run
  (``tests/conftest.py``'s ``tiny``), where one layer of the encoder,
  the default, is not enough to hold each kind of its layers.
"""
from __future__ import annotations

import importlib.util
import os
import re

# the parts of the counted products that the encoder owns: its dense
# products, and its attention calls' two products
ENCODER, ATTN = "encoder", "attn"

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_TYPE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_-]{0,63}")
_LOADED = {}


def load(folder: str, package: str, model_type: str):
    """The module ``<folder>/<model_type>.py``, loaded once a process as a
    member of ``package``; LookupError where there is none."""
    path = os.path.join(folder, f"{model_type}.py")
    if path not in _LOADED:
        if not MODEL_TYPE.fullmatch(model_type) or not os.path.isfile(path):
            raise LookupError(path)
        spec = importlib.util.spec_from_file_location(
            f"{package}.{model_type.replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def part(model_type: str):
    """The reference's part of ``model_type``."""
    return load(HERE, __name__, model_type)


def of(cfg: dict):
    """The reference's part of the configuration's text encoder."""
    return part(cfg["model_type"])
