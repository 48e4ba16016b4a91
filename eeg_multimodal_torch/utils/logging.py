"""Dual-level logging of the legacy trainer (ref: train.py:53-63): debug.log
(DEBUG), info.log (INFO) and stdout. The port's own copy of the JAX
package's ``utils/logging.py``."""
from __future__ import annotations

import logging
import os
import sys


def setup_run_logging(base_path: str, name: str = "eeg_multimodal_torch"):
    os.makedirs(base_path, exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    debug_h = logging.FileHandler(os.path.join(base_path, "debug.log"), "w")
    debug_h.setLevel(logging.DEBUG)
    info_h = logging.FileHandler(os.path.join(base_path, "info.log"), "w")
    info_h.setLevel(logging.INFO)
    out_h = logging.StreamHandler(sys.stdout)
    out_h.setLevel(logging.DEBUG)
    for h in (debug_h, info_h, out_h):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
