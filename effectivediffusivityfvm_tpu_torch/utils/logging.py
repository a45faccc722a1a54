"""Structured logging gated by the config's verbose flag.

The reference logs with raw printf gated on ``opts.verbose``
(e.g. option echo Deff2D.cuh:121-175, per-check Deff lines Deff2D.cuh:1267-1272,
homotopy banners Deff2D.cuh:1506-1509).  Here the same information flows
through a standard logger so callers can route it; ``vprint`` keeps the
plain-stdout behavior for CLI parity.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "vprint"]

_logger = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("effectivediffusivityfvm_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stdout)
            h.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(h)
        logger.setLevel(logging.INFO)
        _logger = logger
    return _logger


def vprint(verbose: bool, msg: str) -> None:
    if verbose:
        get_logger().info(msg)
