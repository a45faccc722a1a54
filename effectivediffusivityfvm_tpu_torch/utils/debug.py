"""Debug-mode checks (torch port of
``effectivediffusivityfvm_tpu.utils.debug``).

What can go wrong in a solve is numerical: NaN or Inf escaping it.  This
module provides:

  * :func:`check_finite` -- assert that every array in a nested structure
    (tensors, numpy arrays, scalars inside NamedTuples such as
    ``SolveResult``, dicts, lists and tuples) is finite, on the host;
  * :func:`nan_guard` -- wrap a solver so non-finite outputs raise with a
    labelled message;
  * :func:`debug_context` -- autograd's anomaly mode within a scope.  The
    JAX package turns on ``jax_debug_nans``/``jax_debug_infs``, which trap
    the first non-finite value of any forward operation; PyTorch has no
    such forward trap, and its anomaly mode checks the backward pass for
    NaN (``check_nan``) and names the forward operation that made it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["check_finite", "nan_guard", "debug_context"]


def _leaves(tree):
    """The array leaves of ``tree`` in ``jax.tree.leaves`` order (dict
    keys sorted, ``None`` no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):     # NamedTuples too
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def check_finite(tree, label: str = "") -> None:
    for i, leaf in enumerate(_leaves(tree)):
        a = _host(leaf)
        if not np.isfinite(a).all():
            bad = np.count_nonzero(~np.isfinite(a))
            raise FloatingPointError(
                f"non-finite values in {label or 'tree'} leaf {i}: "
                f"{bad}/{a.size} elements")


def nan_guard(solve_fn, label: str = "solve"):
    def wrapped(*args, **kwargs):
        res = solve_fn(*args, **kwargs)
        check_finite(res, label)
        return res
    return wrapped


@contextlib.contextmanager
def debug_context(nans: bool = True, infs: bool = True):
    """Anomaly mode on (if ``nans`` or ``infs``), NaN checks in the
    backward pass if ``nans``; the previous mode comes back on exit."""
    with torch.autograd.set_detect_anomaly(nans or infs, check_nan=nans):
        yield
