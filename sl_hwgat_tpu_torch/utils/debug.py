"""Numerical debugging aids, the counterpart of ``sl_hwgat_tpu/utils/debug.py``.

- ``nan_checks()`` makes a backward pass that produces a NaN raise, naming
  the operation whose gradient made it (``torch.autograd.detect_anomaly``
  with ``check_nan``; the JAX package's ``jax_debug_nans``).
- ``assert_finite_state`` checks every tensor of a module's state_dict (or
  of a state_dict) on the host and names each non-finite key.

The JAX package's ``check_jit_purity`` (tracing a function twice and
comparing the jaxprs) has no counterpart: the port runs eagerly, so there is
no traced program that Python state could leak into.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import torch


@contextlib.contextmanager
def nan_checks():
    """Raise ``RuntimeError`` when a backward pass inside the block returns a
    NaN gradient (forward NaNs pass through, as under ``jax_debug_nans`` they
    raise only where a traced operation makes one)."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def assert_finite_state(module_or_state_dict: torch.nn.Module | Mapping,
                        name: str = "state") -> None:
    """Raise ``FloatingPointError`` naming every key of a module's state_dict
    (or of ``module_or_state_dict`` itself) that holds an inf or a NaN."""
    sd = (module_or_state_dict.state_dict()
          if isinstance(module_or_state_dict, torch.nn.Module) else module_or_state_dict)
    bad = [key for key, value in sd.items()
           if torch.is_tensor(value) and value.is_floating_point()
           and not bool(torch.isfinite(value).all())]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
