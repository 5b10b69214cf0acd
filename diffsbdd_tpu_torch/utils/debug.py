"""Invariant checks and NaN detection for eager runs and tests.

The reference asserts inside its sampling loops (a zero centre of mass,
finite network outputs).  Here the same invariants are helpers: ``check_*``
raise ``AssertionError`` where an invariant fails, and ``checked`` wraps a
function so that it also returns an error naming any non-finite
floating-point output, the eager counterpart of ``checkify``'s float
checks.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import torch

from diffsbdd_tpu_torch.ops.masked import masked_sum


def mean_zero_relative_error(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The largest |masked sum| over the batch, relative to the largest
    masked coordinate magnitude."""
    largest = (x * mask[..., None]).abs().max()
    return masked_sum(x, mask).abs().max() / (largest + 1e-10)


def check_mean_zero(x, mask, tol: float = 1e-2, what: str = "coordinates") -> None:
    """Assert that ``x`` (B, N, 3) has a zero masked centre of mass."""
    err = float(mean_zero_relative_error(torch.as_tensor(x), torch.as_tensor(mask)))
    assert err < tol, f"{what}: mean is not zero, relative error {err:.2e}"


def _named_tensors(tree, path: Tuple[str, ...] = ()) -> Iterable[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf: a module's state_dict entries, the
    entries of dicts, lists and tuples under '/'-joined paths."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.state_dict().items()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_tensors(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_tensors(v, path + (str(i),))
    else:
        yield "/".join(path), torch.as_tensor(tree)


def check_finite(tree, what: str = "tensors") -> None:
    """Assert that every tensor of ``tree`` (a module's parameters and
    buffers, a dict, list or tuple of tensors) is finite; the message names
    the ones that are not."""
    bad = [name for name, t in _named_tensors(tree)
           if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    assert not bad, f"{what}: non-finite values at {bad}"


class NonFiniteError(FloatingPointError):
    """Raised by ``CheckError.throw`` for a non-finite output."""


class CheckError:
    """What a ``checked`` call found: ``get()`` the message or None,
    ``throw()`` raises ``NonFiniteError`` when there is one."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise NonFiniteError(self.message)


def checked(fn: Callable) -> Callable:
    """``fn`` returning (``CheckError``, its output): the error names every
    floating-point output that is not finite (NaN or infinity), as the JAX
    package's ``checkify`` float checks report them::

        err, out = checked(module.loss_fn)(...)
        err.throw()
    """
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [name or "output" for name, t in _named_tensors(out)
               if t.is_floating_point() and not bool(torch.isfinite(t).all())]
        name = getattr(fn, "__name__", "fn")
        return CheckError(f"{name}: non-finite values at {bad}" if bad else None), out
    return wrapped


def checkify_mean_zero(x, mask, tol: float = 1e-2) -> None:
    """The in-graph centre-of-mass check of the JAX package, eager here:
    raises ``AssertionError`` where the relative error reaches ``tol``."""
    check_mean_zero(x, mask, tol)
