"""Runtime sanitizer: non-finite guards the engine records on the device.

`SolveContext(sanitize=True)` runs CR1/CR2 solves and days with checks
on the gradient, the iterate and the multipliers
(`engine.al_minimize(sanitizer=...)`). The JAX package functionalizes
such checks with checkify; the port keeps the contract with a device
flag:

  * A `Sanitizer` holds one int32 device tensor `code`, 0 while clean.
    `check_all_finite(san, tag, **named)` records, for each array,
    ``code = where((code == 0) & ~isfinite(a).all(), site, code)``: the
    first failing site wins, as checkify reports the first failed check.
    The site constant is filled on the device (`torch.full`), never
    copied from a Python number, so a CUDA-graph capture holds the
    checks; nothing reads the device while the solve runs.
  * The sites are numbered in a host table shared by every sanitizer
    (`SITES`: (tag, array name), code i naming entry i - 1), so a code
    read from a replayed graph decodes without the Python that captured
    it.
  * `throw()` reads `code` once, at the call boundary, and raises
    `SanitizeError` naming the site, in the JAX package's words. The
    solve itself ran on after the NaN (it cannot stop without a sync);
    the caller returns no plan.

`checked(fn)` is the counterpart of the JAX package's `checked_jit`: it
calls `fn(..., sanitizer=san)` with a fresh sanitizer and returns
`(san, out)`; the caller must `san.throw()`.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

__all__ = ["SITES", "SanitizeError", "Sanitizer", "check_all_finite",
           "checked"]

#: (tag, array name) of every site a check has named; code i is SITES[i-1].
SITES: list[tuple[str, str]] = []
_SITE_IDS: dict[tuple[str, str], int] = {}


class SanitizeError(RuntimeError):
    """What a fired sanitizer check raises from `Sanitizer.throw()`."""


def _site(tag: str, name: str) -> int:
    key = (tag, name)
    if key not in _SITE_IDS:
        SITES.append(key)
        _SITE_IDS[key] = len(SITES)
    return _SITE_IDS[key]


class Sanitizer:
    """The device flag of one sanitized call: `code` (int32, 0 = clean)
    is made on the device of the first array checked, or on `device`."""

    def __init__(self, device: str | torch.device | None = None):
        self.code = (None if device is None else
                     torch.zeros((), dtype=torch.int32, device=device))

    def throw(self) -> None:
        """Read the flag (the one host read) and raise `SanitizeError`
        naming the first failed site; return when clean."""
        throw_code(self.code)


def throw_code(code: torch.Tensor | None) -> None:
    """`Sanitizer.throw` for a bare flag tensor, e.g. a day graph's output
    buffer."""
    if code is None:
        return
    c = int(code.item())
    if c:
        tag, name = SITES[c - 1]
        raise SanitizeError(f"{tag}: non-finite values in {name} — the "
                            f"solve diverged or its inputs carry NaN/inf")


def check_all_finite(san: Sanitizer, tag: str, **named) -> None:
    """Record one non-finite check per named tensor on `san`'s flag.

    `tag` names the engine site (e.g. ``"al-inner"``); the keyword name
    goes into the message, so a failure reads ``al-inner: non-finite
    values in grad``."""
    for name, value in named.items():
        if san.code is None:
            san.code = torch.zeros((), dtype=torch.int32,
                                   device=value.device)
        site = torch.full((), _site(tag, name), dtype=torch.int32,
                          device=san.code.device)
        bad = ~torch.isfinite(value).all()
        san.code = torch.where((san.code == 0) & bad, site, san.code)


def checked(fn: Callable) -> Callable:
    """The sanitizer twin of `fn`: `checked(fn)(*a, **kw)` calls
    `fn(*a, sanitizer=san, **kw)` with a fresh `Sanitizer` and returns
    `(san, out)`; the caller must `san.throw()` before using `out`."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        san = Sanitizer()
        return san, fn(*args, sanitizer=san, **kwargs)
    return run
