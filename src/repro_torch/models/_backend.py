"""Pluggable matmul backend shared by every dense primitive of the port
(``repro.models._backend`` counterpart).

A backend is any callable ``backend(name, p, x, **meta) -> y | None``:
``name`` is the layer's params path (``"units/0/attn/wq"``, ``"head"``,
``"blocks/3/c1"``), ``p`` the dense or conv param dict and ``x`` the
input.  Conv call sites (`repro_torch.models.managed.conv2d` /
``conv2d_linear``) pass ``conv={"stride", "padding", "groups"}``, so a
planned backend can im2col the NHWC input; dense call sites pass nothing.
Returning ``None`` declines the call and the primitive runs its default
path; call sites that cannot name their layer pass ``name=None``, which
backends must decline.

Stacked layers: weights stacked on a leading repeat axis R (the JAX
package's scan stacks; `repro_torch.models.transformer.backbone` loops
over the repeats in Python) are addressed as ``name`` plus the repeat
index that the loop publishes with `scan_slot`; backends read it with
`current_scan_index`.

The active backend, repeat index and plan variant are process-wide state
set by context managers, as in the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

MatmulBackend = Callable[..., object]

_ACTIVE: Optional[MatmulBackend] = None
_SCAN_INDEX: Optional[int] = None
_PLAN_VARIANT: Optional[str] = None


def current() -> Optional[MatmulBackend]:
    """The backend dense primitives should consult (None = default path)."""
    return _ACTIVE


@contextlib.contextmanager
def use(backend: Optional[MatmulBackend]):
    """Install ``backend`` for the duration of the context."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = backend
    try:
        yield backend
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def scan_slot(index: int):
    """Publish the current repeat index of a stacked-layer loop."""
    global _SCAN_INDEX
    prev = _SCAN_INDEX
    _SCAN_INDEX = index
    try:
        yield index
    finally:
        _SCAN_INDEX = prev


def current_scan_index() -> Optional[int]:
    """The repeat index published by the innermost `scan_slot` (None when
    not inside a stacked-layer loop)."""
    return _SCAN_INDEX


@contextlib.contextmanager
def plan_variant(name: Optional[str]):
    """Publish the active plan-variant key for the duration of the context;
    ``plan_variant(None)`` keeps any surrounding selection."""
    global _PLAN_VARIANT
    if name is None:
        yield None
        return
    if not isinstance(name, str):
        raise TypeError(f"plan variant must be a str, got "
                        f"{type(name).__name__}")
    prev = _PLAN_VARIANT
    _PLAN_VARIANT = name
    try:
        yield name
    finally:
        _PLAN_VARIANT = prev


def current_plan_variant() -> Optional[str]:
    """The variant key published by the innermost `plan_variant` (None =
    let the backend use its default variant)."""
    return _PLAN_VARIANT


def join(prefix: Optional[str], leaf: str) -> Optional[str]:
    """``"a/b" + "c" -> "a/b/c"``; a None prefix stays None."""
    return None if prefix is None else f"{prefix}/{leaf}"
