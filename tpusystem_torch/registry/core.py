"""Constructor-argument capture for entity identity.

Registering a class wraps its ``__init__`` so every instance records the
arguments it was constructed with. Unlike the reference implementation
(``torchsystem/registry/core.py:42-59``), captured metadata lives in a
*side table* keyed by object identity instead of instance attributes — this
makes capture work for frozen dataclasses (flax ``linen.Module``), slotted
classes, and other immutable pytree nodes that reject ``setattr``.

Entries are garbage-collected with the instance via ``weakref.finalize``
where the type supports weak references; otherwise they persist for the
process lifetime (equivalent to the reference's instance-attribute storage).
"""

from __future__ import annotations

import weakref
from copy import deepcopy
from inspect import signature
from typing import Any

# id(obj) -> captured metadata. Three parallel tables so hash/name overrides
# can exist without captured arguments and vice versa.
_ARGUMENTS: dict[int, dict[str, Any]] = {}
_NAMES: dict[int, str] = {}
_HASHES: dict[int, str] = {}


def _attach_finalizer(obj: object) -> None:
    key = id(obj)

    def _cleanup(key=key):
        _ARGUMENTS.pop(key, None)
        _NAMES.pop(key, None)
        _HASHES.pop(key, None)

    try:
        weakref.finalize(obj, _cleanup)
    except TypeError:
        pass  # not weakref-able: entry lives as long as the process


def put_arguments(obj: object, arguments: dict[str, Any]) -> None:
    _attach_finalizer(obj)
    _ARGUMENTS[id(obj)] = arguments


def get_arguments(obj: object) -> dict[str, Any] | None:
    return _ARGUMENTS.get(id(obj))


def put_name(obj: object, name: str) -> None:
    _attach_finalizer(obj)
    _NAMES[id(obj)] = name


def get_name(obj: object) -> str | None:
    return _NAMES.get(id(obj))


def put_hash(obj: object, value: str) -> None:
    _attach_finalizer(obj)
    _HASHES[id(obj)] = value


def get_hash(obj: object) -> str | None:
    return _HASHES.get(id(obj))


def has_capture(obj: object) -> bool:
    return id(obj) in _ARGUMENTS or id(obj) in _HASHES


def cls_signature(cls: type,
                  excluded_args: list[int] | None = None,
                  excluded_kwargs: set[str] | None = None) -> dict[str, str]:
    """Map constructor parameter names to annotation type-names.

    Positional indices in ``excluded_args`` and names in ``excluded_kwargs``
    are omitted — used e.g. to exclude a parameter pytree from an optimizer's
    identity (reference parity: ``torchsystem/registry/core.py:5-12``).
    """
    excluded_args = excluded_args or []
    excluded_kwargs = excluded_kwargs or set()
    result: dict[str, str] = {}
    for index, (key, value) in enumerate(signature(cls).parameters.items()):
        if index in excluded_args or key in excluded_kwargs:
            continue
        if value.annotation is value.empty:
            result[key] = 'Any'
        else:
            result[key] = getattr(value.annotation, '__name__', str(value.annotation))
    return result


def describe_value(value: Any) -> Any:
    """Serialize one constructor argument for identity purposes.

    A registered argument collapses recursively to
    ``{'name': ..., 'arguments': ...}`` — or to its bare name when it captured
    no arguments (reference contract ``torchsystem/registry/core.py:15-26``,
    pinned by ``tests/registry/test_nest.py:26-35``).
    """
    captured = get_arguments(value) if not isinstance(value, (int, float, str, bool, type(None))) else None
    if captured is not None:
        name = get_name(value) or value.__class__.__name__
        if captured:
            return deepcopy({'name': name, 'arguments': captured})
        return name
    return value


def _safe_deepcopy(value: Any) -> Any:
    try:
        return deepcopy(value)
    except Exception:
        return value


def parse_call(args: tuple, kwargs: dict[str, Any],
               parameter_names: list[str],
               excluded_args: list[int],
               excluded_kwargs: set[str]) -> dict[str, Any]:
    """Capture a call's arguments by name, honoring positional/keyword
    exclusions. Positional args align with the *full* parameter list and are
    filtered by index afterwards (reference parity:
    ``torchsystem/registry/core.py:28-40``)."""
    captured: dict[str, Any] = {}
    for index, (arg, key) in enumerate(zip(args, parameter_names)):
        if index not in excluded_args:
            captured[key] = describe_value(arg)
    for key, arg in kwargs.items():
        if key not in excluded_kwargs:
            captured[key] = describe_value(arg)
    return _safe_deepcopy(captured)


def override_init(cls: type,
                  excluded_args: list[int] | None = None,
                  excluded_kwargs: set[str] | None = None,
                  name: str | None = None) -> type:
    """Wrap ``cls.__init__`` to capture construction arguments per instance."""
    original = cls.__init__
    parameter_names = list(signature(cls).parameters.keys())
    excluded_args = excluded_args or []
    excluded_kwargs = excluded_kwargs or set()

    def init_wrapper(obj, *args, **kwargs):
        original(obj, *args, **kwargs)
        put_arguments(obj, parse_call(args, kwargs, parameter_names, excluded_args, excluded_kwargs))
        if name:
            put_name(obj, name)

    init_wrapper.__wrapped__ = original
    cls.__init__ = init_wrapper
    return cls
