"""Typed configuration layer over the Registry: the port of
:mod:`tpusystem.config`.

The reference configures in plain Python at the composition root with DI
overrides as the late-binding seam, and motivates its ``Registry`` as the
hook for config-file-driven construction (``torchsystem/registry/
accessors.py:195-231``, ``docs/registry.md`` "load a model from a
configuration file") — but ships no config subsystem (SURVEY.md §5). This
module supplies it, keeping code-as-config primary:

- :func:`load` — read a JSON or TOML file into a plain dict;
- :func:`build` — resolve a ``{'name': ..., 'arguments': {...}}`` spec to a
  registered class and construct it, recursively for nested specs. The spec
  schema is **exactly** the registry's captured-argument schema
  (:func:`tpusystem_torch.registry.core.describe_value`), so configs and
  identity metadata are one format;
- :func:`snapshot` — the inverse: serialize a constructed, registered
  object back to a buildable spec. ``build(snapshot(model), registry)``
  reconstructs an equivalent model, and both share one identity hash — the
  reproducibility contract.

Nested-spec resolution rule: inside ``arguments``, a dict with exactly the
keys ``{'name', 'arguments'}`` is a sub-spec; a bare string that names a
registered type with a zero-argument constructor is an argless sub-spec
(the collapsed form the registry emits). Any other value passes through
verbatim.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any

from tpusystem_torch.registry import Registry, getarguments, getname


def load(path: str | pathlib.Path) -> dict:
    """Read a config file (``.json`` or ``.toml``) into a dict."""
    path = pathlib.Path(path)
    if path.suffix == '.toml':
        try:
            import tomllib            # stdlib from 3.11
        except ModuleNotFoundError:
            import tomli as tomllib   # the API-identical 3.10 backport
        return tomllib.loads(path.read_text())
    return json.loads(path.read_text())


def _is_spec(value: Any) -> bool:
    return isinstance(value, dict) and set(value) == {'name', 'arguments'}


def _resolve(value: Any, registry: Registry) -> Any:
    if _is_spec(value):
        return build(value, registry)
    if isinstance(value, str) and registry.get(value) is not None:
        signature = registry.signature(value)
        if not signature:  # argless constructor: the collapsed capture form
            return build({'name': value, 'arguments': {}}, registry)
    if isinstance(value, list):
        return [_resolve(item, registry) for item in value]
    return value


def build(spec: dict | str, registry: Registry) -> Any:
    """Construct the object a spec describes, resolving names through the
    registry and recursing into nested specs.

    Raises:
        KeyError: when the spec names a type the registry doesn't know —
            the config and the code disagree, which must fail loudly.
    """
    if isinstance(spec, str):
        spec = {'name': spec, 'arguments': {}}
    name = spec['name']
    cls = registry.get(name)
    if cls is None:
        raise KeyError(
            f'config names unknown type {name!r}; registered: {registry.keys()}')
    arguments = {
        key: _resolve(value, registry)
        for key, value in spec.get('arguments', {}).items()
    }
    return cls(**arguments)


def snapshot(obj: Any) -> dict:
    """Serialize a registered object to a buildable spec (the inverse of
    :func:`build`). Requires the object's class to be registered so its
    constructor arguments were captured."""
    return {'name': getname(obj), 'arguments': getarguments(obj)}
