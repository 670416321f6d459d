"""Entity identity accessors.

Models, optimizers, loaders etc. become *entities* once registered: their
constructor arguments are captured and a deterministic hash derived from
``name + arguments`` identifies them across processes, hosts and restarts.
That hash keys experiment rows and checkpoint directories, enabling
transparent resume (reference flow ``torchsystem/registry/accessors.py:45-68``
-> ``examples/tinysys/tinysys/services/compilation.py:41-64``).

Determinism matters doubly on a TPU pod: every worker must compute the same
id so all hosts agree on which checkpoint to restore. The hash algorithm is
``md5(name + json.dumps(arguments))`` — identical to the reference so
identities are stable and portable.
"""

from __future__ import annotations

from hashlib import md5
from json import dumps
from typing import Any, Callable, Optional, TypeVar, overload

from tpusystem_torch.registry import core

T = TypeVar('T')


def getarguments(obj: object) -> dict[str, Any]:
    """Captured constructor arguments of a registered object.

    Raises:
        AttributeError: if the object's class was never registered
            (reference parity ``torchsystem/registry/accessors.py:11-27``).
    """
    arguments = core.get_arguments(obj)
    if arguments is None:
        raise AttributeError(
            f'{obj.__class__.__name__} is not registered: no captured arguments')
    return arguments


def getname(obj: object) -> str:
    """Registered alias of the object, falling back to its class name."""
    return core.get_name(obj) or obj.__class__.__name__


def _hash_fallback(value: Any) -> Any:
    """Deterministic JSON encoding for non-JSON captured arguments.

    Types (including dtype sentinels like ``jnp.bfloat16``) encode as their
    name; sets encode as sorted lists (set repr order is hash-randomized
    across processes). A value whose repr embeds a memory address has no
    stable cross-process identity — raising here (like the reference's bare
    ``json.dumps`` would) beats silently aliasing two different experiments
    to one hash; the fix is to ``register`` the value's class.
    """
    if isinstance(value, type):
        return getattr(value, '__name__', str(value))
    if isinstance(value, (set, frozenset)):
        return sorted(dumps(item, default=_hash_fallback) for item in value)
    rendered = repr(value)
    if ' at 0x' in rendered:
        raise TypeError(
            f'cannot derive a stable identity for captured argument of type '
            f'{value.__class__.__qualname__}: its repr embeds a memory address. '
            f'register() its class so it captures constructor arguments, or '
            f'exclude it via excluded_args/excluded_kwargs.')
    return rendered


def gethash(obj: object) -> str:
    """Deterministic identity hash of a registered object.

    A manually assigned hash (:func:`sethash`) takes precedence; otherwise
    ``md5(getname(obj) + json.dumps(getarguments(obj)))``. Non-JSON argument
    values (dtypes, nested unregistered objects) are canonicalized via
    :func:`_hash_fallback`; pure-JSON captures hash byte-identically to the
    reference (pinned digest ``b12461be...``).

    Raises:
        AttributeError: when the object has neither captured arguments nor a
            manual hash.
    """
    manual = core.get_hash(obj)
    if manual is not None:
        return manual
    if core.get_arguments(obj) is None:
        raise AttributeError(
            f'{obj.__class__.__name__} has no identity: register the class or sethash()')
    payload = dumps(getarguments(obj), default=_hash_fallback)
    return md5((getname(obj) + payload).encode()).hexdigest()


def sethash(obj: object, hash: str | None = None) -> None:
    """Assign an identity hash manually; ``None`` freezes the computed one."""
    core.put_hash(obj, hash if hash is not None else gethash(obj))


def setname(obj: object, name: str | None = None) -> None:
    """Assign a name alias manually; ``None`` freezes the current name."""
    core.put_name(obj, name if name is not None else getname(obj))


def getmetadata(obj: object) -> dict[str, Any]:
    """All identity metadata present on the object: hash?, name?, arguments?"""
    metadata: dict[str, Any] = {}
    if (manual := core.get_hash(obj)) is not None:
        metadata['hash'] = manual
    if (alias := core.get_name(obj)) is not None:
        metadata['name'] = alias
    if (arguments := core.get_arguments(obj)) is not None:
        metadata['arguments'] = arguments
    return metadata


@overload
def register(cls: type, excluded_args: list[int] | None = None,
             excluded_kwargs: set[str] | None = None) -> type: ...


@overload
def register(cls: str, excluded_args: list[int] | None = None,
             excluded_kwargs: set[str] | None = None) -> Callable[[type], type]: ...


def register(cls: type | str | None = None,
             excluded_args: list[int] | None = None,
             excluded_kwargs: set[str] | None = None):
    """Register a class for argument capture.

    Usable three ways (reference parity
    ``torchsystem/registry/accessors.py:119-193``)::

        register(MLP)                      # plain call
        @register                          # bare decorator
        class Model: ...
        @register('Criterion')             # rename decorator
        class CrossEntropy: ...
        register(Adam, excluded_args=[0])  # exclude the params arg from identity
    """
    if isinstance(cls, type):
        return core.override_init(cls, excluded_args, excluded_kwargs)
    name = cls

    def wrapper(klass: type) -> type:
        return core.override_init(klass, excluded_args, excluded_kwargs, name)
    return wrapper


class Registry:
    """Name-indexed catalog of registered types.

    Enables dynamic construction from configuration files or remote commands:
    resolve a name to a class, inspect its signature, build it — and the
    instance carries its identity hash automatically
    (reference parity ``torchsystem/registry/accessors.py:233-312``).
    """

    def __init__(self) -> None:
        self.types: dict[str, type] = {}
        self.signatures: dict[str, dict[str, str]] = {}

    @overload
    def register(self, cls: str, excluded_args: list[int] | None = None,
                 excluded_kwargs: set[str] | None = None) -> Callable[[type], type]: ...

    @overload
    def register(self, cls: type, excluded_args: list[int] | None = None,
                 excluded_kwargs: set[str] | None = None) -> type: ...

    def register(self, cls, excluded_args=None, excluded_kwargs=None):
        if isinstance(cls, type):
            self.types[cls.__name__] = cls
            self.signatures[cls.__name__] = core.cls_signature(cls, excluded_args, excluded_kwargs)
            return core.override_init(cls, excluded_args, excluded_kwargs)
        name = cls

        def wrapper(klass: type) -> type:
            self.types[name] = klass
            self.signatures[name] = core.cls_signature(klass, excluded_args, excluded_kwargs)
            return core.override_init(klass, excluded_args, excluded_kwargs, name)
        return wrapper

    def get(self, name: str) -> Optional[type]:
        return self.types.get(name)

    def keys(self) -> list[str]:
        return list(self.types.keys())

    def signature(self, name: str) -> Optional[dict[str, str]]:
        return self.signatures.get(name)
