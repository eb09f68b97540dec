"""Dataset registry and CLI-compatible factory.

The port's own copy of ``dirjax/datasets/registry.py``, which it
mirrors: dirjax_torch imports nothing of the JAX package, so it carries
this jax-free host module itself.

Replaces the reference's ``eval()``-based string DSL
(``dirtorch/datasets/create.py:5-29``) with an explicit registry plus a safe
mini-parser: ``create("Oxford5K")`` and ``create("ImageList('list.txt')")``
both work, but arguments are parsed with ``ast`` (literals only) instead of
executing arbitrary code.
"""

from __future__ import annotations

import ast
import os
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(cls=None, *, name: str | None = None):
    """Class decorator adding a dataset constructor to the registry."""

    def _register(c):
        _REGISTRY[name or c.__name__] = c
        return c

    return _register(cls) if cls is not None else _register


def available() -> list:
    return sorted(_REGISTRY)


def db_root() -> str:
    """Root directory for benchmark data ($DB_ROOT) — read lazily at
    dataset-construction time, unlike the reference which requires the env
    var at import time (oxford.py:4)."""
    root = os.environ.get("DB_ROOT")
    if not root:
        raise EnvironmentError(
            "DB_ROOT environment variable is not set; it must point to the "
            "directory holding benchmark datasets (oxford5k/, paris6k/, ...)"
        )
    return root


def create(spec: str):
    """Instantiate a dataset from a CLI spec string.

    ``spec`` is ``Name`` or ``Name(arg, ..., kw=value, ...)`` where the
    arguments are Python literals. Example: ``ImageList('queries.txt')``.
    """
    spec = spec.strip()
    if "(" not in spec:
        spec += "()"
    try:
        node = ast.parse(spec, mode="eval").body
    except SyntaxError as e:
        raise ValueError(f"cannot parse dataset spec: {spec!r}") from e
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
        raise ValueError(f"dataset spec must look like Name(...): {spec!r}")
    name = node.func.id
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown dataset {name!r}. Available datasets: {', '.join(available())}"
        )
    args = [ast.literal_eval(a) for a in node.args]
    kwargs = {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}
    return _REGISTRY[name](*args, **kwargs)
