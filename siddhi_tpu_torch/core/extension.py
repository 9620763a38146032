"""Extension registry — the analog of the reference's @Extension SPI.

Reference: siddhi-annotations .../annotation/Extension.java +
core/util/SiddhiExtensionLoader.java:47-130. Java classpath scanning becomes
decorator registration into per-kind registries keyed `namespace:name`.
"""

from __future__ import annotations

from typing import Callable, Optional

# kind -> {"ns:name" | "name": factory}
_REGISTRY: dict[str, dict[str, object]] = {
    "function": {},
    "window": {},
    "aggregator": {},
    "stream_processor": {},
    "stream_function": {},
    "source": {},
    "sink": {},
    "source_mapper": {},
    "sink_mapper": {},
    "store": {},
    "script": {},
}


def extension(kind: str, name: str, namespace: Optional[str] = None) -> Callable:
    """Register an extension factory, e.g.

        @extension("function", "plus", namespace="custom")
        def _plus(params, scope): ...
    """

    def deco(obj):
        key = f"{namespace}:{name}" if namespace else name
        reg = _REGISTRY.get(kind)
        if reg is None:
            raise KeyError(f"unknown extension kind '{kind}'")
        reg[key] = obj
        return obj

    return deco


def lookup(kind: str, name: str):
    return _REGISTRY[kind].get(name)


def lookup_function(name: str):
    return _REGISTRY["function"].get(name)
