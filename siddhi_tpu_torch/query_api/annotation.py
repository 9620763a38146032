"""Annotations — the query-language flag system.

Reference: siddhi-query-api .../annotation/Annotation.java; consumed per
SURVEY.md §5 (config/flag system): @app:name, @async, @config, @source/@sink/@map,
@primaryKey/@index, @info, ...
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Annotation:
    name: str
    # Ordered (key, value) pairs; key None for positional elements
    # like @primaryKey('a','b').
    elements: list[tuple[Optional[str], str]] = dataclasses.field(default_factory=list)
    annotations: list["Annotation"] = dataclasses.field(default_factory=list)

    def element(self, key: Optional[str] = None, default: Optional[str] = None):
        for k, v in self.elements:
            if k == key:
                return v
        if key is None and len(self.elements) == 1:
            return self.elements[0][1]
        return default

    def positional(self) -> list[str]:
        return [v for k, v in self.elements if k is None]


def find_annotation(annotations: list[Annotation], name: str) -> Optional[Annotation]:
    low = name.lower()
    for a in annotations:
        if a.name.lower() == low:
            return a
    return None


def find_all(annotations: list[Annotation], name: str) -> list[Annotation]:
    low = name.lower()
    return [a for a in annotations if a.name.lower() == low]
