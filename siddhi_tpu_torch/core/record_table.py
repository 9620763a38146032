"""External record-table SPI: tables backed by a pluggable store.

Reference: table/record/AbstractRecordTable.java + AbstractQueryableRecordTable
— the SPI external stores (RDBMS etc.) implement, with
`ExpressionBuilder`->`CompiledExpression` condition pushdown.

As in the JAX package (siddhi_tpu/core/record_table.py), the device columnar
arena is the working copy: a `@store(type='...')` table loads its initial
contents from the record store at app creation (through the table's own
insert, K21) and writes a row snapshot through after its mutating steps
(core/table.py `notify_change`). A lazy store serves store queries through
condition pushdown instead. Stores register via @extension("store", name).
"""

from __future__ import annotations

import threading
from typing import Optional

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError


class RecordStore:
    """SPI: durable backing for one table.

    Two modes (reference: AbstractRecordTable vs
    AbstractQueryableRecordTable):
    - materialized (the default): `load()` returns the full row list; the
      device arena is the working copy and the store is durability.
    - lazy/queryable: `load()` returns None; store queries then push their
      `on` condition down through `query()` and only the matching rows are
      staged onto the device for the select phase. Streaming writes into a
      lazy store are rejected at run time."""

    def init(self, table_id: str, schema, options: dict) -> None:
        self.table_id = table_id
        self.schema = schema
        self.options = options

    def load(self) -> Optional[list[tuple]]:
        """Initial table contents (rows of Python values, schema order), or
        None to stay lazy and serve finds through `query()`."""
        return []

    def query(self, on_expression, interner) -> Optional[list[tuple]]:
        """Condition pushdown for lazy stores: the rows matching the store
        query's raw `on` Expression AST (None: all rows), or None when the
        condition cannot be pushed down (the engine then raises). The device
        checks the condition again, so returning extra rows is safe."""
        return None

    def on_change(self, rows: list[tuple]) -> None:
        """Write-through: the table's full row snapshot after a mutation."""
        raise NotImplementedError

    def disconnect(self) -> None:
        pass


class InMemoryRecordStore(RecordStore):
    """A process-wide store keyed by `store.id` (or the table id): it
    survives app restarts within the process, the reference's test analog
    of an external store."""

    _lock = threading.Lock()
    _data: dict[str, list[tuple]] = {}

    def _key(self) -> str:
        return self.options.get("store.id", self.table_id)

    def load(self) -> list[tuple]:
        with self._lock:
            return list(self._data.get(self._key(), []))

    def on_change(self, rows: list[tuple]) -> None:
        with self._lock:
            self._data[self._key()] = list(rows)

    @classmethod
    def clear_all(cls) -> None:
        with cls._lock:
            cls._data.clear()


RECORD_STORES = {"memory": InMemoryRecordStore}


def build_record_store(ann, table_id: str, schema) -> RecordStore:
    """From a table definition's @store(type='...', ...) annotation."""
    from siddhi_tpu_torch.core.extension import lookup

    stype = ann.element("type")
    if stype is None:
        raise SiddhiAppCreationError("@store needs a type")
    cls = RECORD_STORES.get(stype.lower()) or lookup("store", stype)
    if cls is None:
        raise SiddhiAppCreationError(f"unknown store type '{stype}'")
    store = cls()
    store.init(table_id, schema, {k: v for k, v in ann.elements if k is not None})
    return store
