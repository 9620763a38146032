"""In-memory tables: a device-resident columnar arena with insert, update,
delete and update-or-insert under compiled conditions, and the planner that
compiles a query's table output.

Reference: core/table/InMemoryTable.java:55-220 + table/holder/
IndexEventHolder.java — list/indexed/primary-key event holders with CRUD
under compiled conditions — and util/collection/ (CollectionExecutors,
Operators), the lookup planner. As in the JAX package (siddhi_tpu/core/
table.py), a table is a fixed-capacity arena (`cols/ts/valid/seq` lanes and
the `next` sequence number), with a sorted index per indexed column; every
operation runs inside the query step that writes the table. Its device
routines are the kernels of `ops/table.py` (K21-K24):
- insert: K21 `table_write`, then K22 rebuilds each sorted index;
- delete: K23 `table_match` (any match per slot), then K22;
- update: the planner's choice, as the JAX package's, of
  - the indexed path (a single-column equality `on` over a column whose
    index holds no duplicate: K22's probe, then the set clauses at the
    probe rows and a scatter),
  - the dense path (K23's last matching probe row per slot, then the set
    clauses over the [C] lanes), when last-writer-wins provably equals the
    sequential iteration (`_update_parallel_vectorizable`),
  - else the sequential path, K24 `table_update_scan`, with the rekey
    guard for an update that may change a single primary key;
  a table whose auto-index holds duplicates takes the dense path on that
  step instead of the indexed one: both are enqueued and the index's
  device flag turns one off (no host read);
- update or insert: K24 `table_upsert_scan`, then K22;
- `in <table>` conditions: K23 (any match per probe row).

Conditions and set values that read the table compile into table programs
(`ops/table.py` TableProgram); a table-dependent subtree outside their
operations raises at app creation ("not ported yet"). A `@store` table
(core/record_table.py) loads its rows from its record store at creation
through `insert` (K21) and writes a row snapshot through after its mutating
steps, at most one a second (`notify_change`); a lazy store stages the rows
of each store query's pushdown instead. `@OnError` on a table is not ported
yet.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import DefinitionNotExistError, SiddhiAppCreationError
from siddhi_tpu_torch.core.event import KIND_CURRENT, KIND_EXPIRED, EventBatch, StreamSchema
from siddhi_tpu_torch.core.executor import (
    TS_ATTR,
    CompiledExpr,
    Env,
    Scope,
    _notnull,
    compile_expression,
)
from siddhi_tpu_torch.core.pattern import (
    _ARITH_CODE,
    _CMP_CODE,
    _TY,
    OP_AND,
    OP_ARITH,
    OP_CMP,
    OP_CONST,
    OP_ISNULL,
    OP_NOT,
    OP_OR,
    OP_REG,
    _conjuncts,
    _const_bits,
    arith_code,
)
from siddhi_tpu_torch.core.types import (
    NUMERIC_TYPES,
    PHYSICAL_DTYPE,
    AttrType,
    convert_to,
    promote,
)
from siddhi_tpu_torch.ops import table as K
from siddhi_tpu_torch.ops.scatter import set_at
from siddhi_tpu_torch.query_api.annotation import find_all, find_annotation
from siddhi_tpu_torch.query_api.definition import TableDefinition
from siddhi_tpu_torch.query_api.execution import (
    DeleteStream,
    InsertIntoStream,
    OutputEventsFor,
    UpdateOrInsertStream,
    UpdateSetAttribute,
    UpdateStream,
)
from siddhi_tpu_torch.query_api.expression import (
    And,
    Compare,
    CompareOp,
    Constant,
    IsNull,
    Not,
    Or,
    Variable,
)

DEFAULT_TABLE_CAPACITY = 4096
_MAX64 = torch.iinfo(torch.int64).max


class InMemoryTable:
    """Host handle for one table: schema, device state and its operations.

    State: {"cols": {attr: [C]}, "ts": [C] int64, "valid": [C] bool,
    "seq": [C] int64 (insertion order; int64 max when empty), "next": 0-d
    int64, and per indexed column "ix_order.<col>" int32 [C],
    "ix_sorted.<col>" [C], "ix_dups.<col>" 0-d bool} — the JAX package's
    layout, leaf for leaf."""

    def __init__(self, definition: TableDefinition, interner, device,
                 capacity: int = DEFAULT_TABLE_CAPACITY):
        self.definition = definition
        self.table_id = definition.id
        self.schema = StreamSchema(definition.id, [(a.name, a.type) for a in definition.attributes])
        self.interner = interner
        self.device = torch.device(device)
        cap_ann = find_annotation(definition.annotations, "capacity")
        self.capacity = (int(cap_ann.element("size") or cap_ann.element(None))
                         if cap_ann else int(capacity))
        pks = find_all(definition.annotations or [], "PrimaryKey")
        if len(pks) > 1:
            # reference: DuplicateAnnotationException for repeated @PrimaryKey
            raise SiddhiAppCreationError(
                f"table '{self.table_id}': @PrimaryKey annotation is repeated")
        pk = pks[0] if pks else None
        self.primary_keys: list[str] = [v for _, v in pk.elements] if pk else []
        if pk is not None and not self.primary_keys:
            raise SiddhiAppCreationError(
                f"table '{self.table_id}': @PrimaryKey needs at least one attribute")
        for k in self.primary_keys:
            if k not in self.schema.attr_names:
                raise SiddhiAppCreationError(
                    f"table '{self.table_id}': @PrimaryKey attribute '{k}' undefined")
        idxs = (find_all(definition.annotations or [], "Index")
                + find_all(definition.annotations or [], "IndexBy"))
        if len(idxs) > 1:
            # reference: DuplicateAnnotationException for repeated @Index
            raise SiddhiAppCreationError(f"table '{self.table_id}': @Index annotation is repeated")
        idx = idxs[0] if idxs else None
        self.indexes: list[str] = [v for _, v in idx.elements] if idx else []
        if len(set(self.indexes)) != len(self.indexes):
            raise SiddhiAppCreationError(
                f"table '{self.table_id}': @Index lists an attribute twice")
        for k in self.indexes:
            if k not in self.schema.attr_names:
                raise SiddhiAppCreationError(
                    f"table '{self.table_id}': @Index attribute '{k}' undefined")
        # declared @Index columns are kept from creation; equality-probed
        # columns also index at query-compile time (enable_index)
        self._indexed_cols: tuple = tuple(dict.fromkeys(self.indexes))
        self.lock = threading.RLock()
        self._winners: dict = {}  # K22's probe writer scratch, one an indexed column
        self.state = self.init_state()

        # @store(type='...'): an external record store — load its contents,
        # write a snapshot through after each mutation (reference:
        # AbstractRecordTable SPI)
        self.record_store = None
        self.lazy = False
        store_ann = find_annotation(definition.annotations, "store")
        if store_ann is not None:
            from siddhi_tpu_torch.core.record_table import build_record_store

            self.record_store = build_record_store(store_ann, self.table_id, self.schema)
            rows = self.record_store.load()
            if rows is None:
                self.lazy = True  # finds push their condition down
            else:
                if len(rows) > self.capacity:
                    raise SiddhiAppCreationError(
                        f"table '{self.table_id}': record store holds {len(rows)} rows but "
                        f"capacity is {self.capacity}; raise it with @capacity(size='N') "
                        "before restarting")
                self.state = self.load_rows(self.state, rows)
        self._dirty = False
        self._last_flush = 0.0
        self._flush_lock = threading.Lock()
        self._flush_timer = None

    def load_rows(self, state: dict, rows: list) -> dict:
        """`state` with host rows (schema order) inserted."""
        if not rows:
            return state
        batch = self.schema.to_batch([0] * len(rows), rows, self.interner, self.device,
                                     capacity=len(rows))
        return self.insert(state, batch, {})

    # ---- record-store write-through ---------------------------------------

    def notify_change(self) -> None:
        """After a mutating step: mark the table dirty; snapshots coalesce to
        at most one a second (each decodes the whole table on the host), a
        deferred flush catching the last change of a quiet spell."""
        if self.record_store is None:
            return
        if self.lazy:
            raise SiddhiAppCreationError(
                f"table '{self.table_id}': a lazy (queryable) record store cannot accept "
                "streaming writes; materialize it or write to the store directly")
        with self._flush_lock:
            self._dirty = True
            due = time.monotonic() - self._last_flush >= 1.0
            if not due and self._flush_timer is None:
                t = threading.Timer(1.0, self._deferred_flush)
                t.daemon = True
                self._flush_timer = t
                t.start()
        if due:
            self.flush_record_store()

    def _deferred_flush(self) -> None:
        with self._flush_lock:
            self._flush_timer = None
        self.flush_record_store()

    def flush_record_store(self) -> None:
        with self._flush_lock:
            store = self.record_store
            if store is None or not self._dirty:
                return
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None
            store.on_change(self.rows())
            self._dirty = False
            self._last_flush = time.monotonic()

    def close_record_store(self) -> None:
        """The last flush, then disconnect; later flushes do nothing."""
        self.flush_record_store()
        with self._flush_lock:
            store, self.record_store = self.record_store, None
            if self._flush_timer is not None:
                self._flush_timer.cancel()
                self._flush_timer = None
        if store is not None:
            store.disconnect()

    # ---- state ------------------------------------------------------------

    def init_state(self) -> dict:
        c, dev = self.capacity, self.device
        st = {
            "cols": {n: torch.zeros(c, dtype=PHYSICAL_DTYPE[t], device=dev)
                     for n, t in self.schema.attrs},
            "ts": torch.zeros(c, dtype=torch.int64, device=dev),
            "valid": torch.zeros(c, dtype=torch.bool, device=dev),
            "seq": torch.full((c,), _MAX64, dtype=torch.int64, device=dev),
            "next": torch.zeros((), dtype=torch.int64, device=dev),
        }
        for col in self._indexed_cols:
            kd = st["cols"][col].dtype
            st[f"ix_order.{col}"] = torch.arange(c, dtype=torch.int32, device=dev)
            st[f"ix_sorted.{col}"] = torch.full((c,), K.sort_sentinel(kd), dtype=kd, device=dev)
            st[f"ix_dups.{col}"] = torch.zeros((), dtype=torch.bool, device=dev)
        return st

    def describe_state(self) -> dict:
        """Live row count, capacity and index wiring (one host read)."""
        with self.lock:
            rows = int(self.state["valid"].sum())
        return {"capacity": self.capacity, "primary_keys": list(self.primary_keys),
                "indexes": list(self._indexed_cols),
                "record_store": self.record_store is not None, "rows": rows}

    def enable_index(self, col: str) -> None:
        """Keep a sorted index of `col` (an equality probe compiled against
        it); builds it over the live state now."""
        if col in self._indexed_cols:
            return
        if col not in self.schema.attr_names:
            raise SiddhiAppCreationError(
                f"table '{self.table_id}': cannot index undefined column '{col}'")
        self._indexed_cols = tuple(self._indexed_cols) + (col,)
        with self.lock:
            self.state = self._rebuild_index(dict(self.state), col)

    def _rebuild_index(self, state: dict, col: str) -> dict:
        order, sk, dups = K.table_index_build(state["cols"][col], state["valid"])
        return {**state, f"ix_order.{col}": order, f"ix_sorted.{col}": sk,
                f"ix_dups.{col}": dups}

    def _rebuild_pk_index(self, state: dict) -> dict:
        for col in self._indexed_cols:
            state = self._rebuild_index(dict(state), col)
        return state

    def view(self, state: dict):
        """(cols, ts, mask): the join probe view, as a window's."""
        return state["cols"], state["ts"], state["valid"]

    # ---- device operations (inside query steps) ---------------------------

    def insert(self, state: dict, batch: EventBatch, aux: dict) -> dict:
        """Insert the valid CURRENT rows. A primary-key conflict drops the
        arriving row (reference: IndexEventHolder.add putIfAbsent,
        table/holder/IndexEventHolder.java:177-186); within a batch the
        first row per key wins. `update or insert into` overwrites."""
        rows = batch.valid & (batch.kind == KIND_CURRENT)
        index = None
        if len(self.primary_keys) == 1 and self.primary_keys[0] in self._indexed_cols:
            col = self.primary_keys[0]
            index = (state[f"ix_order.{col}"], state[f"ix_sorted.{col}"])
        out, overflow, pk_dup = K.table_write(state, batch.cols, batch.ts, rows,
                                              self.primary_keys, index)
        _or_flag(aux, "table_overflow", overflow)
        if self.primary_keys:
            _or_flag(aux, "table_pk_duplicate_dropped", pk_dup)
        return self._rebuild_pk_index(out)

    def delete(self, state: dict, batch: EventBatch, on: "TableOn", now) -> dict:
        rows = batch.valid & (batch.kind == KIND_CURRENT)
        doomed = on.match(state, batch, now, rows, K.MODE_DELETE)
        # rebuild the indexes: a deleted row that shadowed a same-key
        # duplicate would otherwise hide the surviving row from the probe
        return self._rebuild_pk_index({**state, "valid": state["valid"] & ~doomed})

    def update(self, state: dict, batch: EventBatch, op: "_UpdateOp", now, aux: dict) -> dict:
        """Update matching table rows from each probe row: the indexed,
        dense or sequential path (see the module docstring)."""
        rows = batch.valid & (batch.kind == KIND_CURRENT)
        if op.parallel_ok:
            if op.pk_probe is not None:
                col, probe_fn, unique = op.pk_probe
                if unique:
                    out = self._update_indexed(state, batch, col, probe_fn, op.set_fns, now, rows)
                else:
                    # the sorted probe is exact while the indexed column holds
                    # no duplicate; a table holding duplicates of the probed
                    # key takes the dense all-matches path on this step. Both
                    # are enqueued and the device flag turns one off (JAX's
                    # lax.cond, with no host read): the probe hits nothing
                    # and K23 matches nothing where the flag says so
                    dups = state[f"ix_dups.{col}"]
                    out = self._update_indexed(state, batch, col, probe_fn, op.set_fns, now,
                                               rows & ~dups)
                    out = self._update_dense(out, batch, op, now, rows, gate=dups)
            else:
                out = self._update_dense(state, batch, op, now, rows)
        else:
            regs = eval_regs(op.scan.on.regs, _probe_env(batch, now), rows.shape[0])
            out, conflict = K.table_update_scan(op.scan, regs, state, rows)
            if op.scan.guard is not None:
                _or_flag(aux, "table_pk_conflict", conflict)
        return self._rebuild_pk_index(out) if op.reindex_after() else out

    def _update_dense(self, state: dict, batch: EventBatch, op: "_UpdateOp", now, rows,
                      gate=None) -> dict:
        """Last-writer-wins update: K23's last matching probe row per slot
        (none while the device flag `gate` is false)."""
        writer = op.on.match(state, batch, now, rows, K.MODE_WRITER, gate)
        return self._apply_winner(state, batch, writer, op.set_fns, now)

    def _update_indexed(self, state: dict, batch: EventBatch, col: str, probe_fn, set_fns,
                        now, rows) -> dict:
        """K22's probe of the column's sorted index; the set values at the
        winning probe rows (beside their candidate slots) are scattered in
        (reference: IndexEventHolder key get/put,
        table/holder/IndexEventHolder.java:59-110)."""
        c = self.capacity
        keys = state["cols"][col]
        env_cols = _probe_cols(batch)
        probe_raw = probe_fn(Env(env_cols, now=now))
        if probe_raw.dim() == 0:
            probe_raw = probe_raw.expand(rows.shape).contiguous()
        probe_t = getattr(probe_fn, "type", self.schema.attr_types[col])
        ok = rows & _notnull(probe_raw, probe_t)
        winner = None if keys.device.type == "cpu" else self.winner_scratch(col, keys.device)
        target = K.table_index_probe(keys, state["valid"], state[f"ix_order.{col}"],
                                     state[f"ix_sorted.{col}"], probe_raw, ok, winner)
        cand = target.clamp(0, c - 1).long()
        env_cols.update({(self.table_id, None, n): v[cand] for n, v in state["cols"].items()})
        env_cols[(self.table_id, None, TS_ATTR)] = state["ts"][cand]
        env = Env(env_cols, now=now)
        new_cols = dict(state["cols"])
        for name, fn in set_fns:
            new_cols[name] = set_at(state["cols"][name], target,
                                    convert_to(fn(env), state["cols"][name].dtype))
        return {**state, "cols": new_cols}

    def winner_scratch(self, col: str, device) -> torch.Tensor:
        """Column col's writer scratch for K22's probe, made once (all -1,
        and left so by every probe); used under self.lock, so no other
        table's probe or a second probe of this one shares it in flight."""
        w = self._winners.get(col)
        if w is None or w.device != device:
            w = self._winners[col] = K.winner_scratch(device, self.capacity)
        return w

    def _apply_winner(self, state: dict, batch: EventBatch, winner, set_fns, now) -> dict:
        """Gather each slot's winning probe row, build the per-slot env and
        apply the set clauses (winner [C], -1 = no match)."""
        b = batch.valid.shape[0]
        has = winner >= 0
        wi = winner.clamp(0, b - 1).long()
        env_cols = {("__out__", None, n): v[wi] for n, v in batch.cols.items()}
        env_cols[("__out__", None, TS_ATTR)] = batch.ts[wi]
        env_cols.update({(self.table_id, None, n): v for n, v in state["cols"].items()})
        env_cols[(self.table_id, None, TS_ATTR)] = state["ts"]
        env = Env(env_cols, now=now)
        new_cols = dict(state["cols"])
        for name, fn in set_fns:
            new_cols[name] = torch.where(has, convert_to(fn(env), state["cols"][name].dtype),
                                         state["cols"][name])
        return {**state, "cols": new_cols}

    def update_or_insert(self, state: dict, batch: EventBatch, op: "_UpsertOp", now,
                         aux: dict) -> dict:
        """Per probe row: update the matches, else insert the row
        (reference: InMemoryTable.updateOrAdd); the probe columns map onto
        the table's by position (selector output order)."""
        rows = batch.valid & (batch.kind == KIND_CURRENT)
        regs = eval_regs(op.scan.on.regs, _probe_env(batch, now), rows.shape[0])
        ins_cols = {n: convert_to(batch.cols[src], state["cols"][n].dtype)
                    for n, src in op.src_of.items()}
        out, ovf = K.table_upsert_scan(op.scan, regs, state, rows, ins_cols, batch.ts)
        _or_flag(aux, "table_overflow", ovf)
        return self._rebuild_pk_index(out)

    # ---- host side ----------------------------------------------------------

    def rows(self) -> list[tuple]:
        """The current contents in insertion order (host)."""
        from siddhi_tpu_torch.core.event import column_lists

        with self.lock:
            st = self.state
        valid = st["valid"].cpu().numpy()
        seq = st["seq"].cpu().numpy()
        order = np.argsort(np.where(valid, seq, np.iinfo(np.int64).max), kind="stable")
        order = order[valid[order]]
        cols = {n: c.cpu().numpy()[order] for n, c in st["cols"].items()}
        lists = column_lists(self.schema, cols, len(order), self.interner)
        return list(zip(*lists)) if lists else [() for _ in order]


def _or_flag(aux: dict, key: str, flag: torch.Tensor) -> None:
    prev = aux.get(key)
    aux[key] = flag if prev is None else (prev | flag)


def _probe_cols(batch: EventBatch) -> dict:
    cols = {("__out__", None, n): v for n, v in batch.cols.items()}
    cols[("__out__", None, TS_ATTR)] = batch.ts
    return cols


def _probe_env(batch: EventBatch, now) -> Env:
    return Env(_probe_cols(batch), now=now)


def eval_regs(regs: list, env: Env, b: int) -> list:
    """Each row register over the probe env, as a contiguous [B] lane."""
    out = []
    for r in regs:
        v = r(env)
        out.append(v.expand(b).contiguous() if v.dim() == 0 else v.contiguous())
    return out


# ---------------------------------------------------------------------------
# table programs
# ---------------------------------------------------------------------------


def _sub_scope(scope: Scope) -> Scope:
    s = scope.child()
    s.prefer_default = scope.prefer_default
    s.prefer_parent = scope.prefer_parent
    return s


def emit_program(expr, scope: Scope, table_ref: str, regs: Optional[list] = None
                 ) -> K.TableProgram:
    """Compile `expr` (in `scope`, where the table is `table_ref`) into a
    table program. Subtrees that do not read the table become row registers
    (appended to `regs`, shared between the programs of one op); a
    table-dependent subtree outside the program's operations raises."""
    regs = [] if regs is None else regs
    code: list = []
    lanes: list = []

    def emit(e) -> AttrType:
        s = _sub_scope(scope)
        c = compile_expression(e, s)
        if not any(k[0] == table_ref for k in s.used_keys):
            if isinstance(e, Constant):
                code.append((OP_CONST, _TY[c.type], _const_bits(c(Env({})), _TY[c.type])))
            else:
                code.append((OP_REG, len(regs), _TY[c.type]))
                regs.append(c)
            return c.type
        if isinstance(e, Variable):
            (_ref, _k, attr), t = _sub_scope(scope).resolve(e)
            name = None if attr == TS_ATTR else attr
            if name not in lanes:
                lanes.append(name)
            code.append((K.OP_TAB, lanes.index(name), _TY[t]))
            return t
        if type(e) in _ARITH_CODE:
            lt, rt = emit(e.left), emit(e.right)
            t = promote(lt, rt)
            code.append((OP_ARITH, arith_code(e, t), _TY[lt], _TY[rt], _TY[t]))
            return t
        if isinstance(e, Compare):
            lt, rt = emit(e.left), emit(e.right)
            t = _TY[promote(lt, rt)] if lt in NUMERIC_TYPES and rt in NUMERIC_TYPES else -1
            code.append((OP_CMP, _CMP_CODE[e.op], _TY[lt], _TY[rt], t))
            return AttrType.BOOL
        if isinstance(e, (And, Or)):
            emit(e.left)
            emit(e.right)
            code.append((OP_AND,) if isinstance(e, And) else (OP_OR,))
            return AttrType.BOOL
        if isinstance(e, Not):
            emit(e.expression)
            code.append((OP_NOT,))
            return AttrType.BOOL
        if isinstance(e, IsNull) and e.expression is not None:
            t = emit(e.expression)
            code.append((OP_ISNULL, _TY[t]))
            return AttrType.BOOL
        raise SiddhiAppCreationError(
            f"a {type(e).__name__} over the columns of table '{table_ref}' is not ported yet")

    t = emit(expr)
    depth = top = 0
    for ins in code:
        if ins[0] in (OP_REG, OP_CONST, K.OP_TAB):
            top += 1
        elif ins[0] in (OP_ARITH, OP_CMP, OP_AND, OP_OR):
            top -= 1
        depth = max(depth, top)
    if depth > K.MAX_STACK or len(lanes) > K.MAX_LANES or len(regs) > K.MAX_REGS:
        raise SiddhiAppCreationError(
            f"a table condition deeper than {K.MAX_STACK} operands, or reading more than "
            f"{K.MAX_LANES} lanes or {K.MAX_REGS} registers, is not ported yet")
    return K.TableProgram(code, regs, lanes, _TY[t])


_TRUE = [(OP_CONST, _TY[AttrType.BOOL], 1)]


class TableOn:
    """A compiled on-condition (None: every valid slot) for K23."""

    def __init__(self, table: InMemoryTable, expr, scope: Scope):
        self.table = table
        self.prog = (emit_program(expr, scope, table.table_id) if expr is not None
                     else K.TableProgram(list(_TRUE), [], [], _TY[AttrType.BOOL]))

    def match(self, state: dict, batch: EventBatch, now, rows, mode: int, gate=None):
        regs = eval_regs(self.prog.regs, _probe_env(batch, now), rows.shape[0])
        lanes = K.lane_tensors(self.prog, state["cols"], state["ts"])
        return K.table_match(self.prog, regs, lanes, state["valid"], rows, mode, gate)


def compile_in_condition(table: InMemoryTable, expr, inner_scope: Scope) -> Callable:
    """`(<cond>) in T` (executor.compile_expression): per probe row, whether
    any valid slot of T's live state matches — K23's per-row mode."""
    prog = emit_program(expr, inner_scope, table.table_id)

    def fn(env: Env) -> torch.Tensor:
        state = table.state
        b = None
        for v in env.columns.values():
            if v.dim() == 1:
                b = v.shape[0]
                break
        if b is None:
            raise ValueError(f"'in {table.table_id}': no [B] probe lane at this site")
        regs = eval_regs(prog.regs, env, b)
        lanes = K.lane_tensors(prog, state["cols"], state["ts"])
        rows = torch.ones(b, dtype=torch.bool, device=state["valid"].device)
        return K.table_match(prog, regs, lanes, state["valid"], rows, K.MODE_IN)

    return fn


# ---------------------------------------------------------------------------
# the planner: a query's (or store query's) table output
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _UpdateOp:
    on: TableOn
    set_fns: list
    parallel_ok: bool
    pk_probe: Optional[tuple]
    scan: Optional[K.ScanPrograms]
    reindex_after: Callable[[], bool]


@dataclasses.dataclass
class _UpsertOp:
    scan: K.ScanPrograms
    src_of: dict


def compile_table_output(output_stream, out_schema: StreamSchema,
                         tables: dict[str, InMemoryTable], interner, device) -> Optional[Callable]:
    """Compile a query's output into a table op `(out_batch, now, aux) ->
    None` that writes the table's state, or None when the output does not
    target a table (reference: OutputParser constructing Insert/Update/
    Delete/UpdateOrInsertIntoTableCallback)."""
    target = getattr(output_stream, "target", None)

    if isinstance(output_stream, InsertIntoStream):
        if target not in tables:
            return None
        table = tables[target]
        _check_positional_schema(out_schema, table, "insert into")
        names = table.schema.attr_names
        dtypes = {n: PHYSICAL_DTYPE[t] for n, t in table.schema.attrs}
        want = output_stream.output_events

        def insert_op(out_batch: EventBatch, now, aux, _t=table):
            # `insert [current|expired|all] events into T` (reference:
            # InsertIntoTableCallback event-type filtering)
            if want is OutputEventsFor.CURRENT:
                keep = out_batch.kind == KIND_CURRENT
            elif want is OutputEventsFor.EXPIRED:
                keep = out_batch.kind == KIND_EXPIRED
            else:
                keep = torch.ones_like(out_batch.valid)
            cols = {n: out_batch.cols[sn].to(dtypes[n])
                    for n, sn in zip(names, out_schema.attr_names)}
            renamed = EventBatch(out_batch.ts, torch.zeros_like(out_batch.kind),
                                 out_batch.valid & keep, cols)
            with _t.lock:
                _t.state = _t.insert(_t.state, renamed, aux)
            _t.notify_change()  # record-store write-through

        return insert_op

    if not isinstance(output_stream, (UpdateStream, DeleteStream, UpdateOrInsertStream)):
        return None
    table = tables.get(target)
    if table is None:
        raise DefinitionNotExistError(f"'{target}' is not a defined table")
    if isinstance(output_stream, UpdateOrInsertStream):
        _check_positional_schema(out_schema, table, "update or insert into")
    scope = output_scope(table, out_schema, interner, device)
    on_expr = output_stream.on
    if on_expr is not None:
        on_c = compile_expression(on_expr, scope)
        if on_c.type is not AttrType.BOOL:
            raise SiddhiAppCreationError("'on' must be a boolean expression")

    if isinstance(output_stream, DeleteStream):
        on = TableOn(table, on_expr, scope)

        def delete_op(out_batch, now, aux, _t=table):
            with _t.lock:
                _t.state = _t.delete(_t.state, out_batch, on, now)
            _t.notify_change()  # record-store write-through

        return delete_op

    set_attrs = output_stream.set_attributes
    set_fns = compile_set_attributes(table, set_attrs, scope)

    def scan_programs(guard_col: Optional[str] = None) -> K.ScanPrograms:
        return build_scan_programs(table, scope, on_expr, set_attrs,
                                   [n for n, _fn in set_fns], guard_col)

    if isinstance(output_stream, UpdateOrInsertStream):
        op = _UpsertOp(scan_programs(), dict(zip(table.schema.attr_names,
                                                 out_schema.attr_names)))

        def upsert_op(out_batch, now, aux, _t=table):
            with _t.lock:
                _t.state = _t.update_or_insert(_t.state, out_batch, op, now, aux)
            _t.notify_change()  # record-store write-through

        return upsert_op

    par_ok = _update_parallel_vectorizable(on_expr, set_attrs, table, out_schema)
    # a single-@PrimaryKey table whose update writes the key takes the
    # sequential path with the atomic rekey guard (reference:
    # IndexOperator.update aborts an update event whose new key collides),
    # unless the on-clause pins the written key to the same expression
    pk_guard = None
    if len(table.primary_keys) == 1:
        pk_col = table.primary_keys[0]
        if pk_col in {n for n, _ in set_fns}:
            found0 = _eq_probe_expr(on_expr, table, out_schema)
            smap = _set_map(set_attrs, table, out_schema)
            pinned = found0 is not None and found0[0] == pk_col and found0[1] == smap.get(pk_col)
            if not pinned:
                pk_guard = pk_col
                par_ok = False
    pk_probe = None
    if par_ok:
        found = _eq_probe_expr(on_expr, table, out_schema)
        if found is not None:
            col, p_side = found
            # planner decision (reference: util/collection CollectionExecutors
            # choosing an indexed lookup): a single-column equality probe
            # indexes that column; @PrimaryKey uniqueness skips the dup test
            unique = table.primary_keys == [col]
            pk_probe = (col, compile_expression(p_side, scope), unique)
            table.enable_index(col)

    def reindex_after(_t=table) -> bool:
        # decided per step: later queries may have indexed more columns, and
        # an update that can rewrite an indexed column to a value the match
        # does not pin must rebuild its sorted index
        return _index_written_unpinned(on_expr, set_attrs, _t, out_schema)

    op = _UpdateOp(
        on=TableOn(table, on_expr, scope) if par_ok else None,
        set_fns=set_fns, parallel_ok=par_ok, pk_probe=pk_probe,
        scan=None if par_ok else scan_programs(pk_guard),
        reindex_after=reindex_after)

    def update_op(out_batch, now, aux, _t=table):
        with _t.lock:
            _t.state = _t.update(_t.state, out_batch, op, now, aux)
        _t.notify_change()  # record-store write-through

    return update_op


def output_scope(table: InMemoryTable, out_schema: StreamSchema, interner, device) -> Scope:
    """The scope a table output's on-condition and set values compile in:
    the selector's output as "__out__" (unqualified names resolve there
    first) beside the table."""
    scope = Scope(interner, device)
    scope.add_stream("__out__", dict(out_schema.attrs))
    scope.add_stream(table.table_id, table.schema.attr_types)
    scope.default_ref = "__out__"
    scope.prefer_default = True
    return scope


def build_scan_programs(table: InMemoryTable, scope: Scope, on_expr, set_attributes,
                        set_names: list, guard_col: Optional[str] = None) -> K.ScanPrograms:
    """K24's programs for a sequential op: the on-condition (None: every
    valid slot) and the value of each set column in `set_names`, over one
    shared list of row registers; `guard_col` the rekey-guarded key."""
    regs: list = []
    on_p = (emit_program(on_expr, scope, table.table_id, regs) if on_expr is not None
            else K.TableProgram(list(_TRUE), regs, [], _TY[AttrType.BOOL]))
    sets = [(name, emit_program(_set_expr(set_attributes, name), scope, table.table_id, regs))
            for name in set_names]
    guard = None if guard_col is None else list(set_names).index(guard_col)
    return K.ScanPrograms(on_p, sets, guard, table.schema.attr_names)


def _set_expr(set_attributes, name: str):
    """The expression a set clause writes into column `name` (the
    same-named output attribute when there is no set clause)."""
    if set_attributes:
        for sa in set_attributes:
            if sa.table_variable.attribute == name:
                return sa.expression
    return Variable(name)


def _eq_probe_expr(on_expr, table: InMemoryTable, out_schema: StreamSchema):
    """(column, probe expression) when the condition is exactly
    `T.col == <probe expr>` over one table column, else None."""
    if on_expr is None:
        return None
    conj = list(_conjuncts(on_expr))
    if len(conj) != 1 or not (isinstance(conj[0], Compare) and conj[0].op is CompareOp.EQ):
        return None
    c = conj[0]
    for t_side, p_side in ((c.left, c.right), (c.right, c.left)):
        if (isinstance(t_side, Variable) and _reads_table(t_side, table, out_schema)
                and t_side.attribute in table.schema.attr_names
                and not _reads_table(p_side, table, out_schema)):
            return t_side.attribute, p_side
    return None


def _set_map(set_attributes, table, out_schema):
    if set_attributes:
        return {sa.table_variable.attribute: sa.expression for sa in set_attributes}
    return {name: Variable(name) for name, _t in table.schema.attrs
            if name in out_schema.attr_names}


def _eq_sources(on_expr, table, out_schema) -> dict:
    out: dict = {}
    if on_expr is None:
        return out
    for c in _conjuncts(on_expr):
        if isinstance(c, Compare) and c.op is CompareOp.EQ:
            for t_side, p_side in ((c.left, c.right), (c.right, c.left)):
                if (isinstance(t_side, Variable) and _reads_table(t_side, table, out_schema)
                        and not _reads_table(p_side, table, out_schema)):
                    out[t_side.attribute] = p_side
    return out


def _index_written_unpinned(on_expr, set_attributes, table, out_schema) -> bool:
    """True when an update may change an indexed column to a value the
    on-condition does not pin to its current value."""
    sm = _set_map(set_attributes, table, out_schema)
    eq = _eq_sources(on_expr, table, out_schema)
    return any(col in sm and eq.get(col) != sm[col] for col in table._indexed_cols)


def _reads_table(expr, table: InMemoryTable, out_schema: StreamSchema) -> bool:
    """True when an expression AST can read a column of `table` under the
    update scope (unqualified names resolve to the output stream first)."""
    if isinstance(expr, Variable):
        if expr.stream_id == table.table_id:
            return True
        return (expr.stream_id is None and expr.attribute not in out_schema.attr_names
                and expr.attribute in table.schema.attr_names)
    if dataclasses.is_dataclass(expr) and not isinstance(expr, type):
        return any(_reads_table(getattr(expr, f.name), table, out_schema)
                   for f in dataclasses.fields(expr))
    if isinstance(expr, (list, tuple)):
        return any(_reads_table(x, table, out_schema) for x in expr)
    return False


def _update_parallel_vectorizable(on_expr, set_attributes, table: InMemoryTable,
                                  out_schema: StreamSchema) -> bool:
    """Whether `update T on <cond> [set ...]` may run as one last-writer-
    wins pass instead of the sequential iteration: safe iff every set value
    is independent of table state, and every table column the on-condition
    reads is either not written or written from exactly the probe
    expression it is equated with in a top-level conjunct."""
    set_map = _set_map(set_attributes, table, out_schema)
    for src in set_map.values():
        if _reads_table(src, table, out_schema):
            return False
    if on_expr is None:
        return True
    eq_sources = _eq_sources(on_expr, table, out_schema)

    def table_cols_read(e, acc):
        if isinstance(e, Variable):
            if _reads_table(e, table, out_schema):
                acc.add(e.attribute)
            return acc
        if dataclasses.is_dataclass(e) and not isinstance(e, type):
            for f in dataclasses.fields(e):
                table_cols_read(getattr(e, f.name), acc)
        elif isinstance(e, (list, tuple)):
            for x in e:
                table_cols_read(x, acc)
        return acc

    for col in table_cols_read(on_expr, set()):
        if col not in set_map:
            continue  # not written: always stable
        if eq_sources.get(col) != set_map[col]:
            return False  # written to a value the match does not pin
    return True


def collect_used_tables(query, tables: dict[str, InMemoryTable]) -> set[str]:
    """Table ids a query touches: `in <table>` conditions anywhere in its
    AST, table join sides, and its table-output target."""
    from siddhi_tpu_torch.query_api.execution import JoinInputStream
    from siddhi_tpu_torch.query_api.expression import In

    used: set[str] = set()

    def walk(obj):
        if isinstance(obj, In):
            if obj.source_id in tables:
                used.add(obj.source_id)
            walk(obj.expression)
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))
        elif isinstance(obj, (list, tuple)):
            for x in obj:
                walk(x)
        elif isinstance(obj, dict):
            for x in obj.values():
                walk(x)

    walk(query)
    target = getattr(query.output_stream, "target", None)
    if target in tables:
        used.add(target)
    ins = query.input_stream
    if isinstance(ins, JoinInputStream):
        for s in (ins.left, ins.right):
            if s.stream_id in tables:
                used.add(s.stream_id)
    return used


def _check_positional_schema(out_schema: StreamSchema, table: InMemoryTable, what: str) -> None:
    """Positional mapping needs matching arity and types, with Java's
    implicit numeric widening (reference: DefinitionParserHelper
    validateOutputStream)."""
    if len(out_schema.attrs) != len(table.schema.attrs):
        raise SiddhiAppCreationError(
            f"{what} table '{table.table_id}': selector emits {len(out_schema.attrs)} "
            f"attributes, table has {len(table.schema.attrs)}")
    for (on_, ot), (tn, tt) in zip(out_schema.attrs, table.schema.attrs):
        if ot is tt:
            continue
        if ot in NUMERIC_TYPES and tt in NUMERIC_TYPES and promote(ot, tt) is tt:
            continue  # widening; the op's cast performs it
        raise SiddhiAppCreationError(
            f"{what} table '{table.table_id}': output attribute '{on_}' is {ot.name} but "
            f"table column '{tn}' is {tt.name}")


def compile_set_attributes(table: InMemoryTable, set_attributes: Optional[list[UpdateSetAttribute]],
                           scope: Scope) -> list[tuple[str, CompiledExpr]]:
    """`set T.a = expr, ...`; absent, every table column takes the
    same-named output attribute (reference: InMemoryTable default update)."""
    out: list[tuple[str, CompiledExpr]] = []
    if set_attributes:
        for sa in set_attributes:
            name = sa.table_variable.attribute
            if name not in table.schema.attr_names:
                raise SiddhiAppCreationError(
                    f"set target '{name}' is not a column of '{table.table_id}'")
            out.append((name, compile_expression(sa.expression, scope)))
    else:
        for name, _t in table.schema.attrs:
            try:
                out.append((name, compile_expression(Variable(name), scope)))
            except KeyError:
                continue  # no same-named output attribute: column untouched
    return out
