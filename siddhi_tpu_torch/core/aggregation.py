"""Incremental multi-duration aggregation.

Reference: core/aggregation/ — `define aggregation A from S select ... group by
... aggregate by ts every sec...year` builds a chain of per-duration executors
(IncrementalExecutor.java:49-580): the finest absorbs events into an in-memory
bucket store; when event time crosses a bucket boundary the closed bucket is
spilled to an auto-created table (`<id>_<DURATION>`, AGG_TIMESTAMP first column
— AggregationParser.java:400,695-708) and rolled up into the next coarser
executor. The query path merges table rows with in-flight buckets
(AggregationRuntime.java:176, IncrementalDataAggregator.java).

As in the JAX package (siddhi_tpu/core/aggregation.py), the whole duration
chain is one state: a bucket store a duration ([G] keys, used flags, one
lane a base, the open bucket's start), stacked here as [D, G] lanes. A
step takes each row's filter mask, event time, group key and base
contributions (stock torch over the batch), then walks the rows through
the chain with `ops/aggregation.py` `agg_step` (K44, a hand-written CUDA
kernel on the card), spilling at most SPILLS_PER_BATCH closed buckets a
duration a step, which are inserted into the duration tables (the table's
insert, K21). A find (`find`: store queries `from A within .. per ..`, and
join sides) merges the finest .. `per` in-flight stores with K45 and
recomposes avg, sum, count, min, max and last after the duration table's
rows. The duration tables keep the JAX package's 4,096 rows. `@store` on
an aggregation rides through to its duration tables, each with its own
`store.id` (core/record_table.py); an app created over stored tables
rebuilds each coarser duration's open bucket from the next finer table
(`rebuild_from_tables`, host side, once). The late-event merge of
`@app:watermark` is not ported yet.
"""

from __future__ import annotations

import logging
import re
from typing import Optional

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.event import (
    EventBatch,
    KIND_CURRENT,
    KIND_TIMER,
    StreamSchema,
)
from siddhi_tpu_torch.core.executor import (
    CompiledExpr,
    Env,
    Scope,
    TS_ATTR,
    compile_expression,
    is_aggregator,
)
from siddhi_tpu_torch.core.table import InMemoryTable
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType, convert_to, float_arith
from siddhi_tpu_torch.observability.lineage import AggregationLineage
from siddhi_tpu_torch.ops.aggregation import (
    SPILLS_PER_BATCH,
    _align1,
    agg_find_merge,
    agg_step,
    align_bucket,
    base_init,
)
from siddhi_tpu_torch.ops.group import mix_keys
from siddhi_tpu_torch.query_api.annotation import Annotation, find_annotation
from siddhi_tpu_torch.query_api.definition import Attribute, Duration, TableDefinition
from siddhi_tpu_torch.query_api.execution import Filter
from siddhi_tpu_torch.query_api.expression import AttributeFunction, Variable

AGG_TS = "AGG_TIMESTAMP"
DEFAULT_AGG_GROUPS = 64
_I64MAX = torch.iinfo(torch.int64).max


def _sum_type(t: AttrType) -> AttrType:
    return AttrType.DOUBLE if t in (AttrType.FLOAT, AttrType.DOUBLE) else AttrType.LONG


class _OutSpec:
    """One selected attribute: the bases it needs and how to recompose it."""

    def __init__(self, name, kind, arg: Optional[CompiledExpr], out_type):
        self.name = name
        self.kind = kind  # sum|count|avg|min|max|last
        self.arg = arg
        self.out_type = out_type


class AggregationRuntime:
    def __init__(self, definition, in_schema: StreamSchema, interner, device,
                 group_capacity: int = DEFAULT_AGG_GROUPS):
        self.definition = definition
        self.agg_id = definition.id
        self.in_schema = in_schema
        self.interner = interner
        self.device = torch.device(device)
        self.g = int(group_capacity)
        if self.g < 1:
            raise SiddhiAppCreationError(f"@app:aggGroupCapacity must be >= 1, got {self.g}")

        stream = definition.basic_single_input_stream
        self.stream_id = stream.stream_id
        self.ref = stream.ref
        scope = Scope(interner, self.device)
        scope.add_stream(self.ref, in_schema.attr_types)
        scope.default_ref = self.ref

        self.filters = []
        for h in stream.handlers:
            if isinstance(h, Filter):
                c = compile_expression(h.expression, scope)
                if c.type is not AttrType.BOOL:
                    raise SiddhiAppCreationError("filter must be boolean")
                self.filters.append(c)
            else:
                raise SiddhiAppCreationError("aggregation inputs support filters only")

        # the event time: `aggregate by <attr>` or the event timestamp
        if definition.aggregate_attribute is not None:
            c = compile_expression(definition.aggregate_attribute, scope)
            if c.type not in (AttrType.LONG, AttrType.INT):
                raise SiddhiAppCreationError("aggregate by attribute must be long")
            self.ts_expr = c
        else:
            self.ts_expr = None
        # lineage recorder (observability/lineage.py AggregationLineage), set
        # by arm_lineage(); it reads the `aggregate by` attribute when that
        # is a plain attribute, else the event timestamp (as JAX)
        self.lineage = None
        self._lin_ts_attr = (definition.aggregate_attribute.attribute
                             if isinstance(definition.aggregate_attribute, Variable) else None)

        self.durations: list[Duration] = list(definition.time_period.durations)
        self.group_by = list(definition.selector.group_by)
        self.group_keys: list[CompiledExpr] = [compile_expression(v, scope)
                                               for v in self.group_by]
        self.out_specs: list[_OutSpec] = []
        # base store lanes: name -> (kind, arg expr, stored type)
        self.bases: dict[str, tuple[str, Optional[CompiledExpr], AttrType]] = {}
        for oa in definition.selector.selection_list:
            e, name = oa.expression, oa.name
            if is_aggregator(e):
                assert isinstance(e, AttributeFunction)
                fn = e.name.lower()
                if fn in ("sum", "min", "max", "avg"):
                    arg = compile_expression(e.parameters[0], scope)
                    if arg.type not in (AttrType.INT, AttrType.LONG, AttrType.FLOAT,
                                        AttrType.DOUBLE):
                        raise SiddhiAppCreationError(f"{fn} needs a numeric argument")
                elif fn == "count":
                    arg = None
                else:
                    raise SiddhiAppCreationError(
                        f"'{e.name}' cannot be aggregated incrementally "
                        "(reference supports sum/count/avg/min/max)")
                if fn in ("sum", "avg"):
                    self._base(f"sum_{name}", "sum", arg, _sum_type(arg.type))
                if fn in ("count", "avg"):
                    self._base("count_", "count", None, AttrType.LONG)
                if fn in ("min", "max"):
                    self._base(f"{fn}_{name}", fn, arg, arg.type)
                out_type = (AttrType.DOUBLE if fn == "avg" else AttrType.LONG if fn == "count"
                            else (_sum_type(arg.type) if fn == "sum" else arg.type))
                self.out_specs.append(_OutSpec(name, fn, arg, out_type))
            else:
                c = compile_expression(e, scope)
                self._base(f"last_{name}", "last", c, c.type)
                self.out_specs.append(_OutSpec(name, "last", c, c.type))

        # the group-by attributes come back from the spill tables: stored
        # as last-value lanes too
        self.group_names: list[str] = []
        for v, c in zip(self.group_by, self.group_keys):
            self.group_names.append(v.attribute)
            self._base(f"last__g_{v.attribute}", "last", c, c.type)
        self.ops = {b: kind for b, (kind, _a, _t) in self.bases.items()}

        # a table a duration, <id>_<DURATION> (reference:
        # AggregationParser.java:701), with the JAX package's 4,096 rows
        table_attrs = [Attribute(AGG_TS, AttrType.LONG)]
        for gname in self.group_names:
            table_attrs.append(Attribute(gname, self.bases[f"last__g_{gname}"][2]))
        for bname, (_kind, _arg, t) in self.bases.items():
            if not bname.startswith("last__g_"):
                table_attrs.append(Attribute(f"AGG_{bname}", t))
        # @store on the aggregation rides through to every duration table,
        # each in a store namespace of its own (reference: AggregationParser
        # initDefaultTables passes the aggregation's annotations on)
        store_ann = find_annotation(getattr(definition, "annotations", []) or [], "store")
        self.tables: dict[Duration, InMemoryTable] = {}
        for d in self.durations:
            anns = []
            if store_ann is not None:
                els = [(k, v) for k, v in store_ann.elements if k != "store.id"]
                base_id = store_ann.element("store.id") or self.agg_id
                anns.append(Annotation(store_ann.name, els + [("store.id", f"{base_id}__{d.name}")]))
            self.tables[d] = InMemoryTable(
                TableDefinition(f"{self.agg_id}_{d.name}", list(table_attrs), annotations=anns),
                interner, self.device)

        # the find path's rows: AGG_TIMESTAMP, then the selected attributes
        self.out_schema = StreamSchema(
            self.agg_id, [(AGG_TS, AttrType.LONG)] + [(s.name, s.out_type)
                                                       for s in self.out_specs])
        self.state = self.init_state()
        self.timer_target = None
        self.rebuild_from_tables()

    def _base(self, name, kind, arg, t):
        if name not in self.bases:
            self.bases[name] = (kind, arg, t)

    # ---- the restart rebuild -----------------------------------------------

    def rebuild_from_tables(self) -> None:
        """Rebuild each coarser duration's open bucket from the next finer
        duration's table rows (reference: aggregation/RecreateInMemoryData.java;
        the JAX package's `rebuild_from_tables`, numpy folds and all): a
        `@store` aggregation created again without a snapshot recovers its
        in-flight coarse buckets from the stored fine spills. The finest
        duration's open bucket is lost, as in the reference (its raw events
        were never spilled). Host side, once, at creation."""
        for i in range(1, len(self.durations)):
            d = self.durations[i]
            src = self.tables[self.durations[i - 1]].state
            valid = src["valid"].cpu().numpy()
            if not valid.any():
                continue  # only a duration whose own source is empty is skipped
            src_cols = {n: c.cpu().numpy() for n, c in src["cols"].items()}
            ts = src_cols[AGG_TS][valid]
            open_bucket = _align1(int(ts.max()), d.value)
            own = self.tables[d].state
            own_valid = own["valid"].cpu().numpy()
            if own_valid.any() and (own["cols"][AGG_TS].cpu().numpy()[own_valid]
                                    == open_bucket).any():
                # this bucket already closed into d's own table: in flight
                # again it would be inserted twice at the next close
                continue
            in_open = align_bucket(torch.from_numpy(ts), d.value).numpy() == open_bucket
            if not in_open.any():
                continue
            cols = {n: c[valid][in_open] for n, c in src_cols.items()}
            order = np.argsort(ts[in_open], kind="stable")
            gvals = [cols[g] for g in self.group_names]
            groups: dict = {}
            for ri in order:
                groups.setdefault(tuple(v[ri].item() for v in gvals), []).append(ri)
            g = self.g
            keys = np.zeros(g, np.int64)
            used = np.zeros(g, bool)
            vals = {b: np.full(g, base_init(kind, PHYSICAL_DTYPE[t]),
                               torch.empty(0, dtype=PHYSICAL_DTYPE[t]).numpy().dtype)
                    for b, (kind, _a, t) in self.bases.items()}
            for slot_i, ridx in enumerate(groups.values()):
                if slot_i >= g:
                    break
                # the device key: float group values by their int32 bits, mixed
                kcols = []
                for gname, gv in zip(self.group_names, gvals):
                    t = self.bases[f"last__g_{gname}"][2]
                    v = np.asarray([gv[ridx[0]]])
                    if t in (AttrType.FLOAT, AttrType.DOUBLE):
                        v = v.astype(np.float32).view(np.int32)
                    kcols.append(torch.from_numpy(v.astype(np.int64)))
                if kcols:
                    keys[slot_i] = int(mix_keys(kcols)[0])
                used[slot_i] = True
                for bname, (kind, _arg, _t) in self.bases.items():
                    col = (cols[bname[len("last__g_"):]] if bname.startswith("last__g_")
                           else cols[f"AGG_{bname}"])
                    sel = col[ridx]
                    if kind in ("sum", "count"):
                        vals[bname][slot_i] = sel.sum()
                    elif kind == "min":
                        vals[bname][slot_i] = sel.min()
                    elif kind == "max":
                        vals[bname][slot_i] = sel.max()
                    else:  # last
                        vals[bname][slot_i] = sel[-1]
            st = self.state
            dev = self.device
            st["keys"][i] = torch.from_numpy(keys).to(dev)
            st["used"][i] = torch.from_numpy(used).to(dev)
            for b, v in vals.items():
                st["vals"][b][i] = torch.from_numpy(v).to(dev)
            st["bucket"][i] = open_bucket

    # ---- state -----------------------------------------------------------

    def init_state(self) -> dict:
        """The JAX package's `init_state`, stacked: every store lane [D, G]
        (min lanes at +inf / the type's max, max lanes at -inf / its min),
        the buckets [D] at -1; the spill lanes [D, S, G] zeros."""
        d, g, s, dev = len(self.durations), self.g, SPILLS_PER_BATCH, self.device
        vals, sp = {}, {}
        for b, (kind, _arg, t) in self.bases.items():
            dt = PHYSICAL_DTYPE[t]
            vals[b] = torch.full((d, g), base_init(kind, dt), dtype=dt, device=dev)
            sp[b] = torch.zeros((d, s, g), dtype=dt, device=dev)
        return {
            "keys": torch.zeros((d, g), dtype=torch.int64, device=dev),
            "used": torch.zeros((d, g), dtype=torch.bool, device=dev),
            "vals": vals,
            "bucket": torch.full((d,), -1, dtype=torch.int64, device=dev),
            "spill": {"ts": torch.zeros((d, s), dtype=torch.int64, device=dev),
                      "keys": torch.zeros((d, s, g), dtype=torch.int64, device=dev),
                      "used": torch.zeros((d, s, g), dtype=torch.bool, device=dev),
                      "vals": sp},
            "spill_n": torch.zeros(d, dtype=torch.int32, device=dev),
        }

    # ---- the step ---------------------------------------------------------

    def _step(self, state: dict, batch: EventBatch, now: torch.Tensor):
        """The JAX package's `_step_impl`: the rows' lanes over [B], then the
        scan (K44). Returns (new_state, aux)."""
        b = batch.capacity
        env_cols = {(self.ref, None, n): c for n, c in batch.cols.items()}
        env_cols[(self.ref, None, TS_ATTR)] = batch.ts
        env = Env(env_cols, now=now)
        live = batch.valid & (batch.kind == KIND_CURRENT)
        for f in self.filters:
            live = live & f(env)
        is_timer = batch.valid & (batch.kind == KIND_TIMER)
        ev_ts = self.ts_expr(env).to(torch.int64).expand(b) if self.ts_expr else batch.ts
        ev_ts = torch.where(is_timer, batch.ts, ev_ts).contiguous()
        if self.group_keys:
            kcols = []
            for c in self.group_keys:
                col = c(env).expand(b)
                if c.type in (AttrType.FLOAT, AttrType.DOUBLE):
                    col = col.contiguous().view(torch.int32)  # the bits: -0.0 != 0.0
                kcols.append(col.to(torch.int64))
            row_key = mix_keys(kcols).contiguous()
        else:
            row_key = torch.zeros(b, dtype=torch.int64, device=self.device)
        contribs = {}
        for bname, (kind, arg, t) in self.bases.items():
            dt = PHYSICAL_DTYPE[t]
            if kind == "count":
                contribs[bname] = torch.ones(b, dtype=dt, device=self.device)
            else:
                contribs[bname] = arg(env).to(dt).expand(b).contiguous()
        new_state, ovf = agg_step(state, ev_ts, live.contiguous(), is_timer.contiguous(), row_key,
                                  contribs, self.ops, [d.value for d in self.durations])
        aux = {"agg_overflow": ovf}
        # the next root-bucket close, only when bucketing by the events' own
        # timestamps (an `aggregate by` clock is decoupled from the
        # scheduler's: closes come with the events, and finds merge the
        # in-flight buckets)
        d0 = self.durations[0]
        if self.ts_expr is None and d0 not in (Duration.MONTHS, Duration.YEARS):
            b0 = new_state["bucket"][0]
            aux["next_timer"] = torch.where(b0 >= 0, b0 + d0.millis, _I64MAX)
        return new_state, aux

    def _spill_to_tables(self, state: dict) -> None:
        """Insert the step's closed buckets into the duration tables: each
        duration's [S, G] spilled rows, flattened, through the table's
        insert (the JAX package's `_spill_to_tables`). One host read of the
        spill counts skips the durations that closed nothing."""
        s, g = SPILLS_PER_BATCH, self.g
        sp = state["spill"]
        n_closed = state["spill_n"].tolist()
        slots = torch.arange(s, device=self.device)[:, None]
        for di, dur in enumerate(self.durations):
            if not n_closed[di]:
                continue  # every row of the insert would be invalid
            table = self.tables[dur]
            rows_used = (sp["used"][di] & (slots < n_closed[di])).reshape(-1)
            ts_flat = sp["ts"][di][:, None].expand(s, g).reshape(-1)
            cols = {AGG_TS: ts_flat}
            for gname in self.group_names:
                cols[gname] = sp["vals"][f"last__g_{gname}"][di].reshape(-1)
            for bname in self.bases:
                if not bname.startswith("last__g_"):
                    cols[f"AGG_{bname}"] = sp["vals"][bname][di].reshape(-1)
            batch = EventBatch(
                ts=ts_flat, kind=torch.zeros_like(ts_flat, dtype=torch.int8), valid=rows_used,
                cols={n: convert_to(cols[n], PHYSICAL_DTYPE[t]) for n, t in table.schema.attrs})
            with table.lock:
                table.state = table.insert(table.state, batch, {})

    def arm_lineage(self, cfg) -> None:
        """Per-bucket provenance (@app:lineage): the contributing seq range
        and count per finest-duration bucket."""
        self.lineage = AggregationLineage(cfg, self.agg_id, self.stream_id, self.durations[0])

    def receive(self, batch: EventBatch, now: int) -> dict:
        """One batch (or one TIMER row) through the chain; the closed buckets
        into the tables, written through to their record stores. Returns the
        step's aux (`next_timer` when the finest bucket's end drives a TIMER
        step)."""
        lin = self.lineage
        if lin is not None:
            try:
                ts = batch.cols[self._lin_ts_attr] if self._lin_ts_attr is not None else batch.ts
                current = batch.valid & (batch.kind == KIND_CURRENT)
                lin.observe_ts(ts.to(torch.int64)[current].cpu().numpy())
            except Exception:  # provenance never breaks dispatch
                logging.getLogger(__name__).debug("aggregation lineage observe failed",
                                                  exc_info=True)
        now_t = torch.full((), now, dtype=torch.int64, device=self.device)
        self.state, aux = self._step(self.state, batch, now_t)
        self._spill_to_tables(self.state)
        for t in self.tables.values():
            t.notify_change()
        return aux

    # ---- find (store queries and join sides) -----------------------------

    def check_per(self, per: Duration) -> None:
        if per not in self.tables:
            raise SiddhiAppCreationError(
                f"aggregation '{self.agg_id}' has no '{per.name}' duration")

    def find(self, per: Duration, within: Optional[tuple[int, int]], state=None,
             tstate=None) -> EventBatch:
        """Rows for `from A within .. per '<dur>'`: the duration table's
        closed buckets, then the finest .. `per` in-flight stores merged
        into one aligned to `per` (K45), recomposed (reference:
        AggregationRuntime.find:176 + IncrementalDataAggregator); rows
        outside `within` [lo, hi) are masked off. 4,096 + G rows."""
        self.check_per(per)
        state = self.state if state is None else state
        tstate = self.tables[per].state if tstate is None else tstate
        temp, _ovf = agg_find_merge(state, self.durations.index(per) + 1, per.value, self.ops)
        g = self.g
        inflight_cols = self._recompose(temp["vals"])
        inflight_ts = temp["bucket"].expand(g)
        inflight_valid = temp["used"] & (temp["bucket"] >= 0)
        tvals = {}
        for bname in self.bases:
            if bname.startswith("last__g_"):
                tvals[bname] = tstate["cols"][bname[len("last__g_"):]]
            else:
                tvals[bname] = tstate["cols"][f"AGG_{bname}"]
        table_cols = self._recompose(tvals)
        ts = torch.cat([tstate["cols"][AGG_TS], inflight_ts])
        cols = {AGG_TS: ts}
        for s in self.out_specs:
            dt = PHYSICAL_DTYPE[s.out_type]
            cols[s.name] = torch.cat([table_cols[s.name].to(dt), inflight_cols[s.name].to(dt)])
        valid = torch.cat([tstate["valid"], inflight_valid])
        if within is not None:
            lo, hi = within
            valid = valid & (ts >= lo) & (ts < hi)
        return EventBatch(ts=ts, kind=torch.zeros(ts.shape[0], dtype=torch.int8,
                                                  device=self.device),
                          valid=valid, cols=cols)

    def _recompose(self, vals: dict) -> dict:
        """The selected attributes from base lanes: avg = sum / count in
        float32 (NaN at count 0), sum, count, min, max, last."""
        cols = {}
        for s in self.out_specs:
            if s.kind == "avg":
                num = vals[f"sum_{s.name}"].to(torch.float32)
                den = vals["count_"].to(torch.float32)
                q = float_arith("div", num, torch.where(den != 0, den, 1.0))
                cols[s.name] = torch.where(den != 0, q, torch.nan)
            elif s.kind == "sum":
                cols[s.name] = vals[f"sum_{s.name}"]
            elif s.kind == "count":
                cols[s.name] = vals["count_"]
            elif s.kind in ("min", "max"):
                cols[s.name] = vals[f"{s.kind}_{s.name}"]
            else:
                cols[s.name] = vals[f"last_{s.name}"]
        return cols


class AggFindable:
    """An aggregation as a passive join side: its merged view (closed
    buckets and in-flight ones) for one `per`, masked by `within`
    (reference: AggregationRuntime in joins via find,
    AggregationRuntime.java:176-300). Probed like a table, never driven."""

    is_named_window = False

    def __init__(self, agg: AggregationRuntime, per: Duration, within):
        agg.check_per(per)
        self.agg = agg
        self.per = per
        self.within = within  # (start_ms, end_ms) or None
        self.table_id = f"__aggview_{agg.agg_id}_{per.name}"
        self.schema = agg.out_schema

    @property
    def state(self):
        return {"agg": self.agg.state, "table": self.agg.tables[self.per].state}

    def view(self, packed):
        out = self.agg.find(self.per, self.within, packed["agg"], packed["table"])
        return out.cols, out.ts, out.valid


# ---------------------------------------------------------------------------
# within / per parsing (host)
# ---------------------------------------------------------------------------

_DUR_NAMES = {
    "sec": Duration.SECONDS, "second": Duration.SECONDS, "seconds": Duration.SECONDS,
    "min": Duration.MINUTES, "minute": Duration.MINUTES, "minutes": Duration.MINUTES,
    "hour": Duration.HOURS, "hours": Duration.HOURS,
    "day": Duration.DAYS, "days": Duration.DAYS,
    "month": Duration.MONTHS, "months": Duration.MONTHS,
    "year": Duration.YEARS, "years": Duration.YEARS,
}


def parse_per(value) -> Duration:
    d = _DUR_NAMES.get(str(value).strip().lower())
    if d is None:
        raise SiddhiAppCreationError(f"unknown aggregation duration {value!r}")
    return d


_TIME_RE = re.compile(
    r"^(\d{4}|\*{1,4})-(\d{2}|\*{1,2})-(\d{2}|\*{1,2})"
    r"(?:[ T](\d{2}|\*{1,2}):(\d{2}|\*{1,2}):(\d{2}|\*{1,2}))?"
    r"(?:\s*(?:Z|([+-])(\d{2}):(\d{2})))?$"
)


def parse_within_value(v) -> tuple[int, int]:
    """One `within` operand -> [start, end) ms. Longs are exact instants;
    strings follow the reference's `yyyy-MM-dd HH:mm:ss` (GMT default) with
    `**` wildcards expanding to the containing range."""
    import datetime as dt

    if isinstance(v, (int, float)):
        return int(v), int(v) + 1
    m = _TIME_RE.match(str(v).strip())
    if not m:
        raise SiddhiAppCreationError(f"cannot parse within time {v!r}")
    y, mo, d, h, mi, s = m.group(1, 2, 3, 4, 5, 6)
    off_sign, off_h, off_m = m.group(7, 8, 9)
    offset_ms = 0
    if off_sign:
        offset_ms = (int(off_h) * 3600 + int(off_m) * 60) * 1000
        if off_sign == "-":
            offset_ms = -offset_ms

    def wild(x):
        return x is None or "*" in x

    parts = [y, mo, d, h, mi, s]
    # the first wildcarded component; every one after it must be wild too
    level = 6
    for i, p in enumerate(parts):
        if wild(p):
            level = i
            break
    for p in parts[level + 1:] if level < 6 else []:
        if not wild(p):
            raise SiddhiAppCreationError(
                f"within {v!r}: components after a wildcard must be wildcards")
    vals = [int(p) if not wild(p) else 0 for p in parts]
    y_, mo_, d_, h_, mi_, s_ = vals
    if level == 0:
        raise SiddhiAppCreationError(f"within {v!r}: year cannot be a wildcard")
    start = dt.datetime(
        y_, mo_ if level > 1 else 1, d_ if level > 2 else 1,
        h_ if level > 3 else 0, mi_ if level > 4 else 0, s_ if level > 5 else 0,
        tzinfo=dt.timezone.utc)
    if level == 1:
        end = start.replace(year=start.year + 1)
    elif level == 2:
        end = (start.replace(year=start.year + 1, month=1) if start.month == 12
               else start.replace(month=start.month + 1))
    elif level == 3:
        end = start + dt.timedelta(days=1)
    elif level == 4:
        end = start + dt.timedelta(hours=1)
    elif level == 5:
        end = start + dt.timedelta(minutes=1)
    else:
        end = start + dt.timedelta(seconds=1)
    start_ms = int(start.timestamp() * 1000) - offset_ms
    end_ms = int(end.timestamp() * 1000) - offset_ms
    return start_ms, end_ms


def parse_within(w) -> Optional[tuple[int, int]]:
    """A join's `within` clause: one constant, or the parser's
    `__within_range__(lo, hi)` of two; None when absent."""
    from siddhi_tpu_torch.query_api.expression import Constant

    if isinstance(w, AttributeFunction) and w.name == "__within_range__":
        lo, hi = w.parameters
        if not (isinstance(lo, Constant) and isinstance(hi, Constant)):
            raise SiddhiAppCreationError("'within' operands must be constants")
        return parse_within_value(lo.value)[0], parse_within_value(hi.value)[0]
    if isinstance(w, Constant):
        return parse_within_value(w.value)
    if w is not None:
        raise SiddhiAppCreationError("'within' operands must be constants")
    return None
