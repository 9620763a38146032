"""SiddhiQL recursive-descent parser: token stream -> query-api AST.

Covers the reference grammar's surface (reference:
siddhi-query-compiler .../SiddhiQL.g4 + internal/SiddhiQLBaseVisitorImpl.java):
app/definition/query/partition/store-query forms, annotations, joins, pattern and
sequence chains (every / count <m:n> / * + ? / logical and-or / absent not-for),
selectors with group by / having / order by / limit / offset, output rates, and
the full expression grammar with reference operator precedence
(not > */% > +- > relational > equality > in > and > or).
"""

from __future__ import annotations

from typing import Optional

from siddhi_tpu_torch.compiler.tokenizer import TIME_UNITS, Token, tokenize
from siddhi_tpu_torch.core.errors import SiddhiParserError
from siddhi_tpu_torch.core.types import AttrType
from siddhi_tpu_torch.query_api.annotation import Annotation
from siddhi_tpu_torch.query_api.definition import (
    AggregationDefinition,
    Attribute,
    Duration,
    FunctionDefinition,
    StreamDefinition,
    TableDefinition,
    TimePeriod,
    TriggerDefinition,
    WindowDefinition,
    WindowSpec,
)
from siddhi_tpu_torch.query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    DeleteStream,
    EventOutputRate,
    EveryStateElement,
    Filter,
    InputStore,
    InsertIntoStream,
    JoinEventTrigger,
    JoinInputStream,
    JoinType,
    LogicalStateElement,
    LogicalType,
    NextStateElement,
    OrderByAttribute,
    OrderDir,
    OutputAttribute,
    OutputEventsFor,
    OutputRateType,
    Partition,
    Query,
    RangePartitionProperty,
    RangePartitionType,
    ReturnStream,
    Selector,
    SingleInputStream,
    SnapshotOutputRate,
    StateElement,
    StateInputStream,
    StateStreamType,
    StoreQuery,
    StreamFunctionHandler,
    StreamStateElement,
    TimeOutputRate,
    UpdateOrInsertStream,
    UpdateSetAttribute,
    UpdateStream,
    ValuePartitionType,
    WindowHandler,
)
from siddhi_tpu_torch.query_api.expression import (
    Add,
    And,
    AttributeFunction,
    Compare,
    CompareOp,
    Constant,
    Divide,
    Expression,
    In,
    IsNull,
    Mod,
    Multiply,
    Not,
    Or,
    Subtract,
    TimeConstant,
    Variable,
)
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp

_TYPES = {
    "string": AttrType.STRING,
    "int": AttrType.INT,
    "long": AttrType.LONG,
    "float": AttrType.FLOAT,
    "double": AttrType.DOUBLE,
    "bool": AttrType.BOOL,
    "object": AttrType.OBJECT,
}

_DURATIONS = {
    "sec": Duration.SECONDS, "seconds": Duration.SECONDS, "second": Duration.SECONDS,
    "min": Duration.MINUTES, "minutes": Duration.MINUTES, "minute": Duration.MINUTES,
    "hour": Duration.HOURS, "hours": Duration.HOURS,
    "day": Duration.DAYS, "days": Duration.DAYS,
    "month": Duration.MONTHS, "months": Duration.MONTHS,
    "year": Duration.YEARS, "years": Duration.YEARS,
}

# keywords that terminate an attribute/expression list in a selector
_SECTION_KW = {
    "group", "having", "order", "limit", "offset", "output", "insert",
    "delete", "update", "return",
}


class Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.pos = 0

    # ---- token helpers ---------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.type != "EOF":
            self.pos += 1
        return t

    def at(self, type_: str) -> bool:
        return self.peek().type == type_

    def at_kw(self, *kws: str, ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.type == "ID" and t.text.lower() in kws

    def accept(self, type_: str) -> Optional[Token]:
        if self.at(type_):
            return self.next()
        return None

    def accept_kw(self, *kws: str) -> Optional[Token]:
        if self.at_kw(*kws):
            return self.next()
        return None

    def expect(self, type_: str) -> Token:
        if not self.at(type_):
            t = self.peek()
            raise self.err(f"expected {type_!r}, found {t.text!r}")
        return self.next()

    def expect_kw(self, *kws: str) -> Token:
        if not self.at_kw(*kws):
            t = self.peek()
            raise self.err(f"expected {'/'.join(kws)!r}, found {t.text!r}")
        return self.next()

    def err(self, msg: str) -> SiddhiParserError:
        t = self.peek()
        return SiddhiParserError(msg, t.line, t.col)

    def stamp(self, node, tok: Token):
        """Thread the source position of `tok` onto an AST node (only when the
        node does not already carry a more specific position)."""
        if getattr(node, "line", None) is None:
            node.line, node.col = tok.line, tok.col
        return node

    def name(self) -> str:
        t = self.peek()
        if t.type in ("ID", "QID"):
            self.next()
            return t.text
        raise self.err(f"expected identifier, found {t.text!r}")

    # ---- app -------------------------------------------------------------

    def parse_app(self) -> SiddhiApp:
        app = SiddhiApp()
        while self.at("@") and self._is_app_annotation():
            app.annotations.append(self._app_annotation())
        while True:
            while self.accept(";"):
                pass
            if self.at("EOF"):
                break
            anns = self._annotations()
            if self.at_kw("define"):
                self._definition(app, anns)
            elif self.at_kw("partition"):
                app.add_partition(self._partition(anns))
            elif self.at_kw("from"):
                app.add_query(self._query(anns))
            else:
                raise self.err(f"unexpected token {self.peek().text!r}")
        return app

    def _is_app_annotation(self) -> bool:
        # @app:name(...)  (reference: app_annotation rule)
        return self.peek(1).type == "ID" and self.peek(1).text.lower() == "app" and self.peek(2).type == ":"

    def _app_annotation(self) -> Annotation:
        self.expect("@")
        self.expect_kw("app")
        self.expect(":")
        name = "app:" + self.name()
        elements = []
        if self.accept("("):
            if not self.at(")"):
                elements.append(self._annotation_element())
                while self.accept(","):
                    elements.append(self._annotation_element())
            self.expect(")")
        return Annotation(name, elements)

    def _annotations(self) -> list[Annotation]:
        anns = []
        while self.at("@"):
            anns.append(self._annotation())
        return anns

    def _annotation(self) -> Annotation:
        self.expect("@")
        name = self.name()
        if self.accept(":"):  # namespaced like @sink:ns? (grammar: name only, but @app:x covered)
            name = f"{name}:{self.name()}"
        elements: list = []
        nested: list[Annotation] = []
        if self.accept("("):
            if not self.at(")"):
                while True:
                    if self.at("@"):
                        nested.append(self._annotation())
                    else:
                        elements.append(self._annotation_element())
                    if not self.accept(","):
                        break
            self.expect(")")
        return Annotation(name, elements, nested)

    def _annotation_element(self) -> tuple[Optional[str], str]:
        # (property_name '=')? property_value ; property_name can be dotted
        if self.peek().type in ("ID", "QID"):
            # property name path: name (sep name)* '='
            start = self.pos
            parts = [self.name()]
            while self.peek().type in (".", "-", ":") and self.peek(1).type in ("ID", "QID"):
                sep = self.next().type
                parts.append(sep + self.name())
            if self.accept("="):
                return ("".join(parts), self._property_value())
            self.pos = start
        return (None, self._property_value())

    def _property_value(self) -> str:
        t = self.peek()
        if t.type == "STRING":
            self.next()
            return t.text
        if t.type in ("INT", "LONG", "FLOAT", "DOUBLE"):
            self.next()
            return str(t.value)
        if t.type in ("ID", "QID"):
            self.next()
            return t.text
        raise self.err(f"expected annotation value, found {t.text!r}")

    # ---- definitions -----------------------------------------------------

    def _definition(self, app: SiddhiApp, anns: list[Annotation]) -> None:
        def_tok = self.peek()
        self.expect_kw("define")
        kind = self.expect_kw(
            "stream", "table", "window", "trigger", "function", "aggregation"
        ).text.lower()
        if kind == "stream":
            d = StreamDefinition(self.name(), self._attr_list(), anns)
            app.define_stream(self.stamp(d, def_tok))
        elif kind == "table":
            d = TableDefinition(self.name(), self._attr_list(), anns)
            app.define_table(self.stamp(d, def_tok))
        elif kind == "window":
            wid = self.name()
            attrs = self._attr_list()
            spec_tok = self.peek()
            ns, fname, params = self._function_operation()
            out = "all"
            if self.accept_kw("output"):
                out = self._output_event_type().value.split()[0]
            spec = self.stamp(WindowSpec(ns, fname, params), spec_tok)
            app.define_window(self.stamp(
                WindowDefinition(wid, attrs, anns, window=spec, output_events=out),
                def_tok,
            ))
        elif kind == "trigger":
            tid = self.name()
            self.expect_kw("at")
            if self.accept_kw("every"):
                ms = self._time_value()
                app.define_trigger(self.stamp(
                    TriggerDefinition(tid, at_every_ms=ms, annotations=anns), def_tok
                ))
            else:
                s = self.expect("STRING").text
                if s.lower() == "start":
                    app.define_trigger(self.stamp(
                        TriggerDefinition(tid, at_start=True, annotations=anns), def_tok
                    ))
                else:
                    app.define_trigger(self.stamp(
                        TriggerDefinition(tid, at_cron=s, annotations=anns), def_tok
                    ))
        elif kind == "function":
            fid = self.name()
            self.expect("[")
            lang = self.name()
            self.expect("]")
            self.expect_kw("return")
            rt = self._attr_type()
            body = self.expect("SCRIPT").text
            app.define_function(self.stamp(
                FunctionDefinition(fid, lang, rt, body, anns), def_tok
            ))
        else:  # aggregation
            aid = self.name()
            self.expect_kw("from")
            stream = self._standard_stream()
            selector = self._query_section(group_by_only=True)
            self.expect_kw("aggregate")
            by = None
            if self.accept_kw("by"):
                by = self._attribute_reference()
            self.expect_kw("every")
            period = self._aggregation_time()
            app.define_aggregation(self.stamp(
                AggregationDefinition(aid, stream, selector, by, period, anns),
                def_tok,
            ))

    def _attr_list(self) -> list[Attribute]:
        self.expect("(")
        tok = self.peek()
        attrs = [self.stamp(Attribute(self.name(), self._attr_type()), tok)]
        while self.accept(","):
            tok = self.peek()
            attrs.append(self.stamp(Attribute(self.name(), self._attr_type()), tok))
        self.expect(")")
        return attrs

    def _attr_type(self) -> AttrType:
        t = self.expect_kw(*_TYPES)
        return _TYPES[t.text.lower()]

    def _aggregation_time(self) -> TimePeriod:
        d1 = _DURATIONS.get(self.name().lower())
        if d1 is None:
            raise self.err("expected aggregation duration")
        if self.accept("..."):
            d2 = _DURATIONS.get(self.name().lower())
            if d2 is None:
                raise self.err("expected aggregation duration")
            return TimePeriod.range(d1, d2)
        durations = [d1]
        while self.accept(","):
            d = _DURATIONS.get(self.name().lower())
            if d is None:
                raise self.err("expected aggregation duration")
            durations.append(d)
        return TimePeriod(durations)

    # ---- partition -------------------------------------------------------

    def _partition(self, anns: list[Annotation]) -> Partition:
        part_tok = self.peek()
        self.expect_kw("partition")
        self.expect_kw("with")
        self.expect("(")
        part = self.stamp(Partition(annotations=anns), part_tok)
        part.partition_types.append(self._partition_with())
        while self.accept(","):
            part.partition_types.append(self._partition_with())
        self.expect(")")
        self.expect_kw("begin")
        while True:
            while self.accept(";"):
                pass
            if self.at_kw("end"):
                break
            q_anns = self._annotations()
            part.queries.append(self._query(q_anns))
        self.expect_kw("end")
        return part

    def _partition_with(self):
        start = self.pos
        start_tok = self.peek()
        expr = self._expression()
        if self.at_kw("as") or self.at_kw("or"):
            # range partition: expr as 'name' (or ...)* of Stream
            self.pos = start
            ranges = []
            while True:
                cond = self._expression()
                self.expect_kw("as")
                label = self.expect("STRING").text
                ranges.append(RangePartitionProperty(label, cond))
                if not self.accept_kw("or"):
                    break
            self.expect_kw("of")
            return self.stamp(RangePartitionType(self.name(), ranges), start_tok)
        self.expect_kw("of")
        return self.stamp(ValuePartitionType(self.name(), expr), start_tok)

    # ---- query -----------------------------------------------------------

    def _query(self, anns: list[Annotation]) -> Query:
        from_tok = self.peek()
        self.expect_kw("from")
        q = self.stamp(Query(annotations=anns), from_tok)
        q.input_stream = self._query_input()
        if self.at_kw("select"):
            q.selector = self._query_section()
        else:
            q.selector = Selector(select_all=True)
        q.output_rate = self._output_rate()
        out_tok = self.peek()
        q.output_stream = self.stamp(self._query_output(), out_tok)
        return q

    def _query_input(self):
        kind = self._classify_input()
        if kind == "pattern":
            return self._state_stream(StateStreamType.PATTERN)
        if kind == "sequence":
            return self._state_stream(StateStreamType.SEQUENCE)
        if kind == "join":
            return self._join_stream()
        return self._standard_stream()

    def _classify_input(self) -> str:
        """Look ahead to decide standard / join / pattern / sequence
        (replaces ANTLR's unbounded-lookahead alternatives)."""
        # brackets hide filter expressions entirely; parens only hide
        # pattern-irrelevant commas (function args) — arrows/aliases inside a
        # parenthesized state block (`(every e1=... -> e2=...) within ...`)
        # still classify as a pattern
        par = 0
        sq = 0
        i = self.pos
        toks = self.toks
        saw_arrow = saw_comma = saw_join = saw_logical = saw_assign = False
        starts_every_or_not = toks[i].type == "ID" and toks[i].text.lower() in ("every", "not")
        while i < len(toks):
            t = toks[i]
            if t.type == "(":
                par += 1
            elif t.type == ")":
                par -= 1
                if par < 0:
                    break
            elif t.type == "[":
                sq += 1
            elif t.type == "]":
                sq -= 1
                if sq < 0:
                    break
            elif sq == 0:
                if t.type == "->":
                    saw_arrow = True
                elif t.type == "," and par == 0:
                    saw_comma = True
                elif t.type == "=":
                    saw_assign = True
                elif t.type == "ID" and par == 0:
                    low = t.text.lower()
                    if low in ("select", "output", "insert", "delete", "update", "return"):
                        break
                    if low == "join" or (
                        low in ("left", "right", "full", "inner", "outer")
                        and i + 1 < len(toks)
                    ):
                        if low == "join":
                            saw_join = True
                    elif low in ("and", "or"):
                        saw_logical = True
            i += 1
        if saw_join:
            # JOIN at depth 0 can only be a join query (filters keep and/or and
            # commas inside brackets; aggregation joins add within-clause commas)
            return "join"
        if saw_comma and (saw_arrow or saw_assign or starts_every_or_not or saw_logical):
            return "sequence"
        if saw_arrow or saw_assign or starts_every_or_not or saw_logical:
            return "pattern"
        if saw_comma:
            return "sequence"
        return "standard"

    # --- standard stream

    def _standard_stream(self) -> SingleInputStream:
        s = self._source()
        self._stream_handlers(s)
        return s

    def _source(self) -> SingleInputStream:
        tok = self.peek()
        inner = bool(self.accept("#"))
        # `!S` consumes S's fault stream (reference: SiddhiQL.g4 fault streams,
        # keyed internally under the '!'-prefixed id)
        fault = False if inner else bool(self.accept("!"))
        name = self.name()
        return self.stamp(
            SingleInputStream(
                ("!" + name) if fault else name, is_inner=inner, is_fault=fault
            ),
            tok,
        )

    def _stream_handlers(self, s: SingleInputStream) -> None:
        while True:
            tok = self.peek()
            if self.at("["):
                self.next()
                s.handlers.append(self.stamp(Filter(self._expression()), tok))
                self.expect("]")
            elif self.at("#"):
                # '#window.x(...)' | '#ns:func(...)' | '#func(...)' | '#[filter]'
                nxt = self.peek(1)
                if nxt.type == "[":
                    self.next()
                    continue
                if nxt.type != "ID":
                    break
                self.next()
                if self.at_kw("window") and self.peek(1).type == ".":
                    self.next()
                    self.next()
                    spec_tok = self.peek()
                    ns, name, params = self._function_operation()
                    spec = self.stamp(WindowSpec(ns, name, params), spec_tok)
                    s.handlers.append(self.stamp(WindowHandler(spec), tok))
                else:
                    ns, name, params = self._function_operation()
                    s.handlers.append(
                        self.stamp(StreamFunctionHandler(ns, name, params), tok)
                    )
            else:
                break

    # --- join

    def _join_stream(self) -> JoinInputStream:
        left, l_uni = self._join_source()
        jt = self._join_kind()
        right, r_uni = self._join_source()
        uni = "left" if l_uni else ("right" if r_uni else None)
        on = within = per = None
        if self.accept_kw("on"):
            on = self._expression()
        if self.accept_kw("within"):
            within = self._expression()
            if self.accept(","):
                # within start, end — packed as a pair by the aggregation-join layer
                end = self._expression()
                within = AttributeFunction(None, "__within_range__", [within, end])
        if self.accept_kw("per"):
            per = self._expression()
        return JoinInputStream(left, jt, right, on=on, within=within, per=per, unidirectional=uni)

    def _join_source(self) -> tuple[SingleInputStream, bool]:
        s = self._source()
        self._stream_handlers(s)
        if self.accept_kw("as"):
            s.alias = self.name()
        uni = bool(self.accept_kw("unidirectional"))
        return s, uni

    def _join_kind(self) -> JoinType:
        if self.accept_kw("join"):
            return JoinType.JOIN
        if self.accept_kw("inner"):
            self.expect_kw("join")
            return JoinType.JOIN
        if self.accept_kw("left"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.LEFT_OUTER
        if self.accept_kw("right"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.RIGHT_OUTER
        if self.accept_kw("full"):
            self.expect_kw("outer")
            self.expect_kw("join")
            return JoinType.FULL_OUTER
        if self.accept_kw("outer"):
            self.expect_kw("join")
            return JoinType.FULL_OUTER
        raise self.err("expected join")

    # --- pattern / sequence

    def _state_stream(self, kind: StateStreamType) -> StateInputStream:
        sep = "->" if kind is StateStreamType.PATTERN else ","
        elem = self._state_chain(sep)
        within = None
        if self.accept_kw("within"):
            within = self._time_value()
        return StateInputStream(kind, elem, within_ms=within)

    def _state_chain(self, sep: str) -> StateElement:
        elem = self._state_term(sep)
        while self.at(sep):
            tok = self.next()
            nxt = self._state_term(sep)
            elem = self.stamp(NextStateElement(elem, nxt), tok)
        return elem

    def _state_term(self, sep: str) -> StateElement:
        tok = self.peek()
        every = bool(self.accept_kw("every"))
        if self.accept("("):
            inner = self._state_chain(sep)
            self.expect(")")
            elem = inner
        else:
            elem = self._pattern_source(sep)
        if every:
            elem = self.stamp(EveryStateElement(elem), tok)
        if self.at_kw("within"):
            self.next()
            elem.within_ms = self._time_value()
        return elem

    def _pattern_source(self, sep: str) -> StateElement:
        left = self._single_or_absent(sep)
        if self.at_kw("and", "or"):
            tok = self.peek()
            op = LogicalType(self.next().text.lower())
            right = self._single_or_absent(sep)
            return self.stamp(LogicalStateElement(left, op, right), tok)
        return left

    def _single_or_absent(self, sep: str) -> StateElement:
        # absent source: not S[...] (for t)?  — absent may appear on either or
        # both sides of a logical element (reference: logical_absent_stateful)
        tok = self.peek()
        if self.accept_kw("not"):
            s = self._basic_source()
            waiting = None
            if self.accept_kw("for"):
                waiting = self._time_value()
            return self.stamp(
                AbsentStreamStateElement(stream=s, waiting_time_ms=waiting), tok
            )
        return self._pattern_single(sep)

    def _pattern_single(self, sep: str) -> StateElement:
        # (event '=')? basic_source ('<' collect '>' | * + ?)?
        tok = self.peek()
        alias = None
        if (
            self.peek().type in ("ID", "QID")
            and self.peek(1).type == "="
            and self.peek(2).type != "="
        ):
            alias = self.name()
            self.next()  # '='
        s = self._basic_source()
        s.alias = alias
        elem = self.stamp(StreamStateElement(stream=s), tok)
        if self.at("<"):
            self.next()
            mn, mx = self._collect()
            self.expect(">")
            return self.stamp(CountStateElement(elem, mn, mx), tok)
        if sep == "," and self.peek().type in ("*", "+", "?"):
            suffix = self.next().type
            if suffix == "*":
                return self.stamp(CountStateElement(elem, 0, CountStateElement.ANY), tok)
            if suffix == "+":
                return self.stamp(CountStateElement(elem, 1, CountStateElement.ANY), tok)
            return self.stamp(CountStateElement(elem, 0, 1), tok)
        return elem

    def _basic_source(self) -> SingleInputStream:
        s = self._source()
        # only filters/stream functions (no windows) on pattern sources
        while True:
            tok = self.peek()
            if self.at("["):
                self.next()
                s.handlers.append(self.stamp(Filter(self._expression()), tok))
                self.expect("]")
            elif self.at("#") and self.peek(1).type == "ID":
                self.next()
                ns, name, params = self._function_operation()
                s.handlers.append(
                    self.stamp(StreamFunctionHandler(ns, name, params), tok)
                )
            else:
                break
        return s

    def _collect(self) -> tuple[int, int]:
        mn = mx = CountStateElement.ANY
        if self.at("INT"):
            mn = int(self.next().value)
            if self.accept(":"):
                if self.at("INT"):
                    mx = int(self.next().value)
            else:
                mx = mn
        elif self.accept(":"):
            mn = 0
            mx = int(self.expect("INT").value)
        if mn == CountStateElement.ANY:
            mn = 0
        return mn, mx

    # --- selector

    def _query_section(self, group_by_only: bool = False) -> Selector:
        sel_tok = self.peek()
        self.expect_kw("select")
        sel = self.stamp(Selector(), sel_tok)
        if self.accept("*"):
            sel.select_all = True
        else:
            sel.selection_list.append(self._output_attribute())
            while self.accept(","):
                sel.selection_list.append(self._output_attribute())
        if self.at_kw("group"):
            self.next()
            self.expect_kw("by")
            sel.group_by.append(self._attribute_reference())
            while self.accept(","):
                sel.group_by.append(self._attribute_reference())
        if group_by_only:
            return sel
        if self.accept_kw("having"):
            sel.having = self._expression()
        if self.at_kw("order"):
            self.next()
            self.expect_kw("by")
            while True:
                v = self._attribute_reference()
                order = OrderDir.ASC
                if self.at_kw("asc", "desc"):
                    order = OrderDir(self.next().text.lower())
                sel.order_by.append(OrderByAttribute(v, order))
                if not self.accept(","):
                    break
        if self.accept_kw("limit"):
            c = self._expression()
            sel.limit = _const_int(c, self.err)
        if self.accept_kw("offset"):
            c = self._expression()
            sel.offset = _const_int(c, self.err)
        return sel

    def _output_attribute(self) -> OutputAttribute:
        tok = self.peek()
        e = self._expression()
        rename = None
        if self.accept_kw("as"):
            rename = self.name()
        return self.stamp(OutputAttribute(rename, e), tok)

    # --- output rate & output

    def _output_rate(self):
        if not self.at_kw("output"):
            return None
        # `output` may begin the rate clause OR nothing (outputs are insert/..)
        nxt = self.peek(1)
        if not (
            (nxt.type == "ID" and nxt.text.lower() in ("all", "first", "last", "every", "snapshot"))
        ):
            return None
        self.next()
        if self.accept_kw("snapshot"):
            self.expect_kw("every")
            return SnapshotOutputRate(self._time_value())
        rtype = OutputRateType.ALL
        if self.at_kw("all", "first", "last"):
            rtype = OutputRateType(self.next().text.lower())
        self.expect_kw("every")
        if self.at("INT") and self.peek(1).type == "ID" and self.peek(1).text.lower() in ("events", "event"):
            nvalue = int(self.next().value)
            self.next()
            return EventOutputRate(nvalue, rtype)
        return TimeOutputRate(self._time_value(), rtype)

    def _query_output(self):
        if self.accept_kw("insert"):
            out_for = OutputEventsFor.CURRENT
            if self.at_kw("all", "expired", "current"):
                out_for = self._output_event_type()
            elif self.at_kw("events"):
                self.next()
            self.expect_kw("into")
            inner = bool(self.accept("#"))
            fault = False if inner else bool(self.accept("!"))
            name = self.name()
            return InsertIntoStream(
                out_for,
                ("!" + name) if fault else name,
                is_inner=inner,
                is_fault=fault,
            )
        if self.accept_kw("delete"):
            target = self.name()
            out_for = OutputEventsFor.CURRENT
            if self.accept_kw("for"):
                out_for = self._output_event_type()
            self.expect_kw("on")
            return DeleteStream(out_for, target, on=self._expression())
        if self.accept_kw("update"):
            if self.accept_kw("or"):
                self.expect_kw("insert")
                self.expect_kw("into")
                cls = UpdateOrInsertStream
            else:
                cls = UpdateStream
            target = self.name()
            out_for = OutputEventsFor.CURRENT
            if self.accept_kw("for"):
                out_for = self._output_event_type()
            set_attrs = self._set_clause()
            self.expect_kw("on")
            return cls(out_for, target, on=self._expression(), set_attributes=set_attrs)
        if self.accept_kw("return"):
            out_for = OutputEventsFor.CURRENT
            if self.at_kw("all", "expired", "current", "events"):
                out_for = self._output_event_type()
            return ReturnStream(out_for)
        # bare query (no output clause) returns
        return ReturnStream()

    def _set_clause(self):
        if not self.at_kw("set"):
            return None
        self.next()
        out = []
        while True:
            v = self._attribute_reference()
            self.expect("=")
            out.append(UpdateSetAttribute(v, self._expression()))
            if not self.accept(","):
                break
        return out

    def _output_event_type(self) -> OutputEventsFor:
        if self.accept_kw("all"):
            self.expect_kw("events")
            return OutputEventsFor.ALL
        if self.accept_kw("expired"):
            self.expect_kw("events")
            return OutputEventsFor.EXPIRED
        self.accept_kw("current")
        self.expect_kw("events")
        return OutputEventsFor.CURRENT

    # ---- store query -----------------------------------------------------

    def parse_store_query(self) -> StoreQuery:
        sq = StoreQuery()
        self.stamp(sq, self.peek())
        if self.accept_kw("from"):
            store_tok = self.peek()
            store_id = self.name()
            store = self.stamp(InputStore(store_id), store_tok)
            if self.accept_kw("as"):
                store.alias = self.name()
            if self.accept_kw("on"):
                store.on = self._expression()
            if self.accept_kw("within"):
                start = self._expression()
                end = None
                if self.accept(","):
                    end = self._expression()
                store.within = (start, end)
            if self.accept_kw("per"):
                store.per = self._expression()
            sq.input_store = store
            if self.at_kw("select"):
                sq.selector = self._query_section()
            else:
                sq.selector = Selector(select_all=True)
            if self.at_kw("update", "delete", "insert"):
                sq.output_stream = self._query_output()
        else:
            sq.selector = self._query_section()
            sq.output_stream = self._query_output()
        self.accept(";")
        self.expect("EOF")
        return sq

    # ---- expressions -----------------------------------------------------

    def _expression(self) -> Expression:
        return self._or_expr()

    def _or_expr(self) -> Expression:
        e = self._and_expr()
        while self.at_kw("or"):
            tok = self.next()
            e = self.stamp(Or(e, self._and_expr()), tok)
        return e

    def _and_expr(self) -> Expression:
        e = self._in_expr()
        while self.at_kw("and"):
            tok = self.next()
            e = self.stamp(And(e, self._in_expr()), tok)
        return e

    def _in_expr(self) -> Expression:
        e = self._equality()
        while self.at_kw("in"):
            tok = self.next()
            e = self.stamp(In(e, self.name()), tok)
        return e

    def _equality(self) -> Expression:
        e = self._relational()
        while self.peek().type in ("==", "!="):
            tok = self.next()
            op = CompareOp(tok.type)
            e = self.stamp(Compare(e, op, self._relational()), tok)
        return e

    def _relational(self) -> Expression:
        e = self._additive()
        while self.peek().type in ("<", "<=", ">", ">="):
            tok = self.next()
            op = CompareOp(tok.type)
            e = self.stamp(Compare(e, op, self._additive()), tok)
        return e

    def _additive(self) -> Expression:
        e = self._multiplicative()
        while self.peek().type in ("+", "-"):
            tok = self.next()
            rhs = self._multiplicative()
            e = self.stamp(Add(e, rhs) if tok.type == "+" else Subtract(e, rhs), tok)
        return e

    def _multiplicative(self) -> Expression:
        e = self._unary()
        while self.peek().type in ("*", "/", "%"):
            tok = self.next()
            rhs = self._unary()
            e = self.stamp({"*": Multiply, "/": Divide, "%": Mod}[tok.type](e, rhs), tok)
        return e

    def _unary(self) -> Expression:
        if self.at_kw("not"):
            tok = self.next()
            return self.stamp(Not(self._unary()), tok)
        if self.peek().type in ("-", "+"):
            sign = self.next().type
            t = self.peek()
            if t.type not in ("INT", "LONG", "FLOAT", "DOUBLE"):
                raise self.err("expected numeric literal after unary sign")
            e = self._primary()
            if sign == "-":
                assert isinstance(e, Constant)
                e.value = -e.value
            return e
        return self._primary()

    def _primary(self) -> Expression:
        t = self.peek()
        if t.type == "(":
            self.next()
            e = self._expression()
            self.expect(")")
            return self._maybe_is_null(e)
        if t.type == "INT":
            # time constant? INT followed by a time unit identifier
            if self.peek(1).type == "ID" and self.peek(1).text.lower() in TIME_UNITS:
                return self.stamp(TimeConstant(self._time_value()), t)
            self.next()
            return self.stamp(Constant(int(t.value), AttrType.INT), t)
        if t.type == "LONG":
            self.next()
            return self.stamp(Constant(int(t.value), AttrType.LONG), t)
        if t.type == "FLOAT":
            self.next()
            return self.stamp(Constant(float(t.value), AttrType.FLOAT), t)
        if t.type == "DOUBLE":
            self.next()
            return self.stamp(Constant(float(t.value), AttrType.DOUBLE), t)
        if t.type == "STRING":
            self.next()
            return self.stamp(Constant(t.text, AttrType.STRING), t)
        if t.type in ("ID", "QID", "#"):
            low = t.text.lower() if t.type == "ID" else ""
            if low == "true":
                self.next()
                return self.stamp(Constant(True, AttrType.BOOL), t)
            if low == "false":
                self.next()
                return self.stamp(Constant(False, AttrType.BOOL), t)
            if low == "null":
                self.next()
                return self.stamp(Constant(None, AttrType.OBJECT), t)
            return self._maybe_is_null(self._ref_or_function())
        raise self.err(f"unexpected token {t.text!r} in expression")

    def _maybe_is_null(self, e: Expression) -> Expression:
        if self.at_kw("is") and self.peek(1).type == "ID" and self.peek(1).text.lower() == "null":
            tok = self.next()
            self.next()
            if isinstance(e, Variable) and e.stream_id is not None and e.attribute == "":
                # explicit stream reference form: `e1[0] is null`
                return self.stamp(
                    IsNull(stream_id=e.stream_id, stream_index=e.stream_index), tok
                )
            if isinstance(e, Variable) and e.stream_id is None:
                # bare `name is null` is ambiguous: attribute or pattern state
                # alias. Keep both readings; the compile layer prefers a state
                # alias when one matches (reference null_check rule has the
                # same ambiguity resolved in the visitor).
                return self.stamp(IsNull(expression=e, stream_id=e.attribute), tok)
            return self.stamp(IsNull(expression=e), tok)
        return e

    def _ref_or_function(self) -> Expression:
        # function: (ns ':')? name '(' ... ')'
        if self.peek().type in ("ID", "QID"):
            tok = self.peek()
            if self.peek(1).type == "(":
                fname = self.name()
                return self.stamp(self._finish_function(None, fname), tok)
            if (
                self.peek(1).type == ":"
                and self.peek(2).type in ("ID", "QID")
                and self.peek(3).type == "("
            ):
                ns = self.name()
                self.next()
                fname = self.name()
                return self.stamp(self._finish_function(ns, fname), tok)
        return self._attribute_reference(allow_stream_ref=True)

    def _finish_function(self, ns: Optional[str], fname: str) -> Expression:
        self.expect("(")
        params: list[Expression] = []
        if not self.at(")"):
            if self.accept("*"):
                pass  # count(*) style — no parameters
            else:
                params.append(self._expression())
                while self.accept(","):
                    params.append(self._expression())
        self.expect(")")
        return AttributeFunction(ns, fname, params)

    def _attribute_reference(self, allow_stream_ref: bool = False) -> Variable:
        # [#]name[idx][#name2[idx2]].attr | attr
        tok = self.peek()
        inner = bool(self.accept("#"))
        name1 = self.name()
        idx = None
        if self.at("["):
            self.next()
            idx = self._attribute_index()
            self.expect("]")
        if self.accept("#"):
            # partition inner-stream double ref: name1#name2 — keep last part
            name2 = self.name()
            if self.at("["):
                self.next()
                idx = self._attribute_index()
                self.expect("]")
            name1 = f"{name1}#{name2}"
        if self.accept("."):
            attr = self.name()
            return self.stamp(
                Variable(attr, stream_id=name1, stream_index=idx, is_inner=inner), tok
            )
        if idx is not None:
            # indexed bare stream reference (only meaningful before IS NULL)
            return self.stamp(
                Variable("", stream_id=name1, stream_index=idx, is_inner=inner), tok
            )
        return self.stamp(Variable(name1, is_inner=inner), tok)

    def _attribute_index(self) -> int:
        if self.at("INT"):
            return int(self.next().value)
        t = self.expect_kw("last")
        if self.accept("-"):
            return Variable.LAST - int(self.expect("INT").value)
        return Variable.LAST

    # ---- time ------------------------------------------------------------

    def _time_value(self) -> int:
        total = 0
        seen = False
        while self.at("INT") and self.peek(1).type == "ID" and self.peek(1).text.lower() in TIME_UNITS:
            n = int(self.next().value)
            unit = self.next().text.lower()
            total += n * TIME_UNITS[unit]
            seen = True
        if not seen:
            raise self.err("expected time value (e.g. `5 sec`)")
        return total

    def _function_operation(self) -> tuple[Optional[str], str, list[Expression]]:
        name1 = self.name()
        ns = None
        if self.accept(":"):
            ns = name1
            name1 = self.name()
        self.expect("(")
        params: list[Expression] = []
        if not self.at(")"):
            if self.accept("*"):
                pass
            else:
                params.append(self._expression())
                while self.accept(","):
                    params.append(self._expression())
        self.expect(")")
        return ns, name1, params


def _const_int(e: Expression, err) -> int:
    if isinstance(e, Constant) and isinstance(e.value, int):
        return int(e.value)
    raise err("expected integer constant")
