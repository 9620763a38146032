"""Static SiddhiQL parse entry points.

Reference: siddhi-query-compiler .../SiddhiCompiler.java:57-192 — one entry per
construct (app, query, store query, expression, time constant, definitions).
"""

from __future__ import annotations

from siddhi_tpu_torch.compiler.parser import Parser
from siddhi_tpu_torch.query_api.execution import Query, StoreQuery
from siddhi_tpu_torch.query_api.expression import Expression
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


class SiddhiCompiler:
    @staticmethod
    def parse(source: str) -> SiddhiApp:
        return Parser(source).parse_app()

    @staticmethod
    def parse_query(source: str) -> Query:
        p = Parser(source)
        anns = p._annotations()
        q = p._query(anns)
        p.accept(";")
        p.expect("EOF")
        return q

    @staticmethod
    def parse_store_query(source: str) -> StoreQuery:
        return Parser(source).parse_store_query()

    @staticmethod
    def parse_expression(source: str) -> Expression:
        p = Parser(source)
        e = p._expression()
        p.expect("EOF")
        return e

    @staticmethod
    def parse_time_constant(source: str) -> int:
        p = Parser(source)
        ms = p._time_value()
        p.expect("EOF")
        return ms
