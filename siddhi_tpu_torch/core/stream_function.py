"""Stream functions / stream processors: chain stages that append attributes.

Reference: query/processor/stream/function/StreamFunctionProcessor.java +
Pol2CartStreamFunctionProcessor.java (appends cartesian x/y), and
query/processor/stream/LogStreamProcessor.java (event tracing pass-through).
Custom ones register via @extension("stream_function", name): factory
`(params: list[CompiledExpr], schema_attrs, ref, scope) -> StreamFunctionStage`.
Script functions (`define function f[python] return type { body }`) compile
into expression factories registered as functions.
"""

from __future__ import annotations

import dataclasses
import logging
import textwrap
import types
from typing import Callable

import numpy as np
import torch

from siddhi_tpu_torch.core.errors import SiddhiAppCreationError
from siddhi_tpu_torch.core.executor import CompiledExpr, Env, Scope, compile_expression
from siddhi_tpu_torch.core.extension import lookup
from siddhi_tpu_torch.core.flow import Flow
from siddhi_tpu_torch.core.types import PHYSICAL_DTYPE, AttrType, convert_to, float_arith
from siddhi_tpu_torch.query_api.expression import Constant

# degrees to radians in float32, as jnp.deg2rad multiplies (a 0-d scalar)
_DEG = torch.tensor(np.float32(np.pi / 180))


class StreamFunctionStage:
    """Appends computed attribute columns to the flowing batch
    (reference: StreamFunctionProcessor.process attaching outputData)."""

    def __init__(self, ref: str, new_attrs: list[tuple[str, AttrType]],
                 fn: Callable[[Env], dict[str, torch.Tensor]]):
        self.ref = ref
        self.new_attrs = new_attrs
        self.fn = fn

    def apply(self, flow: Flow) -> Flow:
        new_cols = self.fn(flow.env())
        cols = dict(flow.batch.cols)
        shape = flow.batch.valid.shape
        for name, t in self.new_attrs:
            cols[name] = convert_to(new_cols[name], PHYSICAL_DTYPE[t]).expand(shape).contiguous()
        return dataclasses.replace(flow, batch=dataclasses.replace(flow.batch, cols=cols))


class LogStage:
    """#log([priority,] message) — host-side event tracing (reference:
    LogStreamProcessor): the valid rows' timestamps are copied to the host
    and logged to `siddhi_tpu_torch.log.<stream>`."""

    new_attrs: list = []

    def __init__(self, ref: str, message: str, stream_id: str):
        self.ref = ref
        self.message = message
        self.logger = logging.getLogger(f"siddhi_tpu_torch.log.{stream_id}")

    def apply(self, flow: Flow) -> Flow:
        if self.logger.isEnabledFor(logging.INFO):
            valid = flow.batch.valid.cpu()
            n = int(valid.sum())
            if n:
                self.logger.info("%s : %d event(s), ts=%s", self.message, n,
                                 flow.batch.ts.cpu()[valid].tolist())
        return flow


def make_stream_function(handler, schema_attrs: dict[str, AttrType], ref: str, scope: Scope,
                         stream_id: str):
    """Dispatch a #ns:name(params) handler to a built-in or extension stage."""
    name = (f"{handler.namespace}:{handler.name}" if handler.namespace else handler.name).lower()

    if name == "log":
        msg = "LOG"
        for p in handler.parameters:
            if isinstance(p, Constant) and isinstance(p.value, str):
                msg = p.value
        return LogStage(ref, msg, stream_id)

    if name == "pol2cart":
        params = [compile_expression(p, scope) for p in handler.parameters]
        if len(params) not in (2, 3):
            raise SiddhiAppCreationError("pol2Cart(theta, rho[, z]) needs 2-3 args")

        def fn(env: Env, _p=params):
            # float32 products with subnormals as zeros (core/types.py
            # float_arith), as jnp's under XLA's CPU code
            theta = float_arith("mul", _p[0](env).to(torch.float32), _DEG, True, False)
            rho = _p[1](env).to(torch.float32)
            out = {"x": float_arith("mul", rho, torch.cos(theta), True, False),
                   "y": float_arith("mul", rho, torch.sin(theta), True, False)}
            if len(_p) > 2:
                out["z"] = _p[2](env).to(torch.float32)
            return out

        attrs = [("x", AttrType.DOUBLE), ("y", AttrType.DOUBLE)]
        if len(params) > 2:
            attrs.append(("z", AttrType.DOUBLE))
        return StreamFunctionStage(ref, attrs, fn)

    ext = lookup("stream_function", name) or lookup("stream_processor", name)
    if ext is not None:
        params = [compile_expression(p, scope) for p in handler.parameters]
        return ext(params, schema_attrs, ref, scope)

    raise SiddhiAppCreationError(f"unknown stream function '#{name}'")


# ---------------------------------------------------------------------------
# script functions: define function f[python] return type { body }
# ---------------------------------------------------------------------------


def _names(code: types.CodeType) -> set:
    out = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            out |= _names(c)
    return out


def make_script_function(fdef):
    """Compile a `define function` body into an expression-compiler factory
    (reference: FunctionDefinition + script executors; the reference ships
    JavaScript/R/Scala via extensions — here the language is python, run
    over the argument tensors `data` with `torch` and `np` in scope)."""
    lang = fdef.language.lower()
    if lang not in ("python", "py"):
        raise SiddhiAppCreationError(
            f"function '{fdef.id}': unsupported script language "
            f"'{fdef.language}' (python is built in)")
    body = textwrap.dedent(fdef.body).strip()
    if "return" not in body:
        body = f"return {body}"
    src = "def __fn__(data):\n" + textwrap.indent(body, "    ")
    code = compile(src, f"<function {fdef.id}>", "exec")
    if "jnp" in _names(code):
        raise SiddhiAppCreationError(
            f"function '{fdef.id}': a script body using jnp is not ported yet "
            "(write it with torch)")
    ns: dict = {}
    exec(code, {"torch": torch, "np": np}, ns)
    raw = ns["__fn__"]
    rt = fdef.return_type

    def factory(params: list[CompiledExpr], scope: Scope) -> CompiledExpr:
        def fn(env: Env) -> torch.Tensor:
            vals = [p(env) for p in params]
            return convert_to(torch.as_tensor(raw(vals), device=scope.device), PHYSICAL_DTYPE[rt])

        return CompiledExpr(rt, fn)

    return factory
