"""Float to int and long as XLA converts them, through both packages on the
CPU. XLA's conversion (the JAX package's `astype`) maps NaN to 0, saturates
at the target's range (so a value at or below its minimum is that type's
null) and truncates toward zero within it; the port converts so
(`core/types.py` `convert_to`; on the card `csrc/prog.cuh` `float_to_int`).

- `convert_to` and the executor's `cast`/`convert` to int and long over NaN,
  +-inf, +-3e9, +-1e19, +-2^31, +-2^63, the largest floats below them, +-0.0,
  subnormals and ordinary values, from float32 and float64, against
  `jnp.astype` under `jit`, bit for bit.
- Apps through `siddhi_tpu.SiddhiManager()` and
  `siddhi_tpu_torch.SiddhiManager(device="cpu")`, one event a send: the
  four-event conversion app, a filter on `convert(f, 'int') > 0`, a
  `sum(convert(f, 'int'))`, a table filled by `convert`, and script
  functions declared `return int` and `return long`; rows equal, in order.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler  # noqa: E402
from siddhi_tpu_torch.core.executor import Env, Scope, compile_expression  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType, InternTable, convert_to  # noqa: E402

TINY = np.finfo(np.float32).tiny
VALUES = [np.nan, -np.nan, np.inf, -np.inf, 3e9, -3e9, 1e19, -1e19, 2.0**31, -(2.0**31),
          2.0**63, -(2.0**63), 2147483520.0, -2147483520.0, 2147483647.0, 9.2233715e18,
          -9.2233715e18, 0.0, -0.0, 1e-40, -1e-40, TINY, 0.5, -0.5, 1.5, -1.5, 2.9, -2.9,
          123456.78, -98765.4, 16777217.0, 1e10, -1e10]


@pytest.mark.parametrize("src", ["float32", "float64"])
@pytest.mark.parametrize("dst", ["int32", "int64"])
def test_convert_to_matches_xla(src, dst):
    """The helper against `astype` under `jit`, bit for bit (float64 only
    where the JAX package's x64 keeps it: a script's return value)."""
    x = np.array(VALUES, dtype=src)
    want = np.asarray(jax.jit(lambda a: a.astype(dst))(jnp.asarray(x)))
    got = convert_to(torch.from_numpy(x.copy()), getattr(torch, dst)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["convert", "cast"])
@pytest.mark.parametrize("target", ["int", "long"])
@pytest.mark.parametrize("col", ["f", "d"])
def test_cast_and_convert_match_xla(fn, target, col):
    """`convert(x, 'int'|'long')` and `cast(...)` through the executor, on a
    float and a double attribute (both float32 on the device), against
    `jnp.astype` under `jit`."""
    x = np.array(VALUES, np.float32)
    scope = Scope(InternTable(), "cpu").add_stream("S", {"f": AttrType.FLOAT,
                                                         "d": AttrType.DOUBLE})
    expr = compile_expression(SiddhiCompiler.parse_expression(f"{fn}({col}, '{target}')"),
                              scope)
    got = expr(Env({("S", None, col): torch.from_numpy(x.copy())})).numpy()
    dst = "int32" if target == "int" else "int64"
    want = np.asarray(jax.jit(lambda a: a.astype(dst))(jnp.asarray(x)))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


HEAD = "define stream S (f float, d double, i int);\n"
NAN, INF = float("nan"), float("inf")
FOUR = [(NAN, NAN, 1), (3e9, 1e19, 2), (INF, -1e19, 3), (-3e9, 5.5, 4)]
EDGE_ROWS = [(v, v, k) for k, v in enumerate([NAN, 3e9, -3e9, INF, -INF, 1e19, -1e19, 2.0**31,
                                               -(2.0**31), 0.5, -0.5, 7.9, -7.9, 1e-40, 0.0])]
APPS = {
    "four_events": (HEAD + "from S select i, convert(f, 'int') as a, convert(d, 'long') as b "
                    "insert into Out;", FOUR),
    "filter": (HEAD + "from S[convert(f, 'int') > 0] select i insert into Out;", EDGE_ROWS),
    "sum": (HEAD + "from S select i, sum(convert(f, 'int')) as s, sum(convert(d, 'long')) as t "
            "insert into Out;", EDGE_ROWS),
    "cast_arith": (HEAD + "from S select i, cast(f, 'long') + 1 as a, convert(d * 2.0, 'int') "
                   "as b insert into Out;", EDGE_ROWS),
    "table": (HEAD + "define table T (a int, b long, i int);\n"
              "from S select convert(f, 'int') as a, convert(d, 'long') as b, i "
              "insert into T;", EDGE_ROWS),
    "script_int": (HEAD + "define function toInt[python] return int { return data[0] };\n"
                   "from S select i, toInt(f) as a insert into Out;", EDGE_ROWS),
    "script_long": (HEAD + "define function toLong[python] return long { return data[0] * 2.0 };\n"
                    "from S select i, toLong(d) as a insert into Out;", EDGE_ROWS),
}


def _run(mgr, app: str, rows: list):
    rt = mgr.create_siddhi_app_runtime(app)
    out = []
    if "Out" in app:
        rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
    rt.start()
    for row in rows:
        rt.get_input_handler("S").send(row)
    table = None
    if "define table T" in app:
        table = [tuple(r[1]) for r in rt.query("from T select a, b, i")]
    rt.shutdown()
    return out, table


def _key(rows):
    """Rows with NaN as a marker, so NaN equals NaN."""
    if rows is None:
        return None
    return [tuple("NaN" if isinstance(x, float) and math.isnan(x) else x for x in r)
            for r in rows]


@pytest.mark.parametrize("label", list(APPS))
def test_app_matches_jax(label):
    app, rows = APPS[label]
    jax_out, jax_table = _run(siddhi_tpu.SiddhiManager(), app, rows)
    out, table = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, rows)
    assert _key(out) == _key(jax_out)
    assert _key(table) == _key(jax_table)


def test_four_event_app_gives_the_saturated_rows():
    """NaN converts to 0; 3e9, +inf and 1e19 to the type's max; -3e9 and
    -1e19 to its min, the null."""
    out, _ = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), *APPS["four_events"])
    assert out == [(1, 0, 0), (2, 2147483647, 9223372036854775807), (3, 2147483647, None),
                   (4, None, 5)]


def test_filter_passes_the_saturated_rows():
    """`convert(f, 'int') > 0` holds for 3e9, +inf, 1e19 and 2^31 (the max)
    as in JAX, not only for the in-range values."""
    out, _ = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), *APPS["filter"])
    assert [r[0] for r in out] == [1, 3, 5, 7, 11]
