"""Float32 arithmetic with subnormals through both packages on the CPU:
XLA's CPU code, which the JAX package runs under, reads a subnormal operand
of + - * / and of min/max as a zero of its sign (DAZ) and gives a zero of
its sign for a result that rounds below FLT_MIN (FTZ); the port copies it
(`core/types.py` `float_arith`, `float_extreme`, `flushed_cumsum`;
`csrc/common.cuh` `xla_add` ... on the card).

- Each operation over every pair of edge values (both signs of the least, a
  middle and the greatest subnormal, +-0.0, FLT_MIN, 1.0 and NaN), and
  products and quotients that round up to FLT_MIN, through the executor's
  `_arith` / `maximum` / `minimum` and the plain program interpreter,
  against `jnp` under `jit`, bit for bit (NaN as NaN).
- The plain sums (K2, K8, the aggregation's K44) and extremes (K18, K19,
  K3, K30) against their JAX functions on subnormal data: zeros exactly
  where JAX has them, the rest within the stated tolerance (sums) or by
  value (extremes; a zero's sign may differ, ROADMAP section 3).
- Apps through `siddhi_tpu.SiddhiManager()` and
  `siddhi_tpu_torch.SiddhiManager(device="cpu")`, one event a send: rows
  equal, in order.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.ops import prefix as jprefix  # noqa: E402
from siddhi_tpu_torch.core import pattern as P  # noqa: E402
from siddhi_tpu_torch.core.executor import Env, Scope, compile_expression  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType, InternTable  # noqa: E402
from siddhi_tpu_torch.ops import group, prefix  # noqa: E402
from siddhi_tpu_torch.query_api.expression import (  # noqa: E402
    Add,
    AttributeFunction,
    Divide,
    Mod,
    Multiply,
    Subtract,
    Variable,
)
from tests import test_torch_aggregation as agg_t  # noqa: E402
from tests import test_torch_extremes as ext_t  # noqa: E402
from tests import test_torch_groupby as grp_t  # noqa: E402
from tests import test_torch_partition as part_t  # noqa: E402


def _f(u: int) -> np.float32:
    return np.array([u], np.uint32).view(np.float32)[0]


TINY = np.finfo(np.float32).tiny
# both signs of the least, a middle and the greatest subnormal, the zeros,
# FLT_MIN, 1.0 and NaN
EDGES = np.array([_f(0x00000001), _f(0x80000001), _f(0x00400000), _f(0x80400000),
                  _f(0x007FFFFF), _f(0x807FFFFF), 0.0, -0.0, TINY, -TINY, 1.0, -1.0, np.nan],
                 np.float32)
# (a, b) whose product or quotient rounds to FLT_MIN only on the subnormal
# grid (XLA flushes them) or rounds to FLT_MIN in 24 bits (XLA keeps them)
BOUNDARY = [(_f(0x00FFFFFF), 0.5), (_f(0x00FFFFFF), _f(0x3EFFFFFF)),
            (_f(0x00C00000), _f(0x3F2AAAAB)), (_f(0x00C00000), _f(0x3F2AAAAA)),
            (_f(0x00FFFFFF), -0.5), (TINY, 0.9999999), (TINY, 1.0000001)]
OPS = {"add": (Add, lambda a, b: a + b), "sub": (Subtract, lambda a, b: a - b),
       "mul": (Multiply, lambda a, b: a * b), "div": (Divide, lambda a, b: a / b),
       "mod": (Mod, lax.rem)}


def _pairs():
    a, b = np.meshgrid(EDGES, EDGES)
    ba = np.array([p[0] for p in BOUNDARY], np.float32)
    bb = np.array([p[1] for p in BOUNDARY], np.float32)
    return np.concatenate([a.ravel(), ba, bb * 3]), np.concatenate([b.ravel(), bb, ba])


def _same_bits(got: np.ndarray, want: np.ndarray, what):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan), what
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32)), what


def _scope():
    scope = Scope(InternTable(), "cpu").add_stream("S", {"a": AttrType.FLOAT,
                                                         "b": AttrType.FLOAT})
    return scope


@pytest.mark.parametrize("route", ["executor", "program"])
@pytest.mark.parametrize("op", list(OPS))
def test_arithmetic_matches_xla(op, route):
    """a op b over every pair of edge values and the rounding boundary,
    bit for bit against `jnp` under `jit` (% is fmodf: only a subnormal
    divisor reads as zero)."""
    a, b = _pairs()
    want = np.asarray(jax.jit(OPS[op][1])(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if route == "executor":
        expr = OPS[op][0](Variable("a"), Variable("b"))
        got = compile_expression(expr, _scope())(Env({("S", None, "a"): ta,
                                                      ("S", None, "b"): tb}))
    else:
        code = [(P.OP_REG, 0, P.TY_FLOAT), (P.OP_REG, 1, P.TY_FLOAT),
                (P.OP_ARITH, P._ARITH_CODE[OPS[op][0]], P.TY_FLOAT, P.TY_FLOAT, P.TY_FLOAT)]
        got = P.run_program(code, [ta, tb], None, None)
    _same_bits(got.numpy(), want, (op, route))


@pytest.mark.parametrize("c", [1.0, -2.0, 4.0, 2.0**100, 0.5, 3.0, 1e-40, 2])
def test_mod_by_a_constant_matches_xla(c):
    """a % c for a constant c, through the executor and the program
    interpreter (with `arith_code`), against `jnp` under `jit` with c a
    constant: XLA rewrites a % by a power of two of at least 1 into
    arithmetic, whose dividend reads a subnormal as zero (fmodf's does
    not)."""
    from siddhi_tpu_torch.query_api.expression import Constant

    a = np.concatenate([EDGES, np.float32([3e-38, 1.5, -7.25, 1e30])])
    t = AttrType.INT if isinstance(c, int) else AttrType.FLOAT
    want = np.asarray(jax.jit(lambda x: lax.rem(x, np.float32(c)))(jnp.asarray(a)))
    expr = Mod(Variable("a"), Constant(c, t))
    got = compile_expression(expr, _scope())(Env({("S", None, "a"): torch.from_numpy(a)}))
    _same_bits(got.numpy(), want, ("executor", c))
    ty = P.TY_INT if t is AttrType.INT else P.TY_FLOAT
    bits = c if t is AttrType.INT else int(np.float32(c).view(np.int32))
    const = torch.tensor(c, dtype=torch.int32) if t is AttrType.INT else \
        torch.from_numpy(np.float32(c).reshape(1))[0]
    code = [(P.OP_REG, 0, P.TY_FLOAT), (P.OP_CONST, ty, bits),
            (P.OP_ARITH, P.arith_code(expr, AttrType.FLOAT), P.TY_FLOAT, ty, P.TY_FLOAT)]
    got = P.run_program(code, [torch.from_numpy(a)], lambda ty_, bits_: const, None)
    _same_bits(got.numpy(), want, ("program", c))


@pytest.mark.parametrize("name", ["maximum", "minimum"])
def test_maximum_minimum_match_xla(name):
    """maximum / minimum over every pair of edge values (three operands
    too), bit for bit against `jnp`'s: subnormals as zeros, NaN wins, of a
    zero of each sign the maximum 0.0 and the minimum -0.0."""
    a, b = _pairs()
    c = np.roll(a, 7)
    jf = jnp.maximum if name == "maximum" else jnp.minimum
    scope = Scope(InternTable(), "cpu").add_stream(
        "S", {"a": AttrType.FLOAT, "b": AttrType.FLOAT, "c": AttrType.FLOAT})
    env = Env({("S", None, n): torch.from_numpy(x) for n, x in zip("abc", (a, b, c))})
    for args in (("a", "b"), ("a", "b", "c")):
        want = np.asarray(jax.jit(lambda x, y, z: jf(jf(x, y), z) if len(args) == 3
                                  else jf(x, y))(a, b, c))
        got = compile_expression(AttributeFunction(None, name, [Variable(v) for v in args]),
                                 scope)(env)
        _same_bits(got.numpy(), want, (name, args))


# sums of these are whole numbers in any order, once a subnormal counts as
# a zero; a subnormal counted as itself leaves a residue
SUM_VALUES = np.concatenate([EDGES[:8], np.float32([5e-39, 1e-40, 1.0, -1.0, 2.0, 3.0])])


def _sum_values(rng, n):
    return rng.choice(SUM_VALUES, n).astype(np.float32)


@pytest.mark.parametrize("b", [1, 33, 513])
def test_running_sum_subnormal_matches_jax(b):
    """K2's plain version against JAX `running_sum`: subnormal contributions
    and carries add as zeros (no residue where JAX has a zero); several
    resets."""
    rng = np.random.default_rng(b + 20)
    contrib = _sum_values(rng, b)
    contrib[:3] = np.float32(5e-39)  # a first stretch of subnormals alone
    reset = rng.random(b) < 0.05
    if b > 8:
        reset[b // 2] = True
    for base in (np.float32(0.0), np.float32(2.0), _f(0x00400000)):
        want_run, want_carry = jax.jit(jprefix.running_sum)(
            jnp.asarray(contrib), jnp.asarray(reset), jnp.asarray(base))
        run, carry = prefix.running_sum(torch.from_numpy(contrib), torch.from_numpy(reset),
                                        torch.tensor(base))
        np.testing.assert_array_equal(run.numpy(), np.asarray(want_run))
        np.testing.assert_array_equal(carry.numpy(), np.asarray(want_carry))
        assert not ((run.numpy() != 0) & (np.abs(run.numpy()) < TINY)).any()


def test_running_sum_cancels_to_zero_as_xla():
    """A partial sum that cancels below FLT_MIN is a zero the sum goes on
    from (each step of a float32 cumsum flushes), here against `jnp.cumsum`
    one add at a time."""
    contrib = np.float32([1.5e-38, -1.4e-38, 1.2e-38, -1.2e-38, 2e-38, -1.9e-38, 1.3e-38])
    want = np.asarray(jax.jit(jnp.cumsum)(contrib))
    run, _ = prefix.running_sum(torch.from_numpy(contrib), torch.zeros(7, dtype=torch.bool),
                                torch.tensor(np.float32(0.0)))
    np.testing.assert_array_equal(run.numpy(), want)


@pytest.mark.parametrize("rows", [33, 513])
def test_keyed_running_sum_subnormal_matches_jax(rows):
    """K8's plain version against JAX `keyed_running_sum` on subnormal
    contributions and carries: per group, sums equal JAX's, zeros where
    JAX's are."""
    g, keys, active, reset = grp_t._scenario(rows, "resets", seed=rows + 5)
    rng = np.random.default_rng(rows)
    table = (np.zeros(g, np.int64), np.zeros(g, bool), np.int32(0))
    jt, pt = grp_t._assign_both(table, keys, active, reset)
    contrib = np.where(active, _sum_values(rng, rows), 0).astype(np.float32)
    carry = _sum_values(rng, g)
    jrun, jcarry = grp_t._jax_keyed_sum_lanes(jnp.asarray(contrib), grp_t._lanes(jt[4]),
                                              jnp.asarray(reset), jnp.asarray(carry), jt[3])
    run, new_carry = group.keyed_running_sum(torch.from_numpy(contrib), pt[4],
                                             torch.from_numpy(reset), torch.from_numpy(carry),
                                             pt[3])
    np.testing.assert_array_equal(run.numpy(), np.asarray(jrun))
    np.testing.assert_array_equal(new_carry.numpy(), np.asarray(jcarry))


def _subnormal_extreme_values(rng, n, dtype, nan_share=0.05):
    if dtype != "float32":
        return _plain_values(rng, n, dtype, nan_share)
    v = rng.choice(EDGES, n).astype(np.float32)
    near = rng.random(n) < 0.3
    v[near] = rng.uniform(-3e-38, 3e-38, int(near.sum())).astype(np.float32)
    v[rng.random(n) < nan_share] = np.nan
    v[:3] = np.float32([5e-39, 1e-40, 1e-45])[:n]  # a first stretch of subnormals alone
    return v


_plain_values = ext_t._values


@pytest.mark.parametrize("b", [33, 513])
@pytest.mark.parametrize("is_min", [True, False])
def test_running_extreme_subnormal_matches_jax(b, is_min, monkeypatch):
    """K18's plain version on subnormal values against JAX `running_extreme`
    (the running min/max of tests/test_torch_extremes.py, its values drawn
    from the edge values)."""
    monkeypatch.setattr(ext_t, "_values", _subnormal_extreme_values)
    ext_t.test_running_extreme(b, "float32", is_min)


@pytest.mark.parametrize("rows", [33, 513])
@pytest.mark.parametrize("case", ["resets", "forever"])
def test_keyed_running_extreme_subnormal_matches_jax(rows, case, monkeypatch):
    """K19's plain version on subnormal values and carries against JAX
    `keyed_running_extreme`."""
    monkeypatch.setattr(ext_t, "_values", _subnormal_extreme_values)
    ext_t.test_keyed_running_extreme(rows, "float32", case)


@pytest.mark.parametrize("window", ["length", "timeBatch"])
@pytest.mark.parametrize("is_min", [True, False])
def test_window_extreme_subnormal_matches_jax(window, is_min, monkeypatch):
    """K3's plain version, keyed and not, on subnormal values against the
    JAX windowed branch of `ExtremeAggregator.apply`."""
    monkeypatch.setattr(ext_t, "_values", _subnormal_extreme_values)
    ext_t.test_window_extreme_keyed(window, "FLOAT", is_min)
    birth, death, elems, rows = ext_t._membership(window, seed=5 + is_min)
    member = ext_t._member(birth, death, rows)
    vals = torch.from_numpy(_subnormal_extreme_values(np.random.default_rng(9),
                                                      birth.shape[0], "float32"))
    key = ("S", None, "x")
    jagg = ext_t.JaxExtreme(ext_t.JaxExpr(ext_t.JaxAttrType.FLOAT, lambda e: e.read(key)),
                            is_min, forever=False)
    info = ext_t.JaxFlowInfo(sign=jnp.zeros(rows, jnp.int8), active=jnp.zeros(rows, bool),
                             reset=jnp.zeros(rows, bool), member=jnp.asarray(member),
                             member_env=ext_t.JaxEnv({key: jnp.asarray(vals.numpy())}))
    _, want = jagg.apply(jagg.init(), info, ext_t.JaxEnv({}))
    got = ext_t.window_extreme(vals, birth, death, rows, is_min, AttrType.FLOAT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("p,b,w", [(8, 33, 4), (33, 513, 50)])
def test_partition_window_extreme_subnormal_matches_jax(p, b, w, monkeypatch):
    """K30's plain version (with K29's step) on subnormal prices against
    `jax.vmap` of the windowed `ExtremeAggregator.apply`."""
    monkeypatch.setattr(part_t, "PRICES", EDGES)
    part_t.test_partition_length_window_step(p, b, w)


@pytest.mark.parametrize("b", [33, 513])
def test_aggregation_subnormal_matches_jax(b):
    """K44's and K45's plain versions on subnormal prices against JAX's
    `receive` and `_find_impl`: every store and duration-table lane bit for
    bit (sums, avg, min and max flushed, the last price kept)."""
    rng = np.random.default_rng(b + 44)
    prices = np.concatenate([EDGES, np.float32([5e-39, 3e-38, -2e-38, 1.5])])
    feeds = [agg_t._batch(rng, b, agg_t._ms(2024, 6, 1, 0, 0, 57) + i * 90_000, 8, 3,
                          prices=prices, timers=0.1) for i in range(3)]
    agg_t._run("full", 64, feeds)


SK = "define stream S (k float, v int);\n"
APPS = {
    "filter over a product": (SK + "from S[k * 10000000000.0 > 0.0] select k, v "
                              "insert into Out;", [(1e-38,), (1e-40,), (0.0,), (1.0,)]),
    "sum, avg having": (SK + "from S#window.length(20) select sum(k) as s, avg(k) as a "
                        "having s > 0.0 insert into Out;", [(5e-39,)] * 20),
    "min, max": (SK + "from S select min(k) as mn, max(k) as mx insert into Out;",
                 [(5e-39,), (-1e-40,), (2e-45,)]),
    "windowed min, max, stdDev": (SK + "from S#window.length(3) select min(k) as mn, "
                                  "max(k) as mx, stdDev(k) as sd, avg(k) as a insert into Out;",
                                  [(5e-39,), (-1e-40,), (2e-45,), (1e-20,), (-1e-19,), (0.0,)]),
    "projections": (SK + "from S select k * 1e10 as a, k / 3.0 as b, k + k as c, k - 1e-38 "
                    "as d, k % 1.0 as e, maximum(k, 0.0) as f, minimum(k, 0.0, 1.0) as g, "
                    "1e-20 * 1e-20 as h insert into Out;",
                    [(1e-40,), (-1e-40,), (1.5e-38,), (1e-20,), (-0.0,), (-1e-20,)]),
    "table update by a product": (
        SK + "define table T (k int, v double);\n"
        "define stream U (k int);\n"
        "from U select k, 1e-20 as v insert into T;\n"
        "from S update T set T.v = T.v * k on T.k == v;",
        [("U", (1,)), ("U", (2,)), ("U", (3,)), ("S", (1e-20, 1)), ("S", (1e-19, 2)),
         ("S", (1.0, 3)), ("S", (1.0, 1)), ("S", (-1e-20, 3))]),
    "scan pattern over a product": (
        SK + "from every e1=S[k >= 0.0] -> e2=S[k * 10000000000.0 > e1.k] or "
        "e3=S[k < 0.0] select e1.v as a, e2.v as b, e3.v as c insert into Out;",
        [(0.0,), (1e-40,), (1e-38,), (2e-38,), (-1.0,), (0.0,), (1.0,)]),
    "scan pattern over a captured product": (
        SK + "from every e1=S[k >= 0.0] -> e2=S[k > e1.k * 100.0] or "
        "e3=S[k < 0.0] select e1.v as a, e2.v as b, e3.v as c insert into Out;",
        [(5e-39,), (1e-37,), (2e-38,), (0.0,), (5e-39,), (-1.0,), (1e-36,), (1.0,)]),
    "partitioned sum having": (
        "define stream S (k float, v int, g int);\n"
        "partition with (g of S) begin from S#window.length(4) select g, sum(k) as s "
        "having s > 0.0 insert into Out; end;",
        [("S", (5e-39, 0, 0)), ("S", (5e-39, 1, 1)), ("S", (5e-39, 2, 0)), ("S", (1.0, 3, 1)),
         ("S", (5e-39, 4, 0)), ("S", (2e-38, 5, 0))]),
}


def _run(mgr, app: str, sends: list):
    rt = mgr.create_siddhi_app_runtime("@app:batch(size='16')\n" + app)
    out = []
    if "Out" in app:
        rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
    rt.start()
    rows = None
    for i, s in enumerate(sends):
        # (k,): an S event (k, i); else (stream, row)
        stream, row = (s[0], s[1]) if isinstance(s[0], str) else ("S", (s[0], i))
        rt.get_input_handler(stream).send(row)
    if "define table T" in app:
        rows = [tuple(r[1]) for r in rt.query("from T select k, v")]
    rt.shutdown()
    return out, rows


def _key(rows):
    """Rows with NaN as a marker, so NaN equals NaN."""
    if rows is None:
        return None
    return [tuple("NaN" if isinstance(x, float) and math.isnan(x) else x for x in r)
            for r in rows]


@pytest.mark.parametrize("label", list(APPS))
def test_app_matches_jax(label):
    app, sends = APPS[label]
    jax_out, jax_rows = _run(siddhi_tpu.SiddhiManager(), app, sends)
    out, rows = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, sends)
    assert _key(out) == _key(jax_out)
    assert _key(rows) == _key(jax_rows)


def test_motivating_apps_give_jax_rows():
    """The three apps of the fault as JAX delivers them: one row (1.0, 3);
    no row (the sums of subnormals are zeros); min and max 0.0."""
    out, _ = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"),
                  *APPS["filter over a product"])
    assert out == [(1.0, 3)]
    out, _ = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), *APPS["sum, avg having"])
    assert out == []
    out, _ = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), *APPS["min, max"])
    assert all(x == 0.0 for r in out for x in r) and len(out) == 3
