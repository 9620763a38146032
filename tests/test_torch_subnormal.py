"""Float32 subnormals through both packages on the CPU: under XLA the JAX
package compares, sorts and searches float32 values with subnormal operands
flushed to zero, and the port copies that (`core/types.py`
`flush_subnormal`; `csrc/common.cuh` on the card) wherever it compares
floats, while its arithmetic, min/max and hashed keys stay as they were.

- The six comparisons over every pair of edge values against `jnp`'s.
- The plain index build (K22) against JAX `_rebuild_index` (order, sorted
  keys, duplicate flag) over float32 keys of every subnormal class of both
  signs beside +-0.0, FLT_MIN, NaN and ones, at one block and the grid
  sort's sizes; the plain indexed update's probe against `_update_indexed`.
- Apps through `siddhi_tpu.SiddhiManager()` and
  `siddhi_tpu_torch.SiddhiManager(device="cpu")` on one seeded numpy feed of
  +-0.0, +-1e-40, 1e-38, 2e-45, 1.0 and NaN, one event a send: filters, a
  float primary key, indexed, dense and upsert updates, a primary-key rekey,
  `in` a table, sort windows, patterns on the fast and the scan route, a
  join `on`, distinctCount, having, and sort windows and patterns in a
  partition. Rows equal, in order (NaN equal to NaN).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler  # noqa: E402
from siddhi_tpu_torch.core.executor import compile_expression  # noqa: E402
from siddhi_tpu_torch.core.types import flush_subnormal  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy  # noqa: E402
from siddhi_tpu_torch.ops import table as K  # noqa: E402
from tests.test_torch_table import (  # noqa: E402
    JaxCompiler,
    _batch,
    _jax_batch,
    _jax_set_attrs,
    _jstate,
    _np,
    _port_batch,
    _same,
    _scopes,
    _state,
    _tables,
    compile_set_attributes,
    jax_compile,
    jax_sets,
)

F32 = np.finfo(np.float32)
# every subnormal class of both signs (the least, one inside, the greatest),
# the zeros, the least normal, NaN and ones
EDGES = np.array([0.0, -0.0, 1.4e-45, -1.4e-45, 1e-40, -1e-40, 1.1754942e-38, -1.1754942e-38,
                  F32.tiny, -F32.tiny, np.nan, 1.0, -1.0], np.float32)
FEED_VALUES = np.array([0.0, -0.0, 1e-40, -1e-40, 1e-38, 2e-45, 1.0, np.nan], np.float32)


def _feed() -> list:
    """The seeded feed: the eight feed values in a fixed order, then a
    seeded permutation of them, as (k, v, g) events."""
    rng = np.random.default_rng(19)
    ks = np.concatenate([FEED_VALUES, rng.permutation(FEED_VALUES)])
    return [(float(k), i, i % 2) for i, k in enumerate(ks)]


def test_comparisons_match_xla():
    """The six comparisons of every pair of edge values, the port's way
    (flush, then compare) against `jnp`'s under XLA."""
    a, b = np.meshgrid(EDGES, EDGES)
    a, b = a.ravel(), b.ravel()
    ta, tb = flush_subnormal(torch.from_numpy(a)), flush_subnormal(torch.from_numpy(b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for tf, jf in ((torch.lt, jnp.less), (torch.le, jnp.less_equal), (torch.gt, jnp.greater),
                   (torch.ge, jnp.greater_equal), (torch.eq, jnp.equal),
                   (torch.ne, jnp.not_equal)):
        assert np.array_equal(tf(ta, tb).numpy(), np.asarray(jf(ja, jb))), tf.__name__
    # the sign of a flushed zero is kept, NaN stays NaN, and other dtypes pass
    out = flush_subnormal(torch.from_numpy(EDGES)).numpy()
    keep = np.abs(EDGES) >= F32.tiny
    assert np.array_equal(out[keep].view(np.int32), EDGES[keep].view(np.int32))
    assert np.array_equal(np.signbit(out[~np.isnan(EDGES)]), np.signbit(EDGES[~np.isnan(EDGES)]))
    ints = torch.arange(5)
    assert flush_subnormal(ints) is ints


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("const", [float(x) for x in EDGES] + [0, 3])
def test_constant_comparisons_match_xla(const, side):
    """A column against a constant of every class, both ways round, through
    the executor's `_compare` and the plain program interpreter: a constant
    is flushed once when compiled, and the column only where the constant
    is a zero or a subnormal; the six comparisons equal `jnp`'s."""
    from siddhi_tpu_torch.core import pattern as P
    from siddhi_tpu_torch.core.executor import Env, Scope
    from siddhi_tpu_torch.core.types import AttrType, InternTable
    from siddhi_tpu_torch.query_api.expression import Compare, CompareOp, Constant, Variable

    t = AttrType.INT if isinstance(const, int) else AttrType.FLOAT
    col = np.concatenate([EDGES, -EDGES[::-1]])
    c_np = np.full_like(col, const)
    scope = Scope(InternTable(), "cpu").add_stream("S", {"k": AttrType.FLOAT})
    env = Env({("S", None, "k"): torch.from_numpy(col)})
    ty = P.TY_INT if t is AttrType.INT else P.TY_FLOAT
    bits = const if t is AttrType.INT else int(np.float32(const).view(np.int32))
    leaves = [(P.OP_REG, 0, P.TY_FLOAT), (P.OP_CONST, ty, bits)]
    consts = {(P.TY_INT, bits): torch.tensor(bits, dtype=torch.int32),
              (P.TY_FLOAT, bits): torch.from_numpy(np.float32(const).reshape(1))[0]}
    for op, jf in ((CompareOp.LT, jnp.less), (CompareOp.LE, jnp.less_equal),
                   (CompareOp.GT, jnp.greater), (CompareOp.GE, jnp.greater_equal),
                   (CompareOp.EQ, jnp.equal), (CompareOp.NEQ, jnp.not_equal)):
        pair = [Variable("k"), Constant(const, t)]
        a, b = (col, c_np) if side == "left" else (c_np, col)
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b))) & ~np.isnan(a) & ~np.isnan(b)
        if side == "right":
            pair = pair[::-1]
        got = compile_expression(Compare(pair[0], op, pair[1]), scope)(env)
        assert np.array_equal(got.numpy(), want), (op, const, side)
        code = (leaves if side == "left" else leaves[::-1]) + [
            (P.OP_CMP, P._CMP_CODE[op], P.TY_FLOAT if side == "left" else ty,
             ty if side == "left" else P.TY_FLOAT, P.TY_FLOAT)]
        got = P.run_program(code, [torch.from_numpy(col)], lambda ty_, bits_: consts[(ty_, bits_)],
                            None)
        assert np.array_equal(got.numpy(), want), ("program", op, const, side)


@pytest.mark.parametrize("c", [33, 2049])
def test_rebuild_index_subnormal_keys(c):
    """K22's plain build over float32 keys of every subnormal class and sign
    against `_rebuild_index`: a subnormal ties with +-0.0 (slot order
    decides) and counts as its duplicate."""
    rng = np.random.default_rng(c)
    jt, _pt = _tables("", c)
    st = _state(rng, jt, 2 * c // 3, c // 4 + 1)
    p = rng.choice(EDGES, c)
    st["cols"]["p"] = p
    want = jt._rebuild_index(_jstate(st), "p")
    order, sk, dups = K.table_index_build_ref(torch.from_numpy(p.copy()),
                                              torch.from_numpy(st["valid"].copy()))
    _same({"o": order.numpy(), "s": sk.numpy(), "d": dups.numpy()},
          {"o": np.asarray(want["ix_order.p"]), "s": np.asarray(want["ix_sorted.p"]),
           "d": np.asarray(want["ix_dups.p"])})


@pytest.mark.parametrize("b,c", [(33, 33), (513, 4097)])
@pytest.mark.parametrize("unique", [True, False])
def test_update_indexed_subnormal_probes(b, c, unique):
    """The indexed update on a float key column holding subnormals, probed
    with subnormals of both signs, against `_update_indexed`: its search
    and its hit test take a subnormal as a zero."""
    rng = np.random.default_rng(b + c + unique)
    jt, pt = _tables("@Index('p')", c)
    st = _state(rng, jt, 3 * c // 4, 2 * c)
    p = st["cols"]["p"]
    pos = np.flatnonzero(st["valid"])
    if unique:  # one slot a zero class: the index stays duplicate-free
        p[pos] = np.arange(pos.size, dtype=np.float32) + 1
        p[pos[:3]] = [0.0, -1e-40, 1e-38]
        p[pos[3:4]] = -2e-45
    else:
        p[:] = rng.choice(EDGES, c)
    js = jt._rebuild_pk_index(_jstate(st))
    st = {**{n: np.array(v) for n, v in js.items() if n != "cols"},
          "cols": {n: np.array(v) for n, v in js["cols"].items()}}
    bt = _batch(rng, b, 2 * c)
    bt["cols"]["p"] = rng.choice(EDGES, b)
    js_scope, ps_scope = _scopes(jt, pt)
    jsets = jax_sets(jt, _jax_set_attrs(), js_scope)
    set_ql = SiddhiCompiler.parse_store_query(
        "from T select k update T set T.v = v, T.p = p on T.k == k").output_stream
    psets = compile_set_attributes(pt, set_ql.set_attributes, ps_scope)
    jb = _jax_batch(bt)
    rows = jb.valid & (jb.kind == 0)
    want = jt._update_indexed(_jstate(st), jb, "p", jax_compile(JaxCompiler.parse_expression("p"),
                                                                 js_scope),
                              jsets, "__out__", jnp.asarray(0, jnp.int64), rows)
    pb = _port_batch(bt)
    got = pt._update_indexed(state_from_numpy(st, "cpu"), pb, "p",
                             compile_expression(SiddhiCompiler.parse_expression("p"), ps_scope),
                             psets, torch.zeros((), dtype=torch.int64), pb.valid)
    _same(_np(got), _np(want))


S = "define stream S (k float, v int, g int);\ndefine stream U (k float, v int);\n"
UPDATES = [("U", (0.0, 99)), ("U", (-1e-40, 98)), ("U", (2e-45, 97)), ("U", (7.0, 96))]
# label: (app, sends after the feed, store query)
APPS = {
    "filter ==": ("from S[k == 0.0] select k, v insert into Out;", [], None),
    "filter > and <=": ("from S[k > 0.0] select k, v, 1 as q insert into Out;\n"
                        "from S[k <= 0.0] select k, v, 2 as q insert into Out;", [], None),
    "filter != int": ("from S[k != 0] select k, v insert into Out;", [], None),
    "having": ("from S#window.length(1) select k, v having k >= 0.0 insert into Out;", [],
               None),
    "primary key": ("@PrimaryKey('k') define table T (k float, v int);\n"
                    "from S select k, v insert into T;", [], "from T select k, v"),
    "index update": ("@Index('k') define table T (k float, v int);\n"
                     "from S select k, v insert into T;\n"
                     "from U update T set T.v = v on T.k == k;", UPDATES[:1],
                     "from T select k, v"),
    "dense update": ("define table T (k float, v int);\nfrom S select k, v insert into T;\n"
                     "from U update T set T.v = v on T.k == k;", UPDATES[1:2],
                     "from T select k, v"),
    "upsert": ("define table T (k float, v int);\nfrom S select k, v insert into T;\n"
               "from U update or insert into T set T.v = v on T.k == k;", UPDATES,
               "from T select k, v"),
    "rekey": ("@PrimaryKey('k') define table T (k float, v int);\n"
              "from S select k, v insert into T;\n"
              "from U update T set T.k = k on T.v == v;", [("U", (-2e-45, 6)), ("U", (1e-40, 0))],
              "from T select k, v"),
    "in table": ("define table T (k float, v int);\nfrom U insert into T;\n"
                 "from S[(T.k == k) in T] select k, v insert into Out;", [], None),
    "sort window": ("from S#window.sort(2, k, 'asc') select k, v insert all events into Out;",
                    [], None),
    "sort window desc": ("from S#window.sort(3, k, 'desc', v, 'asc') select k, v "
                         "insert expired events into Out;", [], None),
    "pattern": ("from every e1=S[k == 0.0] -> e2=S[k > e1.k] select e1.v as a, e2.v as b "
                "insert into Out;", [], None),
    "scan pattern": ("from every e1=S[k == 0.0] -> e2=S[k > e1.k] or e3=S[k < e1.k] "
                     "select e1.v as a, e2.v as b, e3.v as c insert into Out;", [], None),
    "join on": ("from S#window.length(4) join U#window.length(4) on S.k == U.k "
                "select S.v as a, U.v as b insert into Out;", UPDATES, None),
    "distinctCount": ("from S#window.length(8) select distinctCount(k) as d insert into Out;",
                      [], None),
    "partitioned sort": ("partition with (g of S) begin from S#window.sort(2, k, 'asc') "
                         "select k, v insert all events into Out; end;", [], None),
    "partitioned scan pattern": ("partition with (g of S) begin from every e1=S[k == 0.0] -> "
                                 "e2=S[k > e1.k] or e3=S[k < e1.k] select e1.v as a, "
                                 "e2.v as b insert into Out; end;", [], None),
}


def _run(mgr, app: str, sends: list, query):
    rt = mgr.create_siddhi_app_runtime("@app:batch(size='16')\n" + S + app)
    out = []
    if "Out" in app:
        rt.add_callback("Out", lambda evs: out.extend(tuple(e.data) for e in evs))
    rt.start()
    if "from U insert into T" in app:
        rt.get_input_handler("U").send((0.0, 1))
    for ev in _feed():
        rt.get_input_handler("S").send(ev)
    for stream, row in sends:
        rt.get_input_handler(stream).send(row)
    rows = [tuple(r[1]) for r in rt.query(query)] if query else None
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
    app, sends, query = APPS[label]
    jax_out, jax_rows = _run(siddhi_tpu.SiddhiManager(), app, sends, query)
    out, rows = _run(siddhi_tpu_torch.SiddhiManager(device="cpu"), app, sends, query)
    assert _key(out) == _key(jax_out)
    assert _key(rows) == _key(jax_rows)
    assert jax_out or jax_rows  # the app delivered something to compare
