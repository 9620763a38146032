"""The table's plain kernels (K21-K24, `siddhi_tpu_torch/ops/table.py`)
against the JAX package's InMemoryTable on the CPU, from the same numpy
state and probe batch made from a seed: the insert (K21, with the index
rebuild of K22) against `insert`; the sorted index (K22) against
`_rebuild_index` and the indexed update against `_update_indexed`; the
condition match (K23) against `match` and its reductions, `_update_dense`,
`delete` and `In`; the sequential routines (K24) against `update`'s scan
(with the rekey guard) and `update_or_insert`. Capacities C 1/33/4097 and
batches B 1/33/513, with nulls in keys and probes, repeated keys, a full
table and a table holding duplicates of an indexed key. Every lane, `next`
and every flag compare exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax.numpy as jnp  # noqa: E402

from siddhi_tpu.compiler.siddhi_compiler import SiddhiCompiler as JaxCompiler  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.core.executor import Scope as JaxScope  # noqa: E402
from siddhi_tpu.core.executor import compile_expression as jax_compile  # noqa: E402
from siddhi_tpu.core.table import InMemoryTable as JaxTable  # noqa: E402
from siddhi_tpu.core.table import compile_set_attributes as jax_sets  # noqa: E402
from siddhi_tpu.core.types import InternTable as JaxInterner  # noqa: E402
from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch, StreamSchema  # noqa: E402
from siddhi_tpu_torch.core.executor import Env, Scope, compile_expression  # noqa: E402
from siddhi_tpu_torch.core.table import (  # noqa: E402
    InMemoryTable,
    TableOn,
    _UpdateOp,
    _UpsertOp,
    build_scan_programs,
    compile_set_attributes,
    emit_program,
    output_scope,
)
from siddhi_tpu_torch.core.types import AttrType, InternTable  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy  # noqa: E402
from siddhi_tpu_torch.ops import table as K  # noqa: E402

SIZES = [(1, 1), (33, 33), (513, 33), (1, 4097), (33, 4097), (513, 4097)]
LONG_NULL = np.iinfo(np.int64).min
COLS = "k long, v long, p float, s string"
OUT = [("k", AttrType.LONG), ("v", AttrType.LONG), ("p", AttrType.FLOAT),
       ("s", AttrType.STRING)]


def _tables(annotations: str, c: int):
    ql = f"{annotations} define table T ({COLS});"
    jt = JaxTable(JaxCompiler.parse(ql).table_definitions["T"], JaxInterner(), capacity=c)
    pt = InMemoryTable(SiddhiCompiler.parse(ql).table_definitions["T"], InternTable(), "cpu",
                       capacity=c)
    return jt, pt


def _state(rng, t: "JaxTable", n_valid: int, key_hi: int, dup: bool = True) -> dict:
    """A numpy table state: n_valid valid slots scattered over C, keys from
    [0, key_hi) (unique unless dup) with a few nulls, stale values in the
    empty slots, seq a permutation, the indexes as the JAX package builds
    them."""
    c = t.capacity
    pos = rng.permutation(c)[:n_valid]
    valid = np.zeros(c, bool)
    valid[pos] = True
    k = rng.integers(-(1 << 40), 1 << 40, c).astype(np.int64)
    if dup:
        k[pos] = rng.integers(0, max(key_hi, 1), n_valid)
    else:
        k[pos] = rng.permutation(max(key_hi, n_valid))[:n_valid]
    k[pos[rng.random(n_valid) < 0.05]] = LONG_NULL
    p = rng.uniform(-50, 50, c).astype(np.float32).round(1)
    p[rng.random(c) < 0.1] = np.nan
    seq = np.full(c, np.iinfo(np.int64).max, np.int64)
    seq[pos] = rng.permutation(n_valid) * 3
    st = {"cols": {"k": k, "v": rng.integers(-1000, 1000, c).astype(np.int64), "p": p,
                   "s": rng.integers(0, 5, c).astype(np.int32)},
          "ts": rng.integers(0, 1 << 40, c).astype(np.int64), "valid": valid, "seq": seq,
          "next": np.asarray(n_valid * 3, np.int64)}
    js = t._rebuild_pk_index(_jstate(st))
    return {**{n: np.array(v) for n, v in js.items() if n != "cols"},
            "cols": {n: np.array(v) for n, v in js["cols"].items()}}


def _jstate(st: dict) -> dict:
    return {**{n: jnp.asarray(v) for n, v in st.items() if n != "cols"},
            "cols": {n: jnp.asarray(v) for n, v in st["cols"].items()}}


def _batch(rng, b: int, key_hi: int, null_share: float = 0.1) -> dict:
    k = rng.integers(0, max(key_hi, 1), b).astype(np.int64)
    k[rng.random(b) < null_share] = LONG_NULL
    p = rng.uniform(-50, 50, b).astype(np.float32).round(1)
    p[rng.random(b) < null_share] = np.nan
    return {"ts": np.arange(b, dtype=np.int64) + 1_000, "kind": np.zeros(b, np.int8),
            "valid": rng.random(b) < 0.9,
            "cols": {"k": k, "v": rng.integers(-1000, 1000, b).astype(np.int64), "p": p,
                     "s": rng.integers(0, 5, b).astype(np.int32)}}


def _jax_batch(b: dict) -> JaxBatch:
    return JaxBatch(jnp.asarray(b["ts"]), jnp.asarray(b["kind"]), jnp.asarray(b["valid"]),
                    {n: jnp.asarray(v) for n, v in b["cols"].items()})


def _port_batch(b: dict) -> EventBatch:
    return EventBatch(torch.from_numpy(b["ts"].copy()), torch.from_numpy(b["kind"].copy()),
                      torch.from_numpy(b["valid"].copy()),
                      {n: torch.from_numpy(v.copy()) for n, v in b["cols"].items()})


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return np.asarray(tree)


def _same(got: dict, want: dict) -> None:
    """Every lane of two table states (and flag dicts) bit for bit."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f":
            assert np.array_equal(g.view(np.int32), w.view(np.int32)), k
        else:
            assert np.array_equal(g, w), k


def _scopes(jt, pt):
    out_schema = StreamSchema("__out__", OUT)
    js = JaxScope(jt.interner)
    js.add_stream("__out__", {n: t for n, t in _jax_types().items()})
    js.add_stream("T", jt.schema.attr_types)
    js.default_ref = "__out__"
    js.prefer_default = True
    return js, output_scope(pt, out_schema, pt.interner, "cpu")


def _jax_types():
    from siddhi_tpu.core.types import AttrType as JT

    return {"k": JT.LONG, "v": JT.LONG, "p": JT.FLOAT, "s": JT.STRING}


def _flags(aux: dict) -> dict:
    return {k: np.asarray(v) for k, v in aux.items()}


# ---------------------------------------------------------------------------
# K21: the insert (with K22's index rebuild)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("ann", ["", "@PrimaryKey('k')", "@PrimaryKey('k') @Index('k')",
                                 "@PrimaryKey('k','s')", "@Index('s','k')"])
def test_insert(b, c, ann):
    rng = np.random.default_rng(b * 7 + c + len(ann))
    jt, pt = _tables(ann, c)
    for fill in (c // 2, c):  # half full, then full (overflow)
        st = _state(rng, jt, fill, 2 * c)
        bt = _batch(rng, b, 2 * c)
        jaux, paux = {}, {}
        want = jt.insert(_jstate(st), _jax_batch(bt), jaux)
        got = pt.insert(state_from_numpy(st, "cpu"), _port_batch(bt), paux)
        _same(_np(got), _np(want))
        _same(_flags(paux), _flags(jaux))


# ---------------------------------------------------------------------------
# K22: the sorted index and the indexed update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1, 33, 2047, 2048, 2049, 4097])
@pytest.mark.parametrize("col", ["k", "v", "p", "s"])
def test_rebuild_index(c, col):
    rng = np.random.default_rng(c + len(col))
    jt, pt = _tables("", c)
    st = _state(rng, jt, 2 * c // 3, c // 4 + 1)
    if col == "p":  # -0.0 beside 0.0, +inf, NaN
        p = st["cols"]["p"]
        p[rng.random(c) < 0.1] = -0.0
        p[rng.random(c) < 0.1] = 0.0
        p[rng.random(c) < 0.05] = np.inf
    want = jt._rebuild_index(_jstate(st), col)
    order, sk, dups = K.table_index_build_ref(torch.from_numpy(st["cols"][col].copy()),
                                              torch.from_numpy(st["valid"].copy()))
    _same({"o": order.numpy(), "s": sk.numpy(), "d": dups.numpy()},
          {"o": np.asarray(want[f"ix_order.{col}"]), "s": np.asarray(want[f"ix_sorted.{col}"]),
           "d": np.asarray(want[f"ix_dups.{col}"])})


@pytest.mark.parametrize("c", [2047, 2049])
def test_rebuild_index_every_byte(c):
    """Long keys varying in every byte (the whole int64 range, INT64_MIN/MAX
    among them) at the radix sort's tile edges (one block up to 2,048
    slots, the grid above), against `_rebuild_index`."""
    rng = np.random.default_rng(c)
    jt, _pt = _tables("", c)
    st = _state(rng, jt, 2 * c // 3, c // 4 + 1)
    k = rng.integers(LONG_NULL, np.iinfo(np.int64).max, c, endpoint=True).astype(np.int64)
    k[:4] = [LONG_NULL, np.iinfo(np.int64).max, 0, -1]
    k[rng.random(c) < 0.05] = 7  # ties among the valid and the empty slots
    st["cols"]["k"] = k
    want = jt._rebuild_index(_jstate(st), "k")
    order, sk, dups = K.table_index_build_ref(torch.from_numpy(k.copy()),
                                              torch.from_numpy(st["valid"].copy()))
    _same({"o": order.numpy(), "s": sk.numpy(), "d": dups.numpy()},
          {"o": np.asarray(want["ix_order.k"]), "s": np.asarray(want["ix_sorted.k"]),
           "d": np.asarray(want["ix_dups.k"])})


def test_winner_scratch_is_per_table_column():
    """The indexed probe's writer scratch: int32 [C] all -1, one a table
    and column, so two tables of one capacity never share one in flight."""
    _jt, a_t = _tables("@PrimaryKey('k') @Index('p')", 5)
    _jt, b_t = _tables("@PrimaryKey('k') @Index('p')", 5)
    cpu = torch.device("cpu")
    a = a_t.winner_scratch("k", cpu)
    assert a.dtype == torch.int32 and a.tolist() == [-1] * 5
    assert a_t.winner_scratch("k", cpu) is a
    assert a_t.winner_scratch("p", cpu) is not a
    assert b_t.winner_scratch("k", cpu) is not a
    assert K.winner_scratch(cpu, 0).shape == (1,)


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("col,probe", [("k", "k"), ("k", "v + 0"), ("k", "p"), ("k", "k * 1.5"),
                                       ("p", "p"), ("p", "k")])
@pytest.mark.parametrize("unique", [True, False])
def test_update_indexed(b, c, col, probe, unique):
    """`update T set T.v = v, T.p = p on T.<col> == <probe>` down the
    indexed path; a probe that is a float (fractional or not) meets long
    keys under promotion; float keys hold NaN, -0.0 beside 0.0 and +inf; a
    null probe matches nothing."""
    rng = np.random.default_rng(b + c + len(probe) + unique + len(col))
    jt, pt = _tables(f"@Index('{col}')", c)
    st = _state(rng, jt, 3 * c // 4, 2 * c, dup=not unique)
    if col == "p":
        p = st["cols"]["p"]
        p[rng.random(c) < 0.1] = -0.0
        p[rng.random(c) < 0.05] = np.inf
        js = jt._rebuild_pk_index(_jstate(st))
        st = {**{n: np.array(v) for n, v in js.items() if n != "cols"},
              "cols": {n: np.array(v) for n, v in js["cols"].items()}}
    bt = _batch(rng, b, 2 * c)
    bt["cols"]["p"] = np.where(rng.random(b) < 0.5, bt["cols"]["k"].astype(np.float32),
                               bt["cols"]["p"]).astype(np.float32)
    js, ps = _scopes(jt, pt)
    expr = JaxCompiler.parse_expression(probe)
    set_ql = [SiddhiCompiler.parse_store_query(
        "from T select k update T set T.v = v, T.p = p on T.k == k").output_stream]
    jsets = jax_sets(jt, _jax_set_attrs(), js)
    psets = compile_set_attributes(pt, set_ql[0].set_attributes, ps)
    jstate = _jstate(st)
    jb = _jax_batch(bt)
    rows = jb.valid & (jb.kind == 0)
    want = jt._update_indexed(jstate, jb, col, jax_compile(expr, js), jsets, "__out__",
                              jnp.asarray(0, jnp.int64), rows)
    pb = _port_batch(bt)
    got = pt._update_indexed(state_from_numpy(st, "cpu"), pb, col,
                             compile_expression(SiddhiCompiler.parse_expression(probe), ps),
                             psets, torch.zeros((), dtype=torch.int64), pb.valid)
    _same(_np(got), _np(want))


def _jax_set_attrs():
    from siddhi_tpu.compiler.siddhi_compiler import SiddhiCompiler as JC

    return JC.parse_store_query(
        "from T select k update T set T.v = v, T.p = p on T.k == k").output_stream.set_attributes


# ---------------------------------------------------------------------------
# K23: the condition match, the dense update, delete and `in`
# ---------------------------------------------------------------------------

CONDS = ["T.k == k", "T.k >= k and T.k < k + 8", "T.p > p or T.s == s",
         "not (T.v % 7 == v % 7) and T.p is null", "v > 0", "T.v / (k - 3) < 2"]


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("cond", CONDS)
def test_match_reductions(b, c, cond):
    rng = np.random.default_rng(b * 3 + c + len(cond))
    jt, pt = _tables("", c)
    st = _state(rng, jt, c // 2 + 1, c)
    bt = _batch(rng, b, c)
    js, ps = _scopes(jt, pt)
    jon = jax_compile(JaxCompiler.parse_expression(cond), js)
    jstate = _jstate(st)
    jb = _jax_batch(bt)
    m = np.asarray(jt.match(jstate, jb.cols, jb.ts, "__out__", jon, jnp.asarray(0, jnp.int64)))
    rows = bt["valid"]
    pair = m & rows[:, None]
    want_writer = np.where(pair, np.arange(b)[:, None], -1).max(axis=0).astype(np.int32)
    on = TableOn(pt, SiddhiCompiler.parse_expression(cond), ps)
    pst = state_from_numpy(st, "cpu")
    pb = _port_batch(bt)
    now = torch.zeros((), dtype=torch.int64)
    got_writer = on.match(pst, pb, now, pb.valid, K.MODE_WRITER).numpy()
    got_delete = on.match(pst, pb, now, pb.valid, K.MODE_DELETE).numpy()
    got_in = on.match(pst, pb, now, pb.valid, K.MODE_IN).numpy()
    assert np.array_equal(got_writer, want_writer)
    assert np.array_equal(got_delete, pair.any(axis=0))
    assert np.array_equal(got_in, m.any(axis=1))


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("cond", CONDS[:3])
def test_update_dense_and_delete(b, c, cond):
    rng = np.random.default_rng(b * 5 + c + len(cond))
    jt, pt = _tables("@Index('k')", c)
    st = _state(rng, jt, 2 * c // 3, c)
    bt = _batch(rng, b, c)
    js, ps = _scopes(jt, pt)
    jon = jax_compile(JaxCompiler.parse_expression(cond), js)
    jsets = jax_sets(jt, _jax_set_attrs(), js)
    jstate = _jstate(st)
    jb = _jax_batch(bt)
    now = jnp.asarray(0, jnp.int64)
    rows = jb.valid & (jb.kind == 0)
    want_u = jt._update_dense(jstate, jb, jon, jsets, "__out__", now, rows)
    want_d = jt.delete(jstate, jb, jon, "__out__", now, {})
    on = TableOn(pt, SiddhiCompiler.parse_expression(cond), ps)
    psets = compile_set_attributes(pt, SiddhiCompiler.parse_store_query(
        "from T select k update T set T.v = v, T.p = p on T.k == k"
    ).output_stream.set_attributes, ps)
    op = _UpdateOp(on=on, set_fns=psets, parallel_ok=True, pk_probe=None, scan=None,
                   reindex_after=lambda: False)
    pb = _port_batch(bt)
    pnow = torch.zeros((), dtype=torch.int64)
    got_u = pt._update_dense(state_from_numpy(st, "cpu"), pb, op, pnow, pb.valid)
    got_d = pt.delete(state_from_numpy(st, "cpu"), pb, on, pnow)
    _same(_np(got_u), _np(want_u))
    _same(_np(got_d), _np(want_d))


@pytest.mark.parametrize("b,c", SIZES)
def test_in_condition(b, c):
    """`(T.s == s and T.v > v) in T` through both executors."""
    from siddhi_tpu.core.executor import Env as JaxEnv

    rng = np.random.default_rng(b + 11 * c)
    jt, pt = _tables("", c)
    st = _state(rng, jt, c // 2 + 1, c)
    bt = _batch(rng, b, c)
    expr_ql = "(T.s == s and T.v > v) in T"
    js = JaxScope(jt.interner)
    js.add_stream("S", _jax_types())
    js.add_table(jt)
    jfn = jax_compile(JaxCompiler.parse_expression(expr_ql), js)
    jstate = _jstate(st)
    jenv = JaxEnv({("S", None, n): jnp.asarray(v) for n, v in bt["cols"].items()},
                  tables={"T": jstate})
    ps = Scope(pt.interner, "cpu")
    ps.add_stream("S", dict(OUT))
    ps.add_table(pt)
    pfn = compile_expression(SiddhiCompiler.parse_expression(expr_ql), ps)
    pt.state = state_from_numpy(st, "cpu")
    penv = Env({("S", None, n): torch.from_numpy(v.copy()) for n, v in bt["cols"].items()})
    assert np.array_equal(pfn(penv).numpy(), np.asarray(jfn(jenv)))


# ---------------------------------------------------------------------------
# K24: the sequential update (rekey guard) and the update-or-insert
# ---------------------------------------------------------------------------

SEQ = {
    # (on, set clause or None, primary key): the guard arms when the set
    # writes the single key to a value the on-clause does not pin
    "accumulate": ("T.k == k", "set T.v = T.v + v", ""),
    "range_chain": ("T.k >= k and T.k < k + 4", "set T.v = T.v * 2 + v, T.p = p", ""),
    "rekey": ("T.v == v or T.s == s", "set T.k = k", "@PrimaryKey('k')"),
    "rekey_two": ("T.s == s", "set T.k = k + 1, T.v = T.v - 1", "@PrimaryKey('k')"),
}


def _seq_ops(jt, pt, on_ql, set_ql):
    sq = f"from T select k update T {set_ql or ''} on {on_ql}"
    jout = JaxCompiler.parse_store_query(sq).output_stream
    pout = SiddhiCompiler.parse_store_query(sq).output_stream
    js, ps = _scopes(jt, pt)
    jon = jax_compile(jout.on, js)
    jsets = jax_sets(jt, jout.set_attributes, js)
    psets = compile_set_attributes(pt, pout.set_attributes, ps)
    return js, ps, jon, jsets, pout, psets


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("case", sorted(SEQ))
def test_update_sequential(b, c, case):
    on_ql, set_ql, ann = SEQ[case]
    rng = np.random.default_rng(b * 13 + c + len(case))
    jt, pt = _tables(ann, c)
    st = _state(rng, jt, 3 * c // 4, 2 * c, dup=not ann)
    bt = _batch(rng, b, 2 * c)
    bt["cols"]["v"] = np.where(rng.random(b) < 0.5, st["cols"]["v"][rng.integers(0, c, b)],
                               bt["cols"]["v"])
    _js, ps, jon, jsets, pout, psets = _seq_ops(jt, pt, on_ql, set_ql)
    guard = "k" if ann and "k" in {n for n, _ in psets} else None
    jstate = _jstate(st)
    jaux, paux = {}, {}
    want = jt.update(jstate, _jax_batch(bt), jon, jsets, "__out__", jnp.asarray(0, jnp.int64),
                     jaux, parallel_ok=False, pk_guard=guard)
    scan = build_scan_programs(pt, ps, pout.on, pout.set_attributes, [n for n, _ in psets],
                               guard)
    op = _UpdateOp(on=None, set_fns=psets, parallel_ok=False, pk_probe=None, scan=scan,
                   reindex_after=lambda: False)
    got = pt.update(state_from_numpy(st, "cpu"), _port_batch(bt), op,
                    torch.zeros((), dtype=torch.int64), paux)
    _same(_np(got), _np(want))
    _same(_flags(paux), _flags(jaux))


@pytest.mark.parametrize("b,c", SIZES)
@pytest.mark.parametrize("set_ql", [None, "set T.v = T.v + v, T.p = p"])
@pytest.mark.parametrize("fill", ["half", "full"])
def test_update_or_insert(b, c, set_ql, fill):
    rng = np.random.default_rng(b * 17 + c + (set_ql is None) + len(fill))
    jt, pt = _tables("@PrimaryKey('k')", c)
    st = _state(rng, jt, c // 2 if fill == "half" else c, 3 * c // 2, dup=False)
    bt = _batch(rng, b, 3 * c // 2)
    sq = f"from T select k, v, p, s update or insert into T {set_ql or ''} on T.k == k"
    jout = JaxCompiler.parse_store_query(sq).output_stream
    pout = SiddhiCompiler.parse_store_query(sq).output_stream
    js, ps = _scopes(jt, pt)
    jsets = jax_sets(jt, jout.set_attributes, js)
    psets = compile_set_attributes(pt, pout.set_attributes, ps)
    jstate = _jstate(st)
    jaux, paux = {}, {}
    want = jt.update_or_insert(jstate, _jax_batch(bt), jax_compile(jout.on, js), jsets, "__out__",
                               jnp.asarray(0, jnp.int64), jaux,
                               insert_names=["k", "v", "p", "s"])
    op = _UpsertOp(build_scan_programs(pt, ps, pout.on, pout.set_attributes,
                                       [n for n, _ in psets]),
                   dict(zip(pt.schema.attr_names, ["k", "v", "p", "s"])))
    got = pt.update_or_insert(state_from_numpy(st, "cpu"), _port_batch(bt), op,
                              torch.zeros((), dtype=torch.int64), paux)
    _same(_np(got), _np(want))
    _same(_flags(paux), _flags(jaux))


def test_table_programs_raise_outside_their_operations():
    """A table-dependent subtree the program cannot hold raises at app
    creation; a probe-only one is a register."""
    _jt, pt = _tables("", 8)
    _js, ps = _scopes(_jt, pt)
    prog = emit_program(SiddhiCompiler.parse_expression("T.v > convert(v, 'long') + 1"), ps, "T")
    assert [ins[0] for ins in prog.code][:2] == [K.OP_TAB, 1]
    from siddhi_tpu_torch.core.errors import SiddhiAppCreationError

    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        emit_program(SiddhiCompiler.parse_expression("convert(T.v, 'int') > 1"), ps, "T")


# the update-or-insert by key groups (K24's decomposition on the card):
# (on, set clause or None, primary key, whether the rows' inserts hold their
# own keys, so the groups route runs rather than the walk)
GROUPS = {
    "pk": ("T.k == k", None, "@PrimaryKey('k')", True),
    "pk_accumulate": ("T.k == k", "set T.v = T.v + v", "@PrimaryKey('k')", True),
    "non_unique": ("T.k == k", "set T.v = T.v + v, T.p = p", "", True),
    "float_key": ("T.p == p", "set T.v = T.v - v", "", True),
    "string_key": ("T.s == s", "set T.v = T.v * 2 + v", "", True),
    "other_key": ("T.k == v", "set T.v = T.v + 1", "", False),
    "key_rewritten": ("T.k == k", "set T.k = v, T.v = v", "", False),
}


@pytest.mark.parametrize("b,c", [(1, 1), (33, 33), (513, 33), (513, 4097)])
@pytest.mark.parametrize("fill", ["empty", "half", "nearly_full"])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_update_or_insert_by_key_groups(b, c, fill, case, monkeypatch):
    """`table_upsert_groups_ref` (rows grouped by key, each slot held at
    step start walking its group's rows, the first row of a group with no
    slot inserting at the k-th free slot by rank) through
    `InMemoryTable.update_or_insert` against the JAX package's serial
    `update_or_insert`: repeated new keys in one batch, null and NaN keys,
    a table filling up mid-batch, a non-unique key, a key set clause, every
    lane exact; the rows whose inserts do not hold their own keys take the
    walk."""
    on_ql, set_ql, ann, grouped = GROUPS[case]
    rng = np.random.default_rng(b * 19 + c + len(case) + len(fill))
    jt, pt = _tables(ann, c)
    n_valid = {"empty": 0, "half": c // 2, "nearly_full": max(c - 3, 0)}[fill]
    st = _state(rng, jt, n_valid, max(c // 2, 2), dup=not ann)
    bt = _batch(rng, b, max(c // 2, 2))
    # repeated keys within the batch, and keys the table holds
    bt["cols"]["k"][::3] = bt["cols"]["k"][0]
    bt["cols"]["p"][1::4] = st["cols"]["p"][rng.integers(0, c, len(bt["cols"]["p"][1::4]))]
    sq = f"from T select k, v, p, s update or insert into T {set_ql or ''} on {on_ql}"
    jout = JaxCompiler.parse_store_query(sq).output_stream
    pout = SiddhiCompiler.parse_store_query(sq).output_stream
    js, ps = _scopes(jt, pt)
    jsets = jax_sets(jt, jout.set_attributes, js)
    psets = compile_set_attributes(pt, pout.set_attributes, ps)
    jaux, paux = {}, {}
    want = jt.update_or_insert(_jstate(st), _jax_batch(bt), jax_compile(jout.on, js), jsets,
                               "__out__", jnp.asarray(0, jnp.int64), jaux,
                               insert_names=["k", "v", "p", "s"])
    op = _UpsertOp(build_scan_programs(pt, ps, pout.on, pout.set_attributes,
                                       [n for n, _ in psets]),
                   dict(zip(pt.schema.attr_names, ["k", "v", "p", "s"])))
    walks = []
    walk = K.table_upsert_scan_ref
    monkeypatch.setattr(K, "table_upsert_scan", K.table_upsert_groups_ref)
    monkeypatch.setattr(K, "table_upsert_scan_ref", lambda *a: walks.append(1) or walk(*a))
    got = pt.update_or_insert(state_from_numpy(st, "cpu"), _port_batch(bt), op,
                              torch.zeros((), dtype=torch.int64), paux)
    _same(_np(got), _np(want))
    _same(_flags(paux), _flags(jaux))
    assert K.key_set_reg(op.scan) is not None
    if grouped:
        assert not walks
