"""The keyed pattern routes inside a partition against the JAX package, on the
CPU, with inputs made from a seed with numpy: the plain K34
`partition_pattern_advance_ref` and K36 `partition_pattern_emit_ref` (the
fast route), K35 `partition_pattern_count_ref` with K34 on the tail slots
and K36 (the count route), and K37 `partition_pattern_scan_ref` (the
per-event scan, data and TIMER rows), each over a whole batch, against
`jax.vmap` over P partition lanes of the JAX route function
(`PatternProgram.apply_batch_fast` / `apply_batch_count` chunk by chunk,
`apply_event` row by row) on [P]-tiled token tables, each lane seeing its
own rows and every TIMER row valid (siddhi_tpu/core/partition.py
`_pstep_impl`'s masks); then the JAX [P, out_cap] emissions flattened by
(position, lane) and compacted (`_flatten`) against the port's
`pattern_place` of its emission stretches. P 1/8/33, B 1/33/513, T 4/8/16;
chunks cut across a slot's rows, slots at their initial table (first used
in this batch), TIMER rows, forks past one slot's free lanes, one slot
emitting past its buffer, NaN and -0.0 captures; the chunk lists and the
row lists against a direct computation.

Tolerances: everything is exact — every lane of the token table, the entry
rows, the emissions, their counts, the overflow flag and next_timer. The
routes only compare, place, rank and gather values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core import pattern as pm  # noqa: E402
from siddhi_tpu_torch.core.event import KIND_TIMER, EventBatch  # noqa: E402
from siddhi_tpu_torch.core.pattern_runtime import PatternPartition  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.ops import partition as K  # noqa: E402

HEAD = ("define stream S (symbol string, price float, volume long);\n"
        "define stream S2 (symbol string, price float, volume long);\n")
T0 = 1_700_000_000_000

FAST = {
    "every_within": "from every a=S[price > 50] -> b=S[price < 40] within 30 milliseconds "
                    "select a.symbol as s1, b.symbol as s2, a.price as pa, b.price as pb",
    "cross_ref": "from every a=S[price > 40] -> b=S[price < a.price] -> c=S[volume > b.volume] "
                 "select a.price as pa, b.price as pb, c.volume as vc",
    "sequence": "from every a=S[price > 50], b=S[price < 50] select a.symbol as s, b.price as pb",
    "two_stream": "from every a=S[price > 50] -> b=S2[price < a.price] "
                  "select a.symbol as s1, b.price as pb",
}
COUNT = {
    "every_2_4": "from every a=S[price > 60]<2:4> -> b=S[price < 40] "
                 "select a[0].price as p0, a[last].price as pl, b.price as pb",
    "tail": "from every a=S[price > 85]<1:3> -> b=S[price < 15] -> c=S[volume > b.volume] "
            "select a[0].volume as v0, b.volume as vb, c.volume as vc",
}
SCAN = {
    "absent_for": "from every e1=S[price > 80] -> not S[price < 10] for 40 milliseconds "
                  "select e1.symbol as s, e1.price as p",
    "logical_and": "from every (e1=S[price > 50] and e2=S[volume > 500]) -> "
                   "e3=S[price < e1.price - 30] select e1.price as p1, e3.price as p3",
    "both_absent": "from e1=S[price > 60] -> not S[price > 90] for 30 milliseconds and "
                   "not S2[price > 90] for 50 milliseconds select e1.price as p1",
    "seq_count": "from every e1=S[price > 50]<1:3>, e2=S[price < 50] "
                 "select e1[0].price as a0, e1[last].price as al, e2.price as b",
    "two_stream": "from every e1=S[price > 50] -> not S2[price < 40] for 20 milliseconds "
                  "select e1.price as p1",
}


def _progs(ql: str, T: int):
    app = (f"@app:patternCapacity(size='{T}') @app:batch(size='64')\n{HEAD}"
           f"@info(name='q') {ql} insert into Out;")
    jq = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app).queries["q"]
    pq = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(app).queries["q"]
    return jq, pq


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _values(rng, dtype, shape, specials=False):
    if dtype == np.float32:
        v = rng.uniform(0, 100, shape).astype(np.float32)
        if specials:  # NaN and -0.0 captures travel bit for bit
            v[rng.random(shape) < 0.1] = np.nan
            v[rng.random(shape) < 0.1] = -0.0
        return v
    if dtype == np.int32:
        return rng.integers(1, 9, shape).astype(np.int32)
    return rng.integers(1, 1000, shape).astype(dtype)


def _tiled_tok(prog, rng, p, density, count_route=False, virgin=0.2):
    """[P, T] random token tables (numpy, JAX's layout); about `virgin` of
    the slots keep the initial table (keys first seen in this batch)."""
    one = _np(prog.init_state(T0))
    tok = jax.tree_util.tree_map(lambda x: np.repeat(x[None], p, axis=0).copy(), one)
    T, S = prog.T, len(prog.slots)
    for q in range(p):
        if rng.random() < virgin:
            continue
        act = rng.random(T) < density
        act[0] = True
        slot = rng.integers(0, S, T).astype(np.int32)
        slot[0] = 0
        start = np.where(rng.random(T) < 0.3, -1, T0 - rng.integers(0, 60, T))
        start[0] = -1
        tok["active"][q], tok["slot"][q] = act, slot
        tok["start_ts"][q] = start.astype(np.int64)
        tok["entry_ts"][q] = (T0 - rng.integers(0, 30, T)).astype(np.int64)
        if "fwd" in tok:
            tok["fwd"][q] = rng.random(T) < 0.3
        for a, c in zip(prog.refs, tok["caps"]):
            n = rng.integers(0, a.cap + 3 if count_route else 2, T).astype(np.int32)
            n[0] = 0
            c["n"][q] = n
            c["ts"][q] = (T0 - rng.integers(0, 100, c["ts"].shape[1:])).astype(np.int64)
            for name, arr in c["cols"].items():
                arr[q] = _values(rng, arr.dtype, arr.shape[1:], specials=True)
    return tok


def _batch(rng, B, p, timer=0.05, dense=False, one_slot=None):
    ts = (T0 + np.cumsum(rng.integers(0, 4, B))).astype(np.int64)
    kind = np.where(rng.random(B) < timer, KIND_TIMER, 0).astype(np.int8)
    valid = rng.random(B) < 0.95
    slot = rng.integers(0, p + 1, B).astype(np.int32)  # p: a row of no partition
    if one_slot is not None:
        slot[:] = one_slot
    price = (np.where(rng.random(B) < 0.5, 95.0, 5.0) if dense
             else rng.uniform(0, 100, B)).astype(np.float32)
    price[rng.random(B) < 0.05] = np.nan
    price[rng.random(B) < 0.05] = -0.0
    cols = {"symbol": rng.integers(1, 9, B).astype(np.int32), "price": price,
            "volume": rng.integers(1, 1000, B).astype(np.int64)}
    return ts, kind, valid, slot, cols


def _member(kind, valid, slot, p):
    return valid & (kind == 0) & (slot < p)


def _lane_valid(kind, valid, slot, p):
    """[P, B]: the vmap's masks, (active & slot == q) | is_timer."""
    active = _member(kind, valid, slot, p)
    timer = valid & (kind == KIND_TIMER)
    return (active[None, :] & (slot[None, :] == np.arange(p)[:, None])) | timer[None, :]


def _flatten(out, out_n, p):
    """The JAX [P, cap] emissions by (position, lane), compacted: the rows
    `_flatten` keeps valid, as {lane: [rows]} with each row's slot."""
    rows = []
    cap = out["valid"].shape[1]
    for pos in range(cap):
        for q in range(p):
            if out["valid"][q, pos]:
                rows.append((q, pos))
    flat = {k: np.stack([v[q, pos] for q, pos in rows]) if rows else v[:0, 0]
            for k, v in out.items()}
    return flat, np.array([q for q, _pos in rows], dtype=np.int32)


def _check_place(emis, jout, jn, p):
    """The port's placed rows equal JAX's flattened, compacted rows."""
    placed, out_slot, out_first = K.pattern_place(emis.out, emis.off, emis.cap, emis.n, p)
    flat, slots = _flatten(jout, jn, p)
    n = len(slots)
    got = state_to_numpy(placed)
    assert int(got["valid"].sum()) == n
    for k in flat:
        np.testing.assert_equal(got[k][:n], flat[k], err_msg=k)
    np.testing.assert_equal(out_slot.numpy()[:n], slots)
    first = {}
    for i, q in enumerate(slots):
        first.setdefault(q, i)
    np.testing.assert_equal(out_first.numpy()[:n], [first[q] for q in slots])
    return n


def _tok_equal(keyed_tok, jtok, p, lanes=None):
    got = state_to_numpy(pm.tiled_tok(keyed_tok, p))
    want = _np(jtok)
    if lanes is not None:
        got = jax.tree_util.tree_map(lambda x: x[lanes], got)
        want = jax.tree_util.tree_map(lambda x: x[lanes], want)
    np.testing.assert_equal(got, want)


def _chunk_routes(route, app, p, B, T, seed, sid="S", out_cap=None, dense=False,
                  density=0.5, one_slot=None, want_overflow=None):
    apps = FAST if route == "fast" else COUNT
    jq, pq = _progs(apps[app], T)
    jprog, pprog = jq.prog, pq.prog
    rng = np.random.default_rng(seed)
    tok = _tiled_tok(jprog, rng, p, density, count_route=route == "count")
    ts, kind, valid, slot, cols = _batch(rng, B, p, dense=dense, one_slot=one_slot)
    out_cap = out_cap or pq.out_cap
    now = T0 + 500
    # JAX: vmap of the route function over the lanes, chunk by chunk over
    # the padded batch
    C = min(B, pq._chunk)
    pad = (-B) % C
    lv = np.concatenate([_lane_valid(kind, valid, slot, p), np.zeros((p, pad), bool)], 1)
    tsp = np.concatenate([ts, np.zeros(pad, np.int64)])
    kp = np.concatenate([kind, np.zeros(pad, np.int8)])
    colp = {k: np.concatenate([v, np.zeros(pad, v.dtype)]) for k, v in cols.items()}
    fn = jprog.apply_batch_fast if route == "fast" else jprog.apply_batch_count
    step = jax.jit(jax.vmap(lambda tk, t, k, v, c, o, n, f, nw: fn(tk, t, k, v, {sid: c}, o, n,
                                                                       f, nw),
                            in_axes=(0, None, None, 0, None, 0, 0, 0, None)))
    jtok = jax.tree_util.tree_map(jnp.asarray, tok)
    one_out = _np(jprog.init_out(out_cap))
    jout = jax.tree_util.tree_map(lambda x: jnp.asarray(np.repeat(x[None], p, 0)), one_out)
    jn, jovf = jnp.zeros(p, jnp.int32), jnp.zeros(p, jnp.bool_)
    for i in range((B + pad) // C):
        s = slice(i * C, (i + 1) * C)
        jtok, jout, jn, jovf = step(jtok, jnp.asarray(tsp[s]), jnp.asarray(kp[s]),
                                    jnp.asarray(lv[:, s]), {k: jnp.asarray(v[s])
                                                            for k, v in colp.items()},
                                    jout, jn, jovf, jnp.int64(now))
    jout, jn = _np(jout), np.asarray(jn)
    # the port: the keyed chunk loop of the plain versions
    bt = EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid),
                    cols={k: torch.from_numpy(v) for k, v in cols.items()})
    pctx = PatternPartition(slot=torch.from_numpy(slot), used=None, fresh=None, p=p,
                            overflow=None)
    now_t = torch.tensor(now, dtype=torch.int64)
    ktok = pm.keyed_tok(state_from_numpy(tok, "cpu"))
    ch, caps, inputs = pq.keyed_chunk_inputs(bt, now_t, sid, pctx)
    # the chunk lists: each chunk's member rows by (slot, row)
    for i in range(ch.k):
        rows = [r for r in range(i * C, (i + 1) * C) if ch.v[r]]
        want = sorted(rows, key=lambda r: (int(ch.slot[r]), r))
        assert ch.srow[i * C:i * C + len(want)].tolist() == want
    emis = pm.keyed_out(pprog, torch.full((p,), out_cap) if out_cap != pq.out_cap else caps,
                        out_cap)
    entry_row = torch.full((p * T,), -1, dtype=torch.int32)
    ovf = torch.zeros((), dtype=torch.bool)
    for i in range(ch.k):
        pq.keyed_chunk(i, ktok, entry_row, ch, inputs, emis, now_t, ovf)
    _tok_equal(ktok, jtok, p)
    np.testing.assert_equal(np.minimum(emis.n.numpy(), emis.cap.numpy()), jn)
    assert bool(ovf) == bool(np.asarray(jovf).any())
    if want_overflow is not None:
        assert bool(ovf) == want_overflow
    assert (entry_row == -1).all()
    return _check_place(emis, jout, jn, p)


# (P, B, T): each app at two shapes, each route over every P, B and T (most
# of a case's time is the JAX package's compile of its vmapped step)
FAST_CASES = [("every_within", 8, 513, 16), ("every_within", 1, 33, 8),
              ("cross_ref", 33, 33, 4), ("cross_ref", 8, 1, 8),
              ("sequence", 8, 513, 16), ("sequence", 33, 33, 4),
              ("two_stream", 1, 33, 8), ("two_stream", 8, 1, 8)]
COUNT_CASES = [("every_2_4", 8, 513, 16), ("every_2_4", 1, 33, 8),
               ("tail", 33, 33, 4), ("tail", 8, 1, 8)]


@pytest.mark.parametrize("app,p,B,T", FAST_CASES)
def test_fast_route_matches_vmap(app, p, B, T):
    sid = "S2" if app == "two_stream" and B == 33 else "S"
    _chunk_routes("fast", app, p, B, T, seed=B * 31 + T + p, sid=sid)


@pytest.mark.parametrize("app,p,B,T", COUNT_CASES)
def test_count_route_matches_vmap(app, p, B, T):
    _chunk_routes("count", app, p, B, T, seed=B * 37 + T + p)


def test_chunks_across_one_slots_rows():
    """Every row in slot 1 of 3: each chunk boundary cuts its run."""
    assert _chunk_routes("fast", "every_within", 3, 513, 8, seed=3, dense=True, one_slot=1) > 0


def test_fork_overflow_in_one_slot():
    """A dense batch into tables almost full: forks past one slot's free
    lanes are dropped and raise the flag; every other slot runs as JAX."""
    _chunk_routes("fast", "every_within", 8, 513, 4, seed=4, dense=True, density=0.95,
                  want_overflow=True)


def test_emission_overflow_in_one_slot():
    """A per-lane emission buffer of 5 rows: the slots that complete more
    raise the flag and keep their first 5, as each JAX lane does."""
    _chunk_routes("fast", "sequence", 4, 513, 16, seed=5, dense=True, out_cap=5,
                  want_overflow=True)


def _scan_route(app, p, B, T, seed, sid="S", timer_only=False, used_frac=1.0):
    jq, pq = _progs(SCAN[app], T)
    jprog, pprog = jq.prog, pq.prog
    pprog.compile_scan()
    rng = np.random.default_rng(seed)
    tok = _tiled_tok(jprog, rng, p, 0.5)
    ts, kind, valid, slot, cols = _batch(rng, B, p, timer=0.15)
    if timer_only:
        kind[:] = KIND_TIMER
        slot[:] = p
        cols = {}
    seen = np.where(rng.random(p) < 0.5, T0 - 10, -(1 << 62)).astype(np.int64)
    used = rng.random(p) < used_frac
    used[0] = True
    cap = pq.out_cap
    lv = _lane_valid(kind, valid, slot, p)
    # JAX: apply_event row by row, vmapped over the lanes
    jsid = sid if not timer_only else jprog.stream_ids[0]

    def one(tk, t, k, v, c, o, n, f, sn):
        return jprog.apply_event(tk, t, k, v, {jsid: c} if c else {}, o, n, f, timer_seen=sn)

    step = jax.jit(jax.vmap(one, in_axes=(0, None, None, 0, None, 0, 0, 0, 0)))
    jtok = jax.tree_util.tree_map(jnp.asarray, tok)
    one_out = _np(jprog.init_out(cap))
    jout = jax.tree_util.tree_map(lambda x: jnp.asarray(np.repeat(x[None], p, 0)), one_out)
    jn, jovf = jnp.zeros(p, jnp.int32), jnp.zeros(p, jnp.bool_)
    jseen = jnp.asarray(seen)
    for b in range(B):
        jtok, jout, jn, jovf = step(jtok, jnp.asarray(ts[b]), jnp.asarray(kind[b]),
                                    jnp.asarray(lv[:, b]),
                                    {k: jnp.asarray(v[b]) for k, v in cols.items()},
                                    jout, jn, jovf, jseen)
    jout = {k: np.array(v) for k, v in _np(jout).items()}
    jn = np.asarray(jn)
    timer_ts = np.maximum(seen, ts[valid & (kind == KIND_TIMER)].max(initial=-(1 << 62)))
    jnext = np.asarray(jax.vmap(lambda tk, a: jprog.next_timer(tk, after=a))(
        jtok, jnp.asarray(timer_ts)))
    # mask the lanes with no live key, as the vmap's step does
    jout["valid"] &= used[:, None]
    jn = np.where(used, jn, 0)
    # the port
    bt = EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                    valid=torch.from_numpy(valid),
                    cols={k: torch.from_numpy(v) for k, v in cols.items()})
    psid = None if timer_only else sid
    ev, rmask, regs = pprog.scan_inputs(psid, bt)
    rows = K.partition_rows(bt, torch.from_numpy(slot), p)
    member = _member(kind, valid, slot, p)
    for q in range(p):
        want = np.nonzero(member & (slot == q))[0].tolist()
        lo, hi = int(rows.slot_start[q]), int(rows.slot_start[q + 1])
        assert rows.rowlist[lo:hi].tolist() == want
    used_t = torch.from_numpy(used)
    # the runtime's walk: TIMER rows step every slot, as the vmap steps
    # every lane; the other slots' rows are dropped
    walk = np.ones(p, bool) if (valid & (kind == KIND_TIMER)).any() else used
    ktok = pm.keyed_tok(state_from_numpy(tok, "cpu"))
    caps = torch.where(used_t, torch.clamp(2 * rows.rows.to(torch.int64) + 1, max=cap), 0)
    while True:  # the runtime's loop: again with larger stretches past one
        emis = pm.keyed_out(pprog, caps, cap)
        ovf = torch.zeros((), dtype=torch.bool)
        new = pm.partition_pattern_scan(pprog, ktok, psid, bt.ts, bt.kind, bt.valid, ev, rmask,
                                        regs, rows, torch.from_numpy(walk), emis, ovf,
                                        torch.from_numpy(seen))
        if not bool(((emis.n > emis.cap) & used_t).any()):
            break
        caps = torch.where(used_t, torch.maximum(emis.n, emis.cap), 0)
    emis.n = torch.where(used_t, emis.n, 0)
    # every lane: the slots the step does not run are untouched, as the
    # vmap's lanes with no rows
    _tok_equal(new, jtok, p)
    np.testing.assert_equal(emis.n.numpy(), jn)
    assert bool(ovf) == bool(np.asarray(jovf)[walk].any())
    got_next = pprog.next_timer(new, after=torch.from_numpy(timer_ts).repeat_interleave(T),
                                live=used_t.repeat_interleave(T))
    want_next = int(np.where(used, jnext, pm.NO_TIMER).min())
    assert int(got_next) == want_next
    return _check_place(emis, jout, jn, p)


SCAN_CASES = [("absent_for", 8, 33, 8), ("absent_for", 1, 1, 16),
              ("logical_and", 33, 33, 4), ("logical_and", 8, 33, 8),
              ("both_absent", 1, 1, 16), ("both_absent", 33, 33, 4),
              ("seq_count", 8, 33, 8), ("seq_count", 33, 33, 4),
              ("two_stream", 33, 33, 4), ("two_stream", 1, 1, 16)]


@pytest.mark.parametrize("app,p,B,T", SCAN_CASES)
def test_scan_matches_vmap(app, p, B, T):
    sid = "S2" if app == "two_stream" and p == 33 else "S"
    _scan_route(app, p, B, T, seed=B * 41 + T + p, sid=sid, used_frac=0.7)


@pytest.mark.parametrize("app", ["absent_for", "both_absent"])
def test_timer_step_matches_vmap(app):
    """A TIMER batch steps every slot; the unused slots' rows and timers
    are masked, their tables stepped as the vmap's lanes are."""
    _scan_route(app, 33, 2, 8, seed=7, timer_only=True, used_frac=0.6)


def test_scan_at_513_rows():
    assert _scan_route("absent_for", 8, 513, 8, seed=8) > 0


def test_scan_stretches_run_again():
    """Stretches of one row a slot: the step runs again with the rows it
    took, and the emissions equal the vmap's."""
    assert _scan_route("seq_count", 4, 33, 16, seed=9) > 0
