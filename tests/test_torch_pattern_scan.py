"""The pattern engine's per-event scan (K16's plain version) against the JAX
package's, on the CPU: from the same numpy-seeded token tables and rows,
`pattern_scan_ref` (siddhi_tpu_torch) and `PatternProgram.apply_event`
(siddhi_tpu, jitted) apply a step's rows one at a time, and after every row
each token-table lane, the emission buffer, out_n and the overflow flag
must be equal (floats come out bit for bit; NaN equals NaN), and then
`next_timer`. One app per slot kind (logical and/or, absent sides with and
without waiting, both-absent at slot 0 and later, `every not X for t`,
counts in the middle and trailing `<0:n>`, every-blocks, a strict sequence
with a count and its fwd contest, a two-stream sequence, `e[last]` reads,
int/long/float promotion), at T in {8, 64} and B in {1, 33}, with TIMER
rows and a timer_seen past deadlines. The condition programs
(`cond_program_ref`) are held against the compiled filter closures on
random lanes with nulls.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core import pattern as pm  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.core.event import KIND_TIMER, EventBatch  # noqa: E402
from siddhi_tpu_torch.core.executor import TS_ATTR, Env  # noqa: E402
from siddhi_tpu_torch.interop import state_to_numpy  # noqa: E402

HEAD = ("define stream S (symbol string, price float, volume long);\n"
        "define stream S2 (symbol string, price double, volume int);\n")
APPS = {
    "logical_and": "from every (e1=S[price > 50] and e2=S[volume > 500]) -> "
                   "e3=S[symbol == e1.symbol and price < e1.price - 30] within 2 sec "
                   "select e1.symbol as s, e1.price as p1, e2.volume as v2, e3.price as p3",
    "logical_or": "from e1=S[price > 70] or e2=S2[volume > 800] -> e3=S[price < 20] "
                  "select e1.price as p1, e2.volume as v2, e3.price as p3",
    "and_absent_wait": "from every e1=S[price > 60] and not S2[price > 80] for 100 milliseconds "
                       "-> e3=S[price < 10] select e1.price as p1, e3.price as p3",
    "or_absent_wait": "from e0=S[price > 90] -> e1=S[price > 60] or not S2[price > 80] "
                      "for 100 milliseconds select e0.price as p0, e1.price as p1",
    "both_absent_and_0": "from not S[price > 90] for 100 milliseconds and not S2[price > 90] "
                         "for 150 milliseconds -> e3=S[price < 10] select e3.price as p3",
    "both_absent_or_1": "from every e1=S[price > 80] -> not S[price < 5] for 100 milliseconds "
                        "or not S2[price < 5] for 120 milliseconds select e1.price as p1",
    "absent_for": "from every e1=S[price > 80] -> not S[symbol == e1.symbol and price < 10] "
                  "for 100 milliseconds select e1.symbol as s, e1.price as p",
    "absent_no_for": "from e1=S[price > 80] -> not S2[price < 20] and e3=S[price < 10] "
                     "select e1.price as p1, e3.price as p3",
    "every_absent": "from every not S2[price > 90] for 100 milliseconds -> e2=S[price < 20] "
                    "select e2.price as p2",
    "count_middle": "from e1=S[price > 80] -> e2=S[price < 30]<2:4> -> e3=S[price > 90] "
                    "select e1.price as p1, e2[0].price as q0, e2[last].price as ql, "
                    "e3.price as p3",
    "trailing_min0": "from every e1=S[price > 70] -> e2=S[volume > 900]<0:3> "
                     "select e1.price as p1, e2[0].volume as v0",
    "every_block": "from every (e1=S[price > 70] -> e2=S[price < 30]) "
                   "select e1.price as p1, e2.price as p2",
    "every_block_mid": "from e0=S[volume > 950] -> every (e1=S[price > 70] -> e2=S[price < 30]) "
                       "-> e3=S[volume < 50] select e0.volume as v0, e1.price as p1, "
                       "e3.volume as v3",
    "seq_count_fwd": "from every e1=S[price > 50]<1:3>, e2=S[price < 50] "
                     "select e1[0].price as a0, e1[last].price as al, e2.price as b",
    "seq_two_streams": "from every e1=S[price > 50], e2=S2[price < 40] within 1 sec "
                       "select e1.price as p1, e2.price as p2",
    "last_reads": "from every e1=S[price > 60]<2:5> -> "
                  "e2=S[price < e1[last].price - 30 and volume > e1[0].volume] "
                  "select e1[last].price as pl, e1[0].volume as v0, e2.price as p2",
    "cond_promote": "from every e1=S2[volume > 100] -> e2=S[(e1.volume + volume) / 2 > 500 and "
                    "price * 2 >= e1.price and volume % 7 != e1.volume % 5 and "
                    "not (e1.symbol is null)] select e1.volume as v1, e2.volume as v2",
}
T0 = 1_700_000_000_000


def _app(name: str, T: int) -> str:
    return (f"@app:patternCapacity(size='{T}')\n@app:batch(size='64')\n" + HEAD
            + f"@info(name='q') {APPS[name]} insert into Out;")


def _progs(ql: str):
    jprog = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql).queries["q"].prog
    pprog = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(
        ql).queries["q"].prog
    pprog.compile_scan()
    return jprog, pprog


def _random_tok(prog, rng, density):
    """A token table of random lanes (some virgin, some null captures)."""
    T, S = prog.T, len(prog.slots)
    tok = prog.init_state(T0)
    tok["active"] = torch.from_numpy(rng.random(T) < density)
    tok["slot"] = torch.from_numpy(rng.integers(0, S, T).astype(np.int32))
    tok["start_ts"] = torch.from_numpy(
        np.where(rng.random(T) < 0.3, -1, T0 - rng.integers(0, 3000, T)).astype(np.int64))
    tok["entry_ts"] = torch.from_numpy((T0 - rng.integers(0, 400, T)).astype(np.int64))
    if "fwd" in tok:
        tok["fwd"] = torch.from_numpy(rng.random(T) < 0.3)
    for a, c in zip(prog.refs, tok["caps"]):
        c["n"] = torch.from_numpy(rng.integers(0, a.cap + 2, T).astype(np.int32))
        c["ts"] = torch.from_numpy((T0 - rng.integers(0, 400, tuple(c["ts"].shape))))
        for name, arr in list(c["cols"].items()):
            c["cols"][name] = torch.from_numpy(_column(rng, name, arr.dtype, tuple(arr.shape)))
    return tok


def _column(rng, name, dtype, shape):
    """Random values of an attribute, about one in ten null."""
    null = rng.random(shape) < 0.1
    if dtype == torch.float32:
        v = rng.uniform(0, 100, shape).astype(np.float32)
        v[null] = np.nan
    elif name == "symbol":
        v = rng.integers(0, 5, shape).astype(np.int32)  # id 0 is null
    elif dtype == torch.int64:
        v = rng.integers(1, 1000, shape).astype(np.int64)
        v[null] = np.iinfo(np.int64).min
    else:
        v = rng.integers(1, 1000, shape).astype(np.int32)
        v[null] = np.iinfo(np.int32).min
    return v


def _random_batch(prog, rng, sid, B):
    """B rows of stream sid (None: TIMER rows only), 0-60 ms apart, a few
    TIMER and invalid rows among them."""
    ts = (T0 + np.cumsum(rng.integers(0, 60, B))).astype(np.int64)
    kind = np.where(rng.random(B) < 0.05, KIND_TIMER, 0).astype(np.int8)
    if sid is None:
        kind[:] = KIND_TIMER
    valid = rng.random(B) < 0.95
    cols = {}
    for name, t in prog.schemas[sid or prog.stream_ids[0]].attrs:
        dtype = torch.float32 if t.name in ("FLOAT", "DOUBLE") else (
            torch.int64 if t.name == "LONG" else torch.int32)
        cols[name] = torch.from_numpy(_column(rng, name, dtype, (B,)))
    return EventBatch(ts=torch.from_numpy(ts), kind=torch.from_numpy(kind),
                      valid=torch.from_numpy(valid), cols=cols)


def _jax_step(jprog, sid):
    def step(tok, ts, kind, valid, cols, out, out_n, ovf, seen):
        return jprog.apply_event(tok, ts, kind, valid, {sid: cols}, out, out_n, ovf,
                                 timer_seen=seen)

    return jax.jit(step)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("T", [8, 64])
@pytest.mark.parametrize("name", sorted(APPS))
def test_scan_ref_against_apply_event(name, T):
    jprog, pprog = _progs(_app(name, T))
    checked = 0
    for sid in pprog.stream_ids:
        step = _jax_step(jprog, sid)
        for case, (B, timer, density, seen_after) in enumerate(
                [(33, False, 0.5, False), (33, False, 0.95, True), (1, False, 0.2, False),
                 (33, True, 0.6, True)]):
            rng = np.random.default_rng(1000 * T + 10 * case + pprog.stream_ids.index(sid))
            tok = _random_tok(pprog, rng, density)
            before = (tok["active"].clone(), tok["slot"].clone())
            # a TIMER batch: the port's step has no stream, the JAX step
            # ignores its columns on TIMER rows
            psid = None if timer else sid
            batch = _random_batch(pprog, rng, psid, B)
            ev, rmask, regs = pprog.scan_inputs(psid, batch)
            cap = 12 if case == 1 else 64  # case 1 overflows its emission buffer
            pout, jout = pprog.init_out(cap), jprog.init_out(cap)
            out_n = torch.full((), 3 if case == 1 else 0, dtype=torch.int32)
            jn = jnp.int32(int(out_n))
            ovf, jovf = torch.zeros((), dtype=torch.bool), jnp.bool_(False)
            seen = torch.tensor(T0 + (250 if seen_after else -(1 << 40)), dtype=torch.int64)
            jtok = jax.tree_util.tree_map(jnp.asarray, state_to_numpy(tok))
            for b in range(B):
                row = slice(b, b + 1)
                tok, pout, out_n, ovf = pm.pattern_scan_ref(
                    pprog, tok, psid, batch.ts[row], batch.kind[row], batch.valid[row],
                    {k: v[row] for k, v in ev.items()}, rmask[:, row], [r[row] for r in regs],
                    pout, out_n, ovf, seen)
                cols = {k: jnp.asarray(v.numpy()[b]) for k, v in batch.cols.items()}
                jtok, jout, jn, jovf = step(
                    jtok, jnp.asarray(batch.ts.numpy()[b]), jnp.asarray(batch.kind.numpy()[b]),
                    jnp.asarray(batch.valid.numpy()[b]), cols, jout, jn, jovf,
                    jnp.asarray(int(seen), dtype=jnp.int64))
                np.testing.assert_equal(state_to_numpy(tok), _np(jtok), err_msg=f"row {b}")
                np.testing.assert_equal(state_to_numpy(pout), _np(jout), err_msg=f"row {b}")
                assert int(out_n) == int(jn) and bool(ovf) == bool(jovf), f"row {b}"
            want = int(np.asarray(jprog.next_timer(jtok, after=jnp.int64(int(seen)))))
            assert int(pprog.next_timer(tok, after=seen)) == want
            checked += int(out_n) + int(((tok["active"] != before[0])
                                         | (tok["slot"] != before[1])).sum())
    assert checked > 0  # rows emitted or lanes moved: the cases exercise the scan


# ---------------------------------------------------------------------------
# condition programs against the compiled closures
# ---------------------------------------------------------------------------

COND_APPS = {
    "cross_ref": APPS["logical_and"],
    "last_reads": APPS["last_reads"],
    "promote": APPS["cond_promote"],
    "arith_nulls": "from every e1=S2[volume > 0] -> e2=S[(volume - e1.volume) * 3 > e1.price / 2 "
                   "or e1.volume % 4 == volume % 4 or price / e1.volume <= 0.5] "
                   "select e1.volume as v1, e2.volume as v2",
    "div_zero_ids": "from every e1=S[price > 0] -> e2=S2[volume / (e1.volume - e1.volume) == -1 "
                    "and symbol != e1.symbol and e1.price % price >= 0.0] "
                    "select e1.volume as v1, e2.volume as v2",
    "null_forms": "from every e1=S[price > 0]<1:3> -> e2=S[e1[1].price is null or "
                  "e1[last - 1].volume < volume or e1[5].price is null or e1[2] is null] "
                  "select e2.volume as v2",
}


def _token_env(prog, tok, atom, ev_row: dict, ts: int) -> Env:
    """The JAX package's _token_env: capture columns of every ref, the
    current event as the atom's own un-indexed keys."""
    T = prog.T
    cols = {}
    for a in prog.refs:
        c = tok["caps"][a.ref_idx]
        for name in c["cols"]:
            cols[(a.ref, None, name)] = c["cols"][name][:, 0]
            for k in range(a.cap):
                cols[(a.ref, k, name)] = c["cols"][name][:, k]
        cols[(a.ref, None, TS_ATTR)] = c["ts"][:, 0]
        for k in range(a.cap):
            cols[(a.ref, k, TS_ATTR)] = c["ts"][:, k]
        cols[(a.ref, None, "__arrived__")] = c["n"] > 0
    prog._synth_capture_cols(cols, lambda a, attr: tok["caps"][a.ref_idx]["cols"][attr],
                             lambda a: tok["caps"][a.ref_idx]["ts"],
                             lambda a: tok["caps"][a.ref_idx]["n"])
    for name, v in ev_row.items():
        cols[(atom.ref, None, name)] = v.expand(T)
    cols[(atom.ref, None, TS_ATTR)] = torch.full((T,), ts, dtype=torch.int64)
    cols[(atom.ref, None, "__arrived__")] = torch.ones(T, dtype=torch.bool)
    return Env(cols)


@pytest.mark.parametrize("name", sorted(COND_APPS))
def test_cond_program_against_closures(name):
    """Each atom's row filters with its condition programs equal the AND of
    its compiled filters over the token environment, lane for lane."""
    ql = (f"@app:patternCapacity(size='64')\n" + HEAD
          + f"@info(name='q') {COND_APPS[name]} insert into Out;")
    prog = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(
        ql).queries["q"].prog
    prog.compile_scan()
    n_progs = 0
    for seed in range(4):
        rng = np.random.default_rng(seed)
        tok = _random_tok(prog, rng, 0.8)
        for sid in prog.stream_ids:
            batch = _random_batch(prog, rng, sid, 9)
            _ev, rmask, regs = prog.scan_inputs(sid, batch)
            for slot in prog.slots:
                for atom in slot.atoms:
                    if atom.stream_id != sid:
                        continue
                    codes = prog._progs[(slot.index, atom.ref_idx)]
                    n_progs += len(codes)
                    for b in range(9):
                        ev_row = {k: v[b] for k, v in batch.cols.items()}
                        env = _token_env(prog, tok, atom, ev_row, int(batch.ts[b]))
                        want = torch.ones(prog.T, dtype=torch.bool)
                        for c in prog._conds[(slot.index, atom.ref_idx)]:
                            want = want & torch.broadcast_to(c(env), (prog.T,))
                        got = rmask[atom.ref_idx, b].expand(prog.T).clone()
                        for cp in codes:
                            got = got & pm.cond_program_ref(prog, cp, tok, [r[b] for r in regs])
                        assert torch.equal(got, want), (slot.index, atom.ref, b)
    assert n_progs > 0


def test_unported_condition_raises():
    """A token-dependent function call is outside the condition programs:
    creating a scan-route app with one raises "not ported yet"."""
    ql = HEAD + ("@info(name='q') from every (e1=S[price > 50] and e3=S2[volume > 5]) -> "
                 "e2=S[price < maximum(e1.price, 10.0)] select e2.price as p insert into Out;")
    with pytest.raises(SiddhiAppCreationError, match="not ported yet"):
        siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
