"""The pattern slice's kernel-bearing functions against the JAX package, on
the CPU, with inputs made from a seed with numpy: one chunk of
`PatternProgram.apply_batch_fast` (the slot passes of K13 `pattern_advance`
and the completions of K15 `pattern_emit`) and of `apply_batch_count` (K14
`pattern_count`, K13 on the tail slots, K15) from random token tables —
random active lanes, slots, start/entry timestamps, counts and captures —
over random chunks with holes, TIMER rows and 0-3 ms steps, into an
emission buffer that may already be nearly full.

Tolerances: everything is exact, every lane of the token table and the
emission buffer, out_n and the overflow flag. The functions only compare,
place, rank and gather values; no arithmetic on floats happens in them.
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
from siddhi_tpu_torch.core.pattern_runtime import PatternQueryRuntime  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402

SCHEMA = """define stream S (symbol string, price float, volume long);
define stream S2 (symbol string, price float, volume long);
"""

FAST_APPS = {
    # every + within, row-only conditions (pattern_2state's form)
    "every_within": "from every a=S[price > 50] -> b=S[price < 40] within 30 milliseconds "
                    "select a.symbol as s1, b.symbol as s2, a.price as pa, b.volume as vb",
    # no every, a cross-ref condition and a three-slot chain
    "chain_cross_ref": "from a=S[price > 30] -> b=S[price < a.price] -> c=S[volume > b.volume] "
                       "select a.price as pa, b.price as pb, c.volume as vc",
    # every + cross-ref + within at the last slot only
    "every_cross_ref": "from every a=S[price > 60] -> b=S[price < a.price and volume > 100] "
                       "within 20 milliseconds select a.volume as va, b.volume as vb",
    # single-stream sequence strictness, every at the first slot
    "sequence_every": "from every a=S[price > 50], b=S[price < 50] "
                      "select a.symbol as s1, b.price as pb",
    # a strict sequence without every, cross-ref
    "sequence_chain": "from a=S[price > 20], b=S[price > a.price], c=S[price < b.price] "
                      "select a.price as pa, b.price as pb, c.price as pc",
    # two streams: each step sees one of them
    "two_stream": "from every a=S[price > 50] -> b=S2[price < a.price] "
                  "select a.symbol as s1, b.symbol as s2",
}

COUNT_APPS = {
    # count_sequence's form, with indexed and last reads
    "every_2_4": "from every a=S[price > 60]<2:4> -> b=S[price < 40] "
                 "select a[0].volume as v0, a[1].volume as v1, a[last].price as pl, "
                 "b.symbol as sb",
    # no every, unbounded
    "plus_unbounded": "from a=S[price > 60]<2:> -> b=S[price < 30] "
                      "select a[0].volume as v0, a[last].volume as vl, b.volume as vb",
    # min above the capture capacity (countCapacity 8)
    "min_above_cap": "from every a=S[price > 40]<10:> -> b=S[price < 5] "
                     "select a[0].volume as v0, a[last].volume as vl, b.volume as vb",
    # three slots: the tail runs the ordinary pass, with a cross-ref condition
    "three_slot_tail": "from every a=S[price > 85]<1:3> -> b=S[price < 15] "
                       "-> c=S[volume > b.volume] "
                       "select a[0].volume as v0, b.volume as vb, c.volume as vc",
    # slot 1 on another stream; the count's refs not selected (no capture lanes)
    "two_stream": "from every a=S[price > 60]<2:3> -> b=S2[price < 40] select b.symbol as sb",
}


def _runtimes(ql: str, T: int):
    app = f"@app:patternCapacity(size='{T}')\n{SCHEMA}@info(name='q') {ql} insert into Out;"
    jq = siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(app).queries["q"]
    pq = siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(app).queries["q"]
    assert isinstance(pq, PatternQueryRuntime)
    return jq, pq


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _random_tok(prog, rng, count_route: bool):
    """A random token table in the program's layout (token 0 stays active)."""
    tok = _np(prog.init_state(0))
    T, S = prog.T, len(prog.slots)
    base = 1_000_000
    tok["active"] = rng.random(T) < 0.5
    tok["active"][0] = True
    tok["slot"] = rng.integers(0, S, T).astype(np.int32)
    tok["slot"][0] = 0
    virgin = rng.random(T) < 0.3
    tok["start_ts"] = np.where(virgin, -1, base - rng.integers(0, 60, T)).astype(np.int64)
    tok["start_ts"][0] = -1
    tok["entry_ts"] = (base - rng.integers(0, 30, T)).astype(np.int64)
    for a, c in zip(prog.refs, tok["caps"]):
        hi = a.cap + 3 if count_route else 2
        c["n"] = rng.integers(0, hi, T).astype(np.int32)
        c["ts"] = (base - rng.integers(0, 100, c["ts"].shape)).astype(np.int64)
        for name, arr in c["cols"].items():
            c["cols"][name] = _values(rng, arr.dtype, arr.shape)
    return tok


def _values(rng, dtype, shape):
    if dtype == np.float32:
        return rng.uniform(0, 100, shape).astype(np.float32)
    if dtype == np.int32:
        return rng.integers(1, 9, shape).astype(np.int32)
    return rng.integers(1, 1000, shape).astype(dtype)


def _chunk(rng, C: int, t0: int):
    ts = t0 + np.cumsum(rng.integers(0, 4, C)).astype(np.int64)
    kind = np.where(rng.random(C) < 0.05, 2, 0).astype(np.int8)
    valid = rng.random(C) < 0.9
    cols = {"symbol": rng.integers(1, 9, C).astype(np.int32),
            "price": rng.uniform(0, 100, C).astype(np.float32),
            "volume": rng.integers(1, 1000, C).astype(np.int64)}
    return ts, kind, valid, cols


def _run_both(ql, T, C, seed, count_route, out_fill, stream="S"):
    """One chunk through the JAX function and the port's, from the same
    random token table and emission buffer; returns both results as numpy."""
    jq, pq = _runtimes(ql, T)
    jprog, pprog = jq.prog, pq.prog
    rng = np.random.default_rng(seed)
    tok = _random_tok(jprog, rng, count_route)
    ts, kind, valid, cols = _chunk(rng, C, 1_000_000 - 20)
    cap = max(T, 64)
    out = _np(jprog.init_out(cap))
    out_n = int(cap * out_fill)
    if out_n:
        for k, v in out.items():
            v[:out_n] = _values(rng, v.dtype, v[:out_n].shape) if k != "valid" else True
    now = 1_000_500
    fn = "apply_batch_count" if count_route else "apply_batch_fast"
    jres = getattr(jprog, fn)(
        jax.tree_util.tree_map(jnp.asarray, tok), jnp.asarray(ts), jnp.asarray(kind),
        jnp.asarray(valid), {stream: {k: jnp.asarray(v) for k, v in cols.items()}},
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.int32(out_n), jnp.bool_(False),
        jnp.asarray(now, dtype=jnp.int64))
    pres = getattr(pprog, fn)(
        state_from_numpy(tok, "cpu"), torch.from_numpy(ts), torch.from_numpy(kind),
        torch.from_numpy(valid), {stream: {k: torch.from_numpy(v) for k, v in cols.items()}},
        state_from_numpy(out, "cpu"), torch.tensor(out_n, dtype=torch.int32),
        torch.tensor(False), torch.tensor(now, dtype=torch.int64))
    return _np(jres), state_to_numpy(pres)


def _assert_same(got, want):
    tok_g, out_g, n_g, ovf_g = got
    tok_w, out_w, n_w, ovf_w = want
    assert int(n_g) == int(n_w)
    assert bool(ovf_g) == bool(ovf_w)
    assert sorted(out_g) == sorted(out_w)
    np.testing.assert_equal(out_g, out_w)
    np.testing.assert_equal(tok_g, tok_w)


# every app at T in {8, 64, 512} x C in {1, 33, 2048}, but the [512, 2048]
# matrix only for one advance-and-fork app and one strict one
FAST_CASES = [(app, T, C) for app in sorted(FAST_APPS) for T in (8, 64, 512)
              for C in (1, 33, 2048)
              if not (T == 512 and C == 2048 and app not in ("every_within", "sequence_chain"))]


@pytest.mark.parametrize("app,T,C", FAST_CASES)
def test_apply_batch_fast_matches_jax(app, T, C):
    got, want = _run_both(FAST_APPS[app], T, C, seed=T * 7 + C, count_route=False,
                          out_fill=0.0)
    _assert_same(got, want)


@pytest.mark.parametrize("C", [1, 33, 2048, 8192])
@pytest.mark.parametrize("T", [8, 64, 512])
@pytest.mark.parametrize("app", sorted(COUNT_APPS))
def test_apply_batch_count_matches_jax(app, T, C):
    stream = "S"
    got, want = _run_both(COUNT_APPS[app], T, C, seed=T * 11 + C, count_route=True,
                          out_fill=0.0, stream=stream)
    _assert_same(got, want)


@pytest.mark.parametrize("app", ["two_stream"])
@pytest.mark.parametrize("route", ["fast", "count"])
def test_second_stream_step_matches_jax(route, app):
    """A step of the pattern's second stream: only the slots on S2 run."""
    apps = FAST_APPS if route == "fast" else COUNT_APPS
    got, want = _run_both(apps[app], 64, 33, seed=5, count_route=route == "count",
                          out_fill=0.0, stream="S2")
    _assert_same(got, want)


@pytest.mark.parametrize("route,app", [("fast", "every_within"), ("fast", "sequence_every"),
                                       ("count", "every_2_4"), ("count", "three_slot_tail")])
def test_lane_exhaustion_and_emission_overflow(route, app):
    """T = 8 lanes against a dense chunk (forks or generations past the free
    lanes) into an emission buffer filled to all but a few rows: both
    overflow rules fire in both packages, and the dropped work is the same."""
    apps = FAST_APPS if route == "fast" else COUNT_APPS
    got, want = _run_both(apps[app], 8, 257, seed=9, count_route=route == "count",
                          out_fill=0.95)
    assert bool(want[3])
    _assert_same(got, want)
