"""Fused columnar ingest (siddhi_tpu_torch/core/ingest.py) against the JAX
package's fused ingest, on the CPU.

The same app and the same columnar feed go through `siddhi_tpu` (JAX, whose
send_columns takes its FusedJunctionIngest) and `siddhi_tpu_torch`
(device="cpu", whose send_columns takes the port's engine), and the callback
sequences — one (ts, ins, removed) per callback, in order — must match:
ints and strings exactly, floats within bench.py:_rows_match (relative 2e-4,
floor 1.0; the port sums in another order). Inside the port, the fused form
must equal the per-batch form exactly (same operations on the same inputs).
The plain K5 pack (`deliver_pack_ref`) is held against the JAX chunk
program's pack, written with the JAX package's own `set_at`, exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.ops.scatter import set_at  # noqa: E402
from siddhi_tpu_torch.core.ingest import deliver_pack_ref  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy  # noqa: E402

HEAD = "@app:batch(size='64')\ndefine stream S (symbol string, price float, volume long);\n"

APPS = {
    "filter_cb": HEAD
    + "@info(name='q') from S[price > 60] select symbol, price insert into Out;",
    "window_avg_cb": HEAD
    + """@info(name='q') from S#window.length(16)
        select symbol, avg(price) as ap insert into Out;""",
    "all_events_cb": HEAD
    + """@info(name='q') from S#window.length(8)
        select symbol, price insert all events into Out;""",
    "quickstart_avg": HEAD
    + """@info(name='q') from S[price > 50]#window.length(50)
        select symbol, avg(price) as ap insert into Out;""",
    "quickstart_minmax": HEAD
    + """@info(name='q') from S[price > 50]#window.length(50)
        select symbol, avg(price) as ap, min(price) as mn, max(price) as mx
        insert into Out;""",
    "expired_cb": HEAD
    + """@info(name='q') from S#window.length(4)
        select symbol, volume insert expired events into Out;""",
}


def _feed(n, seed=42, t0=1_700_000_000_000):
    rng = np.random.default_rng(seed)
    return (
        np.arange(n, dtype=np.int64) + t0,
        {
            "symbol": rng.integers(1, 5, size=n).astype(np.int32),
            "price": rng.uniform(0.0, 100.0, size=n).astype(np.float32),
            "volume": rng.integers(1, 100, size=n).astype(np.int64),
        },
    )


def _collector(got):
    return lambda ts, ins, rem: got.append((
        ts,
        [tuple(e.data) for e in (ins or [])],
        [tuple(e.data) for e in (rem or [])],
    ))


def _run(mgr, ql, sends, fused=True, check_engine=True):
    rt = mgr.create_siddhi_app_runtime(ql)
    got = []
    rt.add_callback("q", _collector(got))
    for s in ["A", "B", "C", "D"]:
        mgr.interner.intern(s)
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    elif check_engine:
        assert rt.junctions["S"].fused_ingest is not None
    h = rt.get_input_handler("S")
    for ts, cols in sends:
        h.send_columns(ts, cols, now=int(ts[-1]))
    fi = rt.junctions["S"].fused_ingest
    stats = fi.describe_state() if fi is not None else None
    rt.shutdown()
    mgr.shutdown()
    return got, stats


def _port():
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


@pytest.mark.parametrize("name", sorted(APPS))
def test_fused_matches_jax_fused(name):
    sends = [_feed(64 * 40)]
    jax_rows, _ = _run(siddhi_tpu.SiddhiManager(), APPS[name], sends)
    port_rows, stats = _run(_port(), APPS[name], sends)
    assert stats["events"] == 64 * 40 and stats["chunks"] == 2  # K = 32, then 8
    assert len(jax_rows) >= 40
    assert bench._rows_match(port_rows, jax_rows)


@pytest.mark.parametrize("name", sorted(APPS))
def test_fused_matches_per_batch(name):
    sends = [_feed(64 * 40)]
    fused, _ = _run(_port(), APPS[name], sends)
    per_batch, _ = _run(_port(), APPS[name], sends, fused=False)
    assert fused == per_batch
    assert sum(len(i) + len(r) for _t, i, r in fused) > 50


@pytest.mark.parametrize("n", [2 * 64 + 1, 5 * 64, 64 * 33 + 7])
def test_tail_variants(n):
    """K variants of a short tail: 3 batches ride K=4, 5 ride K=8, and a
    33-batch call a K=32 chunk then a K=2 tail."""
    ql = APPS["window_avg_cb"]
    sends = [_feed(n, seed=n)]
    jax_rows, _ = _run(siddhi_tpu.SiddhiManager(), ql, sends)
    port_rows, stats = _run(_port(), ql, sends)
    assert stats["events"] == n
    assert bench._rows_match(port_rows, jax_rows)
    per_batch, _ = _run(_port(), ql, sends, fused=False)
    assert port_rows == per_batch


def test_short_call_takes_per_batch_path():
    """Fewer than 2 batches: the engine declines and the per-batch path
    delivers the same rows."""
    ql = APPS["filter_cb"]
    sends = [_feed(64 + 5)]
    rows, stats = _run(_port(), ql, sends)
    assert stats["chunks"] == 0
    jax_rows, _ = _run(siddhi_tpu.SiddhiManager(), ql, sends)
    assert bench._rows_match(rows, jax_rows)


WIRE_APP = """
@app:batch(size='32')
@app:wire(dict.S.symbol='16', range.S.volume='0..30000')
define stream S (symbol string, price float, volume long, up bool);
@info(name='q') from S[price > 20]#window.length(8)
select symbol, up, avg(price) as ap, sum(volume) as tv insert into Out;
"""


def _wire_feed(n=256, seed=3):
    rng = np.random.default_rng(seed)
    ts = np.arange(n, dtype=np.int64) + 1_700_000_000_000
    cols = {
        "symbol": rng.integers(1, 9, n).astype(np.int32),
        "price": rng.uniform(0, 100, n).astype(np.float32),
        "volume": rng.integers(1, 1000, n).astype(np.int64),
        "up": rng.integers(0, 2, n).astype(bool),
    }
    return ts, cols


def _run_wire(mgr, env_val, feed_calls, monkeypatch):
    monkeypatch.setenv("SIDDHI_TPU_WIRE", env_val)
    rt = mgr.create_siddhi_app_runtime(WIRE_APP)
    monkeypatch.delenv("SIDDHI_TPU_WIRE")
    for i in range(1, 20):
        mgr.interner.intern(f"SYM{i}")
    rows = []
    rt.add_callback("q", lambda t, ins, rem: rows.extend(
        [("+",) + tuple(e.data) for e in (ins or [])]
        + [("-",) + tuple(e.data) for e in (rem or [])]
    ))
    rt.start()
    h = rt.get_input_handler("S")
    for ts, cols in feed_calls:
        h.send_columns(ts, cols, now=int(ts[-1]))
    fi = rt.junctions["S"].fused_ingest
    narrow = dict(fi._narrow) if fi._narrow is not None else None
    rt.shutdown()
    mgr.shutdown()
    return rows, narrow


@pytest.mark.parametrize("bump", ["range", "dict"])
def test_mid_stream_misfit_falls_back_full_width(bump, monkeypatch):
    """A second call whose values outgrow the declared wire (volume past its
    int16 range, or 18 symbols past a 16-slot dictionary) rebuilds the chunk
    program full-width, permanently, with the rows unchanged."""
    ts, cols = _wire_feed()
    cols2 = dict(cols)
    if bump == "range":
        cols2["volume"] = cols["volume"] + 10**6
    else:
        cols2["symbol"] = (np.arange(len(ts), dtype=np.int32) % 18) + 1
    feed = [(ts, cols), (ts + len(ts), cols2)]
    on_rows, on_narrow = _run_wire(_port(), "1", feed, monkeypatch)
    off_rows, off_narrow = _run_wire(_port(), "0", feed, monkeypatch)
    jax_rows, _ = _run_wire(siddhi_tpu.SiddhiManager(), "1", feed, monkeypatch)
    assert on_narrow == {} and off_narrow == {}
    assert on_rows == off_rows and len(on_rows) > 100
    assert bench._rows_match(on_rows, jax_rows)


def test_static_spec_engages(monkeypatch):
    ts, cols = _wire_feed()
    rows, narrow = _run_wire(_port(), "1", [(ts, cols)], monkeypatch)
    assert narrow["symbol"] == ("dict", np.dtype(np.uint8), 16)
    assert narrow["up"] == ("bitpack",)
    jax_rows, jax_narrow = _run_wire(siddhi_tpu.SiddhiManager(), "1", [(ts, cols)],
                                     monkeypatch)
    assert narrow == jax_narrow
    assert bench._rows_match(rows, jax_rows)


def test_state_carry_between_calls():
    """Run the JAX engine for a first fused call, carry its query state and
    interned ids into the port, then send both the same second call."""
    from siddhi_tpu_torch.interop import interned_values, load_interned

    ql = APPS["quickstart_minmax"]
    first, second = _feed(64 * 5, seed=1), _feed(64 * 6, seed=2, t0=1_700_000_001_000)
    jmgr = siddhi_tpu.SiddhiManager()
    jrt = jmgr.create_siddhi_app_runtime(ql)
    for s in ["A", "B", "C", "D"]:
        jmgr.interner.intern(s)
    jrt.start()
    jrt.get_input_handler("S").send_columns(*first, now=0)
    tree = jax.tree_util.tree_map(np.asarray, jrt.queries["q"].state)

    pmgr = _port()
    prt = pmgr.create_siddhi_app_runtime(ql)
    load_interned(pmgr.interner, interned_values(jmgr.interner))
    prt.queries["q"].state = state_from_numpy(tree, "cpu")
    got = {"jax": [], "port": []}
    jrt.add_callback("q", _collector(got["jax"]))
    prt.add_callback("q", _collector(got["port"]))
    prt.start()
    jrt.get_input_handler("S").send_columns(*second, now=0)
    prt.get_input_handler("S").send_columns(*second, now=0)
    assert prt.junctions["S"].fused_ingest.chunks_dispatched == 1
    for rt, mgr in ((jrt, jmgr), (prt, pmgr)):
        rt.shutdown()
        mgr.shutdown()
    assert len(got["jax"]) == 6
    assert bench._rows_match(got["port"], got["jax"])


def test_uncovered_subscriber_declines():
    """A stream callback observes per-batch boundaries: the engine declines
    and the per-batch path runs."""
    mgr = _port()
    rt = mgr.create_siddhi_app_runtime(APPS["filter_cb"])
    seen = []
    rt.add_callback("S", lambda events: seen.append(len(events)))
    for s in ["A", "B", "C", "D"]:
        mgr.interner.intern(s)
    rt.start()
    rt.get_input_handler("S").send_columns(*_feed(64 * 4), now=0)
    assert rt.junctions["S"].fused_ingest.chunks_dispatched == 0
    assert seen == [64] * 4
    rt.shutdown()


def _jax_pack(dv, lanes):
    """The deliver pack of siddhi_tpu/core/ingest.py _build.fused, on one
    endpoint's stacked lanes (sorted name order) and mask."""
    K, cap = dv.shape
    R = K * cap
    flat = dv.reshape(R)
    rank = jnp.cumsum(flat.astype(jnp.int32)) - flat.astype(jnp.int32)
    dst = jnp.where(flat, rank, R)
    segs = []
    for arr in lanes:
        arr = arr.reshape(R)
        if arr.dtype == jnp.bool_:
            arr = arr.astype(jnp.uint8)
        packed = set_at(jnp.zeros((R,), arr.dtype), dst, arr)
        u8 = jax.lax.bitcast_convert_type(packed, jnp.uint8)
        if u8.ndim == 1:
            u8 = u8[:, None]
        segs.append(u8)
    data_buf = jnp.concatenate(segs, axis=1)
    W = data_buf.shape[1]
    cnt_u8 = jax.lax.bitcast_convert_type(
        dv.sum(axis=1, dtype=jnp.int32), jnp.uint8).reshape(-1)
    hdr_rows = -(-cnt_u8.shape[0] // W)
    hdr = jnp.zeros((hdr_rows * W,), jnp.uint8)
    hdr = hdr.at[: cnt_u8.shape[0]].set(cnt_u8).reshape(hdr_rows, W)
    return np.asarray(jnp.concatenate([hdr, data_buf], axis=0))


@pytest.mark.parametrize("K,cap,p,dtypes", [
    (3, 2 * 33, 0.5, ("float32", "int32", "int8", "int64")),  # W=17, ALL layout
    (4, 128, 0.25, ("float32", "int32", "int64")),  # the avg app's W=16
    (2, 70, 0.0, ("int32", "int64")),
    (5, 9, 1.0, ("bool", "int64")),
])
def test_deliver_pack_plain_matches_jax(K, cap, p, dtypes):
    rng = np.random.default_rng(K * 1000 + cap)
    dv = rng.random((K, cap)) < p
    lanes = []
    for dt in dtypes:
        if dt == "bool":
            lanes.append(rng.integers(0, 2, (K, cap)).astype(bool))
        elif dt == "float32":
            lanes.append(rng.uniform(-1e3, 1e3, (K, cap)).astype(np.float32))
        else:
            info = np.iinfo(dt)
            lanes.append(rng.integers(info.min, info.max, (K, cap), dtype=dt))
    want = _jax_pack(jnp.asarray(dv), [jnp.asarray(a) for a in lanes])
    got = deliver_pack_ref(torch.from_numpy(dv), [torch.from_numpy(a) for a in lanes])
    assert np.array_equal(got.numpy(), want)


def test_chunk_env_and_annotation():
    """@app:ingestChunk sets K; every chunk after the first rides K."""
    ql = "@app:ingestChunk(size='4')\n" + APPS["filter_cb"]
    rows, stats = _run(_port(), ql, [_feed(64 * 10)])
    assert stats["chunk_batches"] == 4 and stats["chunks"] == 3  # 4 + 4 + 2
    jax_rows, _ = _run(siddhi_tpu.SiddhiManager(), ql, [_feed(64 * 10)])
    assert bench._rows_match(rows, jax_rows)

