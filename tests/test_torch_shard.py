"""The multi-device routines of the port against the JAX package, on the CPU,
with inputs made from a seed with numpy (8 host devices, tests/conftest.py):

- K49's owner hash: the plain `owner_of_ref` (torch) and the host
  `owner_of_np` against `siddhi_tpu.parallel.keyshard.owner_of` on numpy
  and on `jnp`, for keys 0, +-1, INT64_MIN/MAX, sequential ids, `mix_keys`
  outputs and 10^5 random keys, D 1/2/3/7/8/64. Exact.
- K49's fold through the key-sharded step: JAX's `KeyShardedGroupExec`
  sharded step and the port's, the same [D]-stacked state carried in, over
  batches with -0.0 and NaN payloads in a float lane, a bool lane, invalid
  and TIMER rows: every output lane and every state leaf bit for bit (ts
  and kind are shard 0's copy, JAX's replicated `out_specs=P()`); and
  `fold_rows` (its plain version on the CPU) over each shard's own lanes
  against a gather of the owner's bits.
- K50 through the routed step: JAX's `shard_partitioned_query(routed=True)`
  and the port's on the same batches (B 1/33/64, keys past the partition
  capacity, TIMER rows) at D 4 and 8: each step's rows set-equal, sorted
  as tests/test_sharded_equality.py sorts them (floats within
  bench.py:_rows_match's relative 2e-4, NaN equal to NaN), the overflow flag and next_timer
  equal; and the plain `route_rows_ref` against the JAX pre-pass
  (mesh.py:200-222) on ragged and all-TIMER batches, exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core.event import EventBatch as JaxBatch  # noqa: E402
from siddhi_tpu.ops.group import mix_keys as jax_mix_keys  # noqa: E402
from siddhi_tpu.parallel import keyshard as jks  # noqa: E402
from siddhi_tpu_torch.core.event import EventBatch  # noqa: E402
from siddhi_tpu_torch.interop import (  # noqa: E402
    keyshard_state_from_jax,
    sharded_partition_state_from_jax,
    state_from_numpy,
    state_to_numpy,
)
from siddhi_tpu_torch.parallel import keyshard as pks  # noqa: E402
from siddhi_tpu_torch.parallel.mesh import (  # noqa: E402
    mesh_devices,
    route_rows_ref,
    shard_partitioned_query,
)
from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

INT64_MIN, INT64_MAX = -(1 << 63), (1 << 63) - 1


def _keys() -> np.ndarray:
    rng = np.random.default_rng(49)
    mixed = np.asarray(jax_mix_keys([jnp.asarray(rng.integers(-50, 50, 500)),
                                     jnp.asarray(rng.integers(0, 9, 500).astype(np.int32))]))
    return np.concatenate([
        np.array([0, 1, -1, INT64_MIN, INT64_MAX, INT64_MIN + 1, INT64_MAX - 1], np.int64),
        np.arange(4096, dtype=np.int64),
        mixed.astype(np.int64),
        rng.integers(INT64_MIN, INT64_MAX, size=100_000, dtype=np.int64, endpoint=True),
    ])


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 64])
def test_owner_of_matches_jax(d):
    keys = _keys()
    want = jks.owner_of(keys, d)
    assert np.array_equal(np.asarray(jks.owner_of(jnp.asarray(keys), d)), want)
    got = pks.owner_of(torch.from_numpy(keys), d)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pks.owner_of_np(keys, d), want)
    assert np.array_equal(pks.mix64(keys.astype(np.uint64)), jks.mix64(keys.astype(np.uint64)))


def test_fold_rows_ref_is_the_owners_bits():
    rng = np.random.default_rng(7)
    d, b = 8, 513
    owner = rng.integers(0, d, b).astype(np.int32)
    bits = rng.integers(INT64_MIN, INT64_MAX, size=(d, b), dtype=np.int64)
    f32 = rng.integers(-(1 << 31), (1 << 31) - 1, size=(d, b), dtype=np.int64).astype(np.int32)
    f32[:, :4] = [0x7FC00001, -0x80000000, 0x7F800001, -0x00400000]  # NaN payloads, -0.0
    lanes = {"i64": torch.from_numpy(bits),
             "f32": torch.from_numpy(f32.copy()).view(torch.float32),
             "i32": torch.from_numpy(f32.copy()),
             "b": torch.from_numpy(rng.random((d, b)) < 0.5)}
    valid = torch.from_numpy(rng.random((d, b)) < 0.3)
    # fold_rows' interface: each shard's [B] lane, shard by shard
    out, v = pks.fold_rows({k: list(x) for k, x in lanes.items()}, torch.from_numpy(owner),
                           list(valid))
    rows = np.arange(b)
    assert np.array_equal(out["i64"].numpy(), bits[owner, rows])
    assert np.array_equal(out["f32"].view(torch.int32).numpy(), f32[owner, rows])
    assert np.array_equal(out["i32"].numpy(), f32[owner, rows])
    assert np.array_equal(out["b"].numpy(), lanes["b"].numpy()[owner, rows])
    assert np.array_equal(v.numpy(), valid.numpy().any(0))


# ---------------------------------------------------------------------------
# the key-sharded step (owner mask + fold) against JAX's
# ---------------------------------------------------------------------------

KS_APP = """@app:batch(size='{b}') @app:shard(devices='8', axis='keys')
define stream S (symbol string, p float, q float, v long, flag bool);
@info(name='q') from S select symbol, p, flag, min(q) as mq, max(v) as mv,
 count() as c, sum(v) as sv group by symbol insert into Out;
"""


def _ks_batches(b, n_batches=4, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        n = b if i % 2 == 0 else b - 3
        p = rng.uniform(-5, 5, b).astype(np.float32)
        pb = p.view(np.int32)
        pb[::5] = 0x7FC00001 + i  # NaN payloads
        pb[1::7] = -0x80000000  # -0.0
        q = rng.choice(np.array([-0.0, 0.0, 1.5, -2.25, 3.0], np.float32), b)
        kind = np.zeros(b, np.int8)
        kind[2::11] = 2  # TIMER rows
        valid = np.arange(b) < n
        valid[4::9] = False
        out.append({"ts": np.arange(b, dtype=np.int64) + 1_000 + 100 * i, "kind": kind,
                    "valid": valid,
                    "cols": {"symbol": rng.integers(1, 13, b).astype(np.int32), "p": p, "q": q,
                             "v": rng.integers(-1000, 1000, b).astype(np.int64),
                             "flag": rng.random(b) < 0.5}})
    return out


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype != np.bool_ else x


def _same_bits(got, want, zero_sign=True) -> bool:
    """Bit for bit; with zero_sign False a float zero may differ in sign
    only: a running min/max carry's zero, whose sign XLA's scan drops and
    the port keeps (ROADMAP section 3)."""
    if not zero_sign and got.dtype.kind == "f":
        both_zero = (got == 0) & (want == 0)
        got, want = np.where(both_zero, 0, got), np.where(both_zero, 0, want)
    return np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("b", [33])
def test_keysharded_step_matches_jax(b, monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    app = KS_APP.format(b=b)
    jm = siddhi_tpu.SiddhiManager()
    jrt = jm.create_siddhi_app_runtime(app)
    jrt.start()
    jq = jrt.queries["q"]
    jex = jq._keyshard
    assert jex is not None and jex.n == 8
    pm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    prt = pm.create_siddhi_app_runtime(app)
    prt.start()
    pq = prt.queries["q"]
    pex = pq._keyshard
    assert pex is not None and pex.n == 8
    jstate = jex.init_state()
    for f in _ks_batches(b):
        # the port starts each step from JAX's state
        pstate = keyshard_state_from_jax(state_to_numpy_jax(jstate), "cpu")
        jb = JaxBatch(jnp.asarray(f["ts"]), jnp.asarray(f["kind"]), jnp.asarray(f["valid"]),
                      {k: jnp.asarray(v) for k, v in f["cols"].items()})
        now = int(f["ts"][-1])
        jstate, _ts, jout, _aux = jex._jit(jstate, {}, jb, jnp.asarray(now, jnp.int64))
        pb = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                        valid=torch.from_numpy(f["valid"]),
                        cols={k: torch.from_numpy(v.copy()) for k, v in f["cols"].items()})
        # the same step unsharded, from the canonical single-device export
        one = state_from_numpy(pex.export_state(pstate), "cpu")
        _one, uout = pq._step_impl(one, pb, torch.tensor(now))
        pstate, pout = pex._step_impl(pstate, pb, torch.tensor(now))
        lanes = [("ts", pout.ts, jout.ts, uout.ts), ("kind", pout.kind, jout.kind, uout.kind),
                 ("valid", pout.valid, jout.valid, uout.valid)] + [
            (n, pout.cols[n], jout.cols[n], uout.cols[n]) for n in jout.cols]
        for name, got, want, unsharded in lanes:
            got = got.numpy()
            assert np.array_equal(_bits(got), _bits(unsharded.numpy())), name
            assert _same_bits(got, np.asarray(want), zero_sign=name != "mq"), name
        for g, w in zip(_flat(state_to_numpy(pstate)), _flat(state_to_numpy_jax(jstate)),
                        strict=True):
            assert g.shape == w.shape and _same_bits(g, w, zero_sign=False)
    assert int(np.asarray(jout.valid).sum()) > 0
    for rt, m in ((jrt, jm), (prt, pm)):
        rt.shutdown()
        m.shutdown()


def state_to_numpy_jax(tree):
    if isinstance(tree, dict):
        return {k: state_to_numpy_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_to_numpy_jax(v) for v in tree)
    return np.asarray(jax.device_get(tree))


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


# ---------------------------------------------------------------------------
# K50 and the routed step against JAX's
# ---------------------------------------------------------------------------

ROUTED_APP = """@app:batch(size='64') @app:partitionCapacity(size='8')
define stream S (symbol string, price float, volume long);
partition with (symbol of S)
begin
    @info(name='q')
    from S[price > 0]#window.time(100)
    select symbol, sum(volume) as total, avg(price) as ap
    insert into Out;
end;
"""


def _route_batches(seed=11):
    """B 1/33/64 in turn, 12 keys over an 8-slot table (keys past capacity),
    TIMER rows among them and an all-TIMER batch."""
    rng = np.random.default_rng(seed)
    out = []
    for s, b in enumerate([33, 64, 1, 33, 64, 33, 1, 64, 33]):
        kind = np.zeros(b, np.int8)
        if b > 1:
            kind[3::10] = 2
        if s == 5:
            kind[:] = 2
        valid = np.ones(b, bool)
        valid[b - 2:] = b < 4
        out.append({"ts": np.sort(rng.integers(0, 40, b)).astype(np.int64) + 1_000 + 60 * s,
                    "kind": kind, "valid": valid,
                    "cols": {"symbol": rng.integers(1, 13, b).astype(np.int32),
                             "price": rng.uniform(-10, 100, b).astype(np.float32),
                             "volume": rng.integers(1, 100, b).astype(np.int64)}})
    return out


def _rows_close(got, want) -> bool:
    """bench.py:_rows_match with NaN equal to NaN (an avg over no rows)."""
    def fix(rows):
        return [tuple("nan" if isinstance(x, float) and x != x else x for x in r) for r in rows]

    return bench._rows_match(fix(got), fix(want))


def _rows(valid, ts, cols):
    """The valid rows as (ts, *cols), sorted by ts and the exact lanes,
    then the float lanes to two decimals (they match to a tolerance)."""
    v = np.asarray(valid)
    ts_a = np.asarray(ts)
    cols_a = [np.asarray(c) for c in cols]
    exact = [c for c in cols_a if c.dtype.kind != "f"]
    rows = [(int(ts_a[i]), *(c[i].item() for c in cols_a)) for i in map(tuple, np.argwhere(v))]
    floats = [c for c in cols_a if c.dtype.kind == "f"]
    keys = [(int(ts_a[i]), *(c[i].item() for c in exact), *(round(c[i].item(), 2) for c in floats))
            for i in map(tuple, np.argwhere(v))]
    return [r for _k, r in sorted(zip(keys, rows), key=lambda kr: kr[0])]


@pytest.mark.parametrize("d", [4, 8])
def test_routed_step_matches_jax(d):
    from jax.sharding import Mesh

    from siddhi_tpu.parallel.mesh import shard_partitioned_query as jax_shard

    jm = siddhi_tpu.SiddhiManager()
    jrt = jm.create_siddhi_app_runtime(ROUTED_APP)
    jrt.start()
    pm = siddhi_tpu_torch.SiddhiManager(device="cpu")
    prt = pm.create_siddhi_app_runtime(ROUTED_APP)
    prt.start()
    jsq = jax_shard(jrt.queries["q"], Mesh(np.asarray(jax.devices()[:d]), ("part",)))
    devices = mesh_devices("cpu")[:d]
    assert len(devices) == d
    psq = shard_partitioned_query(prt.queries["q"], devices, routed=True)
    n_rows = 0
    for i, f in enumerate(_route_batches()):
        if i == 4:
            # carry JAX's state in mid-run: the striped [P] layout, as is
            psq._ptable, psq._state = sharded_partition_state_from_jax(
                state_to_numpy_jax(jsq._ptable), state_to_numpy_jax(jsq.state), "cpu")
        now = int(f["ts"].max())
        jb = JaxBatch(jnp.asarray(f["ts"]), jnp.asarray(f["kind"]), jnp.asarray(f["valid"]),
                      {k: jnp.asarray(v) for k, v in f["cols"].items()})
        jouts, jaux = jsq.step(jb, now)
        pb = EventBatch(ts=torch.from_numpy(f["ts"]), kind=torch.from_numpy(f["kind"]),
                        valid=torch.from_numpy(f["valid"]),
                        cols={k: torch.from_numpy(v) for k, v in f["cols"].items()})
        pouts, paux = psq.step(pb, now)
        names = list(jouts.cols)
        want = _rows(jouts.valid, jouts.ts, [jouts.cols[n] for n in names])
        got = _rows(pouts.valid.numpy(), pouts.ts.numpy(), [pouts.cols[n].numpy() for n in names])
        assert _rows_close(got, want), i
        assert psq.total_emitted(pouts) == len(want)
        n_rows += len(want)
        assert bool(paux["partition_overflow"]) == bool(np.asarray(jaux["partition_overflow"]))
        assert int(paux["next_timer"]) == int(np.asarray(jaux["next_timer"])), i
    assert n_rows > 50
    for rt, m in ((jrt, jm), (prt, pm)):
        rt.shutdown()
        m.shutdown()


def _jax_route(slot, active, is_timer, lanes, p, d):
    """The JAX package's routed pre-pass (siddhi_tpu/parallel/mesh.py
    :200-222), as jnp over numpy inputs."""
    b = slot.shape[0]
    slot, active, is_timer = jnp.asarray(slot), jnp.asarray(active), jnp.asarray(is_timer)
    idx = jnp.arange(b, dtype=jnp.int32)
    dev_of = jnp.where(active & (slot < p), slot % d, d)
    take = (dev_of[None, :] == jnp.arange(d)[:, None]) | is_timer[None, :]
    rank = jnp.cumsum(take.astype(jnp.int32), axis=1) - 1
    dst = jnp.where(take, jnp.arange(d)[:, None] * b + rank, d * b)
    routed = (jnp.full((d * b,), b, jnp.int32).at[dst.reshape(-1)]
              .set(jnp.broadcast_to(idx[None, :], (d, b)).reshape(-1), mode="drop")
              .reshape(d, b))
    pad = routed >= b
    ri = jnp.clip(routed, 0, b - 1)

    def lane(x, fill=0):
        x = jnp.asarray(x)
        return jnp.where(pad, np.asarray(fill, x.dtype), x[ri])

    return (np.asarray(routed), {n: np.asarray(lane(x)) for n, x in lanes.items()},
            np.asarray(lane(jnp.where(active, slot, p), fill=p)), np.asarray(~pad))


@pytest.mark.parametrize("b,d", [(1, 1), (1, 8), (33, 2), (33, 8), (513, 4), (513, 8)])
def test_route_rows_ref_matches_jax(b, d):
    rng = np.random.default_rng(b * 10 + d)
    p = 16
    for case in ("ragged", "all_timer"):
        slot = rng.integers(0, p + 1, b).astype(np.int32)
        active = rng.random(b) < 0.7
        is_timer = ~active & (rng.random(b) < 0.3)
        if case == "all_timer":
            active[:], is_timer[:] = False, True
        f = rng.uniform(-1, 1, b).astype(np.float32)
        f.view(np.int32)[::3] = -0x80000000
        lanes = {"ts": rng.integers(0, 1 << 40, b).astype(np.int64),
                 "kind": np.where(is_timer, 2, 0).astype(np.int8), "f": f,
                 "b": rng.random(b) < 0.5, "i": rng.integers(-9, 9, b).astype(np.int32)}
        want = _jax_route(slot, active, is_timer, lanes, p, d)
        got = route_rows_ref(torch.from_numpy(slot), torch.from_numpy(active),
                             torch.from_numpy(is_timer),
                             {n: torch.from_numpy(x) for n, x in lanes.items()}, p, d)
        assert np.array_equal(got[0].numpy(), want[0])
        for n in lanes:
            assert np.array_equal(_bits(got[1][n].numpy()), _bits(want[1][n])), n
        assert np.array_equal(got[2].numpy(), want[2])
        assert np.array_equal(got[3].numpy(), want[3])
