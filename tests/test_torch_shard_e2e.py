"""Sharded execution (`@app:shard`) end to end on the port, on the CPU's 8
host devices (tests/conftest.py's XLA_FLAGS, which `mesh_devices` reads):

- the JAX package's own tests under their own assertions with the port's
  SiddhiManager (device="cpu"), error class, annotation class and shard
  functions swapped in: tests/test_shard_exec.py (`TestShardResolution` but
  the analyzer's SA129, `TestBatchRouter` but the Prometheus and explain
  surfaces, `TestPartitionMesh`), tests/test_keyshard.py (`TestOwnerHash`,
  `TestEligibility`, `TestGroupByParity::test_byte_parity_and_occupancy`,
  `TestJoinMesh`, `TestFusionVeto::test_fused_run_keeps_query_sharded_
  with_parity`, `TestPartitionPadding`), tests/test_lineage.py's
  `TestParity::test_records_identical_shard_8_vs_0`, and
  tests/test_sharded_equality.py's key-churn run on the port (routed vs
  unsharded, every step's rows);
- the three axes, sharded = the port unsharded = JAX unsharded, fused and
  per batch, at batch 16 and 33;
- the verify cases under SIDDHI_TPU_SHARD=8 against VERIFY.json's frozen
  rows (multi_query_shared, not frozen there, against the port unsharded);
- `export_state` / `import_state` against JAX's on the same carried state
  (8 -> 8, 8 -> 4, 0 -> 8);
- one device: JAX's warnings, sharding off; malformed annotations raising
  JAX's class and message; `import siddhi_tpu_torch.parallel` importing no
  JAX.

Floats match to bench.py:_rows_match's relative 2e-4 against JAX; the
sharded port against the unsharded port exactly.
"""

import importlib
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import bench  # noqa: E402
import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.interop import state_from_numpy, state_to_numpy  # noqa: E402
from siddhi_tpu_torch.parallel import keyshard as pks  # noqa: E402
from siddhi_tpu_torch.parallel import shard as pshard  # noqa: E402
from siddhi_tpu_torch.parallel.mesh import mesh_devices, shard_partitioned_query  # noqa: E402
from siddhi_tpu_torch.query_api.annotation import Annotation  # noqa: E402
from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYMS = ["WSO2", "IBM", "GOOG", "MSFT", "ORCL", "AAPL", "AMZN", "NVDA"]


def _port(*_a, **_k):
    return siddhi_tpu_torch.SiddhiManager(device="cpu")


def _owner_of(keys, n):
    """The JAX test's numpy `owner_of`, answered by the port's plain K49."""
    return pks.owner_of(torch.from_numpy(np.asarray(keys, np.int64)), n).numpy()


SWAPS = {
    "tests.test_shard_exec": {
        "SiddhiManager": _port, "SiddhiAppCreationError": SiddhiAppCreationError,
        "resolve_shard_annotation": pshard.resolve_shard_annotation,
        "router_eligible": pshard.router_eligible,
        "shardable_stateless": pshard.shardable_stateless, "Annotation": Annotation},
    "tests.test_keyshard": {
        "SiddhiManager": _port, "keyed_shardable": pks.keyed_shardable, "mix64": pks.mix64,
        "owner_of": _owner_of},
    "tests.test_lineage": {"SiddhiManager": _port},
}

JAX_CASES = [
    ("tests.test_shard_exec", "TestShardResolution", "test_annotation_devices_and_axis", {}),
    ("tests.test_shard_exec", "TestShardResolution", "test_sole_positional_devices", {}),
    ("tests.test_shard_exec", "TestShardResolution", "test_no_annotation_defaults_off", {}),
    ("tests.test_shard_exec", "TestShardResolution",
     "test_env_overrides_annotation_both_directions", {}),
    *[("tests.test_shard_exec", "TestShardResolution", "test_malformed_annotation_raises",
       {"elements": e}) for e in (
        [("devices", "0")], [("devices", "-3")], [("devices", "many")],
        [("devices", "8"), ("axis", "diagonal")], [("devices", "8"), ("turbo", "on")])],
    ("tests.test_shard_exec", "TestShardResolution", "test_runtime_creation_rejects_malformed",
     {}),
    ("tests.test_shard_exec", "TestBatchRouter", "test_round_robin_distribution_and_counts", {}),
    ("tests.test_shard_exec", "TestBatchRouter",
     "test_merge_preserves_delivery_order_byte_identically", {}),
    ("tests.test_shard_exec", "TestBatchRouter",
     "test_multi_chunk_per_device_stays_byte_identical", {}),
    ("tests.test_shard_exec", "TestBatchRouter",
     "test_guarded_junction_owns_sharded_drain_failures", {}),
    ("tests.test_shard_exec", "TestBatchRouter", "test_short_sends_fall_back_to_single_device",
     {}),
    ("tests.test_shard_exec", "TestBatchRouter", "test_stateful_endpoints_not_routed", {}),
    ("tests.test_shard_exec", "TestBatchRouter", "test_shardable_stateless_predicate", {}),
    ("tests.test_shard_exec", "TestPartitionMesh", "test_parity_over_key_churn", {}),
    ("tests.test_shard_exec", "TestPartitionMesh", "test_indivisible_capacity_pads_to_mesh", {}),
    ("tests.test_shard_exec", "TestPartitionMesh",
     "test_annotation_axis_part_only_skips_batch_router", {}),
    ("tests.test_keyshard", "TestOwnerHash", "test_mix64_host_device_agree", {}),
    ("tests.test_keyshard", "TestOwnerHash", "test_owner_partition_is_total_and_disjoint", {}),
    *[("tests.test_keyshard", "TestEligibility", "test_predicate", {"case": c}) for c in (
        "avg_float", "exact_ints", "extreme_float", "no_group", "ordered", "stddev_float",
        "sum_float", "windowed")],
    ("tests.test_keyshard", "TestEligibility", "test_float_aggregators_reported_with_reason", {}),
    ("tests.test_keyshard", "TestGroupByParity", "test_byte_parity_and_occupancy", {}),
    ("tests.test_keyshard", "TestJoinMesh", "test_join_parity_and_placement", {}),
    ("tests.test_keyshard", "TestFusionVeto", "test_fused_run_keeps_query_sharded_with_parity",
     {}),
    ("tests.test_keyshard", "TestPartitionPadding", "test_capacity_6_on_8_device_mesh", {}),
    ("tests.test_lineage", "TestParity", "test_records_identical_shard_8_vs_0", {}),
]


@pytest.mark.parametrize("modname,cname,fname,kw", JAX_CASES,
                         ids=[f"{c}.{f}{'-' + str(list(k.values())[0]) if k else ''}"
                              for _m, c, f, k in JAX_CASES])
def test_jax_shard_test_on_the_port(modname, cname, fname, kw, monkeypatch):
    """The JAX test itself with the port swapped in: its own assertions
    hold the port's rows, placements and counters."""
    mod = importlib.import_module(modname)
    for name, obj in SWAPS[modname].items():
        monkeypatch.setattr(mod, name, obj)
    if modname == "tests.test_lineage":
        monkeypatch.setattr(mod, "_drain", lambda: None)
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    case = getattr(mod, cname)()
    fn = getattr(case, fname)
    args = dict(kw)
    if "monkeypatch" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        args["monkeypatch"] = monkeypatch
    fn(**args)


def test_sharded_equality_on_the_port():
    """tests/test_sharded_equality.py's run on the port: 60 steps of key
    churn (20 keys over 32 slots, 8 shards), the routed step's rows against
    the unsharded keyed step's, sorted, step by step."""
    mod = importlib.import_module("tests.test_sharded_equality")
    feed = mod._batches()

    def run(sharded):
        mgr = _port()
        rt = mgr.create_siddhi_app_runtime(mod.QL)
        rt.start()
        qr = rt.queries["q"]
        schema = qr.in_schema
        if sharded:
            sq = shard_partitioned_query(qr, mesh_devices("cpu")[:8])
            step = sq.step
        else:
            box = [dict(rt.partitions[0].ptable), qr.init_state()]

            def step(batch, now):
                box[0], box[1], out, _ctx = qr._pstep_outer(
                    box[0], box[1], batch, torch.tensor(now, dtype=torch.int64))
                return out, {}
        rows = []
        for ts, cols in feed:
            batch = schema.to_batch_cols(ts, cols, mgr.interner, "cpu", capacity=64)
            out, _aux = step(batch, int(ts[-1]))
            v = out.valid.numpy()
            lanes = [out.ts.numpy()] + [c.numpy() for c in out.cols.values()]
            rows.append(sorted(tuple(x[i].item() for x in lanes) for i in np.nonzero(v)[0]))
        rt.shutdown()
        mgr.shutdown()
        return rows

    unsharded, sharded = run(False), run(True)
    assert len(unsharded) == len(sharded) == len(feed)
    assert sum(len(r) for r in unsharded) > 1000
    for i, (a, b) in enumerate(zip(unsharded, sharded)):
        assert a == b, f"step {i}: sharded output diverged"


# ---------------------------------------------------------------------------
# the three axes: sharded = the port unsharded = JAX unsharded
# ---------------------------------------------------------------------------

AXIS_APPS = {
    "part": """@app:batch(size='{b}') @app:partitionCapacity(size='12')
{head}define stream S (symbol string, price float, volume long);
partition with (symbol of S) begin
  @info(name='q') from S[price > 5]#window.length(6)
    select symbol, sum(volume) as v, max(price) as mx, count() as n insert into Out;
end;
""",
    "keys": """@app:batch(size='{b}')
{head}define stream S (symbol string, price float, volume long);
@info(name='f') from S[price > 40] select symbol, volume insert into F;
@info(name='q') from S select symbol, count() as n, max(price) as hi, sum(volume) as vol
 group by symbol insert into Out;
""",
    "batch": """@app:batch(size='{b}')
{head}define stream S (symbol string, price float, volume long);
@info(name='q') from S[price > 50] select symbol, price, volume insert into Out;
@info(name='f') from S select symbol, volume * 2 as v2 insert into F;
""",
}


def _axis_feed(n, seed=17):
    rng = np.random.default_rng(seed)
    return (np.arange(n, dtype=np.int64) + 1_700_000_000_000,
            {"symbol": rng.integers(1, 9, n).astype(np.int32),
             "price": rng.uniform(0, 100, n).astype(np.float32),
             "volume": rng.integers(1, 1000, n).astype(np.int64)})


def _calls(n):
    """Three send_columns calls: 37 events, then two halves of the rest."""
    return ((0, 37), (37, n // 2), (n // 2, n))


def _run_axis(mgr, app, fused, calls):
    for s in SYMS:
        mgr.interner.intern(s)
    rt = mgr.create_siddhi_app_runtime(app)
    got = {q: [] for q in ("q", "f") if q in rt.queries}
    for q in got:
        rt.add_callback(q, lambda t, i, r, _q=q: got[_q].extend(tuple(e.data) for e in i or []))
    rt.start()
    if not fused:
        for j in rt.junctions.values():
            j.fused_ingest = None
    ts, cols = calls
    h = rt.get_input_handler("S")
    for lo, hi in _calls(len(ts)):
        h.send_columns(ts[lo:hi], {k: v[lo:hi] for k, v in cols.items()}, now=int(ts[hi - 1]))
    status = rt.snapshot_status()
    rt.shutdown()
    mgr.shutdown()
    return got, status


@pytest.mark.parametrize("axis", ["part", "keys", "batch"])
@pytest.mark.parametrize("b", [16, 33])
def test_axes_match_unsharded_and_jax(axis, b, monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    feed = _axis_feed(12 * b + 5)
    sharded_app = AXIS_APPS[axis].format(b=b, head=f"@app:shard(devices='8', axis='{axis}')\n")
    plain_app = AXIS_APPS[axis].format(b=b, head="")
    want, _ = _run_axis(siddhi_tpu.SiddhiManager(), plain_app, False, feed)
    assert want["q"]
    for fused in (True, False):
        got, status = _run_axis(_port(), sharded_app, fused, feed)
        off, _ = _run_axis(_port(), plain_app, fused, feed)
        assert got == off, (axis, fused)
        assert bench._rows_match(got, want), (axis, fused)
        shard = status["shard"]
        assert shard["devices"] == 8
        if axis == "part":
            assert shard["partitioned"]["q"]["sharded"]
        elif axis == "keys":
            assert shard["keyshard"]["q"]["sharded"] and shard["keyshard"]["q"]["total_keys"] == 8
        elif fused:  # every call of two batches or more went through the router
            n = len(feed[0])
            routed = sum(hi - lo for lo, hi in _calls(n) if hi - lo >= 2 * b)
            assert sum(shard["streams"]["S"]["per_device_events"]) == routed > 0


# ---------------------------------------------------------------------------
# the verify cases under SIDDHI_TPU_SHARD=8
# ---------------------------------------------------------------------------


def test_verify_cases_under_shard_8_match_frozen_rows(monkeypatch):
    """bench.py:_leg_verify on the port (its SiddhiManager swapped in) under
    SIDDHI_TPU_SHARD=8: every case's rows equal VERIFY.json's; the one case
    not frozen there equals the port's unsharded run."""
    monkeypatch.setattr(siddhi_tpu, "SiddhiManager", _port)
    monkeypatch.delenv("SIDDHI_TPU_VERIFY_COLUMNAR", raising=False)
    monkeypatch.setenv("SIDDHI_TPU_SHARD", "8")
    sharded = bench._leg_verify()["cases"]
    with open(os.path.join(ROOT, "VERIFY.json")) as f:
        frozen = json.load(f)["cpu"]
    assert len(sharded) == 21
    errors = {k: v for k, v in sharded.items() if isinstance(v, str)}
    assert not errors, errors
    for name, rows in sharded.items():
        if name in frozen:
            assert bench._rows_match(json.loads(json.dumps(rows)), frozen[name]), name
    monkeypatch.setenv("SIDDHI_TPU_SHARD", "0")
    monkeypatch.setattr(bench, "VERIFY_CASES", {k: v for k, v in bench.VERIFY_CASES.items()
                                                if k not in frozen})
    monkeypatch.setattr(bench, "VERIFY_TABLE_CASES", {})
    off = bench._leg_verify()["cases"]
    assert off and all(sharded[k] == v for k, v in off.items()), sorted(off)


# ---------------------------------------------------------------------------
# export_state / import_state against JAX's
# ---------------------------------------------------------------------------

KS_APP = """@app:batch(size='32')
{head}define stream S (symbol string, price float, volume long);
@info(name='q') from S select symbol, sum(volume) as sv, count() as c, min(volume) as mn,
 max(price) as hi group by symbol insert into Out;
"""


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np_tree(v) for v in tree)
    return np.asarray(jax.device_get(tree))


def _same_tree(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8) if a.dtype != bool else a, b.view(np.uint8) if b.dtype != bool else b)


def test_export_import_match_jax(monkeypatch):
    from siddhi_tpu.parallel.keyshard import KeyShardedGroupExec as JaxExec

    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    feed = _axis_feed(200, seed=23)
    feed[1]["symbol"] = np.random.default_rng(1).integers(1, 41, 200).astype(np.int32)
    runs = {}
    for key, head in (("8", "@app:shard(devices='8', axis='keys')\n"), ("0", "")):
        jm = siddhi_tpu.SiddhiManager()
        for i in range(1, 41):
            jm.interner.intern(f"K{i}")
        jrt = jm.create_siddhi_app_runtime(KS_APP.format(head=head))
        jrt.start()
        jrt.get_input_handler("S").send_columns(feed[0], feed[1], now=int(feed[0][-1]))
        runs[key] = (jm, jrt, jrt.queries["q"])
    pm = _port()
    prt = pm.create_siddhi_app_runtime(KS_APP.format(head="@app:shard(devices='8', axis='keys')\n"))
    prt.start()
    pq = prt.queries["q"]
    _jm, _jrt, jq8 = runs["8"]
    jstate8 = _np_tree(jq8.state)
    # 8 -> 8: the canonical export of the same carried state
    want = jq8._keyshard.export_state(jq8.state)
    got = pq._keyshard.export_state(state_from_numpy(jstate8, "cpu"))
    _same_tree(got, _np_tree(want))
    # 8 -> 4: the export re-hashed onto four devices
    j4 = JaxExec(jq8, jax.devices()[:4])
    p4 = pks.KeyShardedGroupExec(pq, mesh_devices("cpu")[:4])
    _same_tree(state_to_numpy(p4.import_state(got)), _np_tree(j4.import_state(want)))
    # 0 -> 8: an unsharded state onto eight devices
    one = _np_tree(runs["0"][2].state)
    _same_tree(state_to_numpy(pq._keyshard.import_state(one)),
               _np_tree(jq8._keyshard.import_state(one)))
    # a raw snapshot restores onto its own mesh size only
    raw = {"__keyshard_raw__": 8, "state": jstate8}
    _same_tree(state_to_numpy(pq._keyshard.import_state(raw)), jstate8)
    with pytest.raises(ValueError, match="cannot restore onto 4"):
        p4.import_state(raw)
    assert int(np.asarray(got["sel"]["group"]["n"])) == 40
    for jm, jrt, _q in runs.values():
        jrt.shutdown()
        jm.shutdown()
    prt.shutdown()
    pm.shutdown()


# ---------------------------------------------------------------------------
# one device; malformed annotations; the import
# ---------------------------------------------------------------------------


def _shard_warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if r.name.endswith("parallel.shard") and r.levelno == logging.WARNING]


def test_one_device_warns_and_turns_off_as_jax(monkeypatch, caplog):
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    app = AXIS_APPS["keys"].format(b=16, head="@app:shard(devices='8', axis='keys')\n")
    feed = _axis_feed(100)
    real = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real[:1])
    with caplog.at_level(logging.WARNING):
        want, jstatus = _run_axis(siddhi_tpu.SiddhiManager(), app, True, feed)
    jax_msgs = _shard_warnings(caplog)
    caplog.clear()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real)
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    assert len(mesh_devices("cpu")) == 1
    with caplog.at_level(logging.WARNING):
        got, status = _run_axis(_port(), app, True, feed)
    assert len(jax_msgs) == 2 and _shard_warnings(caplog) == jax_msgs
    assert status["shard"] == jstatus["shard"] == {"devices": 1, "requested": 8, "axis": "keys"}
    assert bench._rows_match(got, want)


MALFORMED = [
    "@app:shard(devices='0')",
    "@app:shard(devices='65')",
    "@app:shard(devices='many')",
    "@app:shard('x')",
    "@app:shard(devices='8', axis='diagonal')",
    "@app:shard(devices='8', turbo='on')",
    "@app:shard(devices='4', '2')",
]


@pytest.mark.parametrize("ann", MALFORMED)
def test_malformed_annotations_raise_as_jax(ann, monkeypatch):
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    app = ann + "\ndefine stream S (a int);\nfrom S select a insert into Out;"
    msgs = []
    for mgr, err in ((siddhi_tpu.SiddhiManager(),
                      importlib.import_module("siddhi_tpu.core.errors").SiddhiAppCreationError),
                     (_port(), SiddhiAppCreationError)):
        with pytest.raises(err) as e:
            mgr.create_siddhi_app_runtime(app)
        msgs.append(str(e.value))
        mgr.shutdown()
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("env,axis_env", [("off", ""), ("bogus", "keys"), ("3", "sideways")])
def test_env_overrides_as_jax(env, axis_env, monkeypatch, caplog):
    from siddhi_tpu.parallel import shard as jshard
    from siddhi_tpu.query_api.annotation import Annotation as JaxAnnotation

    monkeypatch.setenv("SIDDHI_TPU_SHARD", env)
    monkeypatch.setenv("SIDDHI_TPU_SHARD_AXIS", axis_env)
    elems = [("devices", "8"), ("axis", "part")]
    with caplog.at_level(logging.WARNING):
        want = jshard.resolve_shard_annotation(JaxAnnotation("app:shard", elems))
        got = pshard.resolve_shard_annotation(Annotation("app:shard", elems))
    assert got == want
    msgs = [r.getMessage() for r in caplog.records if r.name.endswith("parallel.shard")]
    assert msgs[:len(msgs) // 2] == msgs[len(msgs) // 2:]


def test_parallel_imports_no_jax():
    code = ("import sys; import siddhi_tpu_torch.parallel, siddhi_tpu_torch.parallel.mesh, "
            "siddhi_tpu_torch.parallel.keyshard; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'siddhi_tpu.')) or m == 'siddhi_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_lineage_under_keyshard_equals_unsharded(monkeypatch):
    """@app:lineage on a key-sharded group-by: the sharded step's `__lin.*`
    lanes (the pre-mask chain output, the folded rows) give the same rows
    and the same resolved records as the app with sharding off."""
    monkeypatch.delenv("SIDDHI_TPU_SHARD", raising=False)
    monkeypatch.delenv("SIDDHI_TPU_SHARD_AXIS", raising=False)
    app = ("@app:lineage(capacity='4096') @app:batch(size='32')\n{head}"
           "define stream S (symbol string, price float, volume long);\n"
           "@info(name='q') from S select symbol, count() as n, max(price) as hi,"
           " sum(volume) as vol group by symbol insert into Out;")
    feed = _axis_feed(300, seed=2)

    def run(head):
        mgr = _port()
        for s in SYMS:
            mgr.interner.intern(s)
        rt = mgr.create_siddhi_app_runtime(app.format(head=head))
        got = []
        rt.add_callback("q", lambda t, i, r: got.extend(tuple(e.data) for e in i or []))
        rt.start()
        for lo, hi in _calls(len(feed[0])):
            rt.get_input_handler("S").send_columns(
                feed[0][lo:hi], {k: v[lo:hi] for k, v in feed[1].items()},
                now=int(feed[0][hi - 1]))
        lin = rt.queries["q"].lineage
        recs = [rt.lineage("q", i) for i in range(lin.out_count)]
        armed = rt.queries["q"]._keyshard is not None
        rt.shutdown()
        mgr.shutdown()
        return got, recs, armed

    got, recs, armed = run("@app:shard(devices='8', axis='keys')\n")
    off, off_recs, off_armed = run("")
    assert armed and not off_armed
    assert got == off and len(got) == 300
    assert recs == off_recs
