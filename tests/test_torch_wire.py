"""The port's wire codec (siddhi_tpu_torch/core/wire.py) against the JAX
package's (siddhi_tpu/core/wire.py), on the CPU.

For the cases of tests/test_wire.py::TestCodec and tests/test_wire_codec.py:
the port's encode writes the same bytes as the JAX encode, and the port's
plain K4 decode (`wire_decode_ref`, what the kernel is held against on the
card) gives the same lanes as the JAX decode on those bytes. Tolerance: none —
ts, every column (floats compared bit for bit, NaN fills included) and valid
must be equal. Spec and annotation parsing must agree on the
TestSpec/TestAnnotation inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import siddhi_tpu  # noqa: E402
import siddhi_tpu_torch  # noqa: E402
from siddhi_tpu.core import wire as JW  # noqa: E402
from siddhi_tpu.core.event import StreamSchema as JSchema  # noqa: E402
from siddhi_tpu.core.types import AttrType as JType  # noqa: E402
from siddhi_tpu_torch.core import wire as PW  # noqa: E402
from siddhi_tpu_torch.core.event import StreamSchema as PSchema  # noqa: E402
from siddhi_tpu_torch.core.event import WireNarrowMisfit  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiAppCreationError  # noqa: E402
from siddhi_tpu_torch.core.types import AttrType as PType  # noqa: E402

ATTRS = [("sym", "STRING"), ("price", "FLOAT"), ("vol", "LONG"), ("seq", "LONG"),
         ("flag", "BOOL")]
J_SCHEMA = JSchema("S", [(n, JType[t]) for n, t in ATTRS])
P_SCHEMA = PSchema("S", [(n, PType[t]) for n, t in ATTRS])

ENC = {
    "sym": ("dict", np.dtype(np.uint8), 4),
    "vol": ("narrow", np.dtype(np.int16)),
    "seq": ("delta", np.dtype(np.int16)),
    "flag": ("bitpack",),
    "__tsd__": np.dtype(np.int8),
}


def _sample(cap=16):
    ts = np.arange(cap, dtype=np.int64) * 3 + 1_700_000_000_000
    cols = {
        "sym": (np.arange(cap, dtype=np.int32) % 4) + 5,
        "price": np.linspace(0, 10, cap).astype(np.float32),
        "vol": np.arange(cap, dtype=np.int64) * 100,
        "seq": np.arange(cap, dtype=np.int64) + 10**12,
        "flag": (np.arange(cap) % 2 == 0),
    }
    return ts, cols


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.bool_:
        return bool(np.array_equal(a, b))
    return bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _check(cap, keep, enc, ts, cols, n):
    """Encode with both codecs, then decode the bytes with both decoders."""
    j_enc, j_dec, j_total = J_SCHEMA.wire_codec(cap, keep, enc)
    p_enc, p_dec, p_total = P_SCHEMA.wire_codec(cap, keep, enc)
    assert p_total == j_total
    j_buf, j_base = j_enc(ts, cols, n)
    p_buf, p_base = p_enc(ts, cols, n)
    assert np.array_equal(p_buf, np.asarray(j_buf)) and p_base == j_base
    jb = j_dec(j_buf, np.int32(n), j_base)
    pb = p_dec(
        torch.from_numpy(p_buf[None].copy()),
        torch.tensor([n], dtype=torch.int32),
        torch.tensor([p_base], dtype=torch.int64),
    )
    assert _same_bits(pb.ts[0].numpy(), np.asarray(jb.ts))
    assert _same_bits(pb.valid[0].numpy(), np.asarray(jb.valid))
    assert list(pb.cols) == list(jb.cols)
    for name in jb.cols:
        assert _same_bits(pb.cols[name][0].numpy(), np.asarray(jb.cols[name])), name
    return pb, p_total


class TestCodec:
    def test_round_trip_all_encoders(self):
        ts, cols = _sample(16)
        pb, total = _check(16, None, ENC, ts, cols, 16)
        assert total < PW.logical_row_bytes(P_SCHEMA.attrs) * 16 / 2
        assert np.array_equal(pb.ts[0].numpy(), ts)
        for k, v in cols.items():
            assert np.array_equal(pb.cols[k][0].numpy(), v), k

    def test_partial_batch(self):
        ts, cols = _sample(16)
        pb, _ = _check(16, None, ENC, ts, cols, 5)
        assert np.array_equal(pb.valid[0].numpy(), np.arange(16) < 5)

    def test_empty_batch(self):
        ts, cols = _sample(8)
        pb, _ = _check(8, None, ENC, ts[:0], {k: v[:0] for k, v in cols.items()}, 0)
        assert not bool(pb.valid.any())

    @pytest.mark.parametrize("col,bad", [
        ("sym", lambda c: np.arange(16, dtype=np.int32)),  # 16 distinct > 4
        ("vol", lambda c: np.full(16, 10**6, np.int64)),  # > int16
        ("seq", lambda c: np.where(np.arange(16) >= 8, c + 10**6, c)),  # diff > int16
    ], ids=["dict_cardinality", "narrow_range", "delta_jump"])
    def test_guards_match(self, col, bad):
        ts, cols = _sample(16)
        cols = dict(cols)
        cols[col] = bad(cols[col])
        j_enc, _d, _t = J_SCHEMA.wire_codec(16, None, ENC)
        p_enc, _d, _t = P_SCHEMA.wire_codec(16, None, ENC)
        from siddhi_tpu.core.event import WireNarrowMisfit as JMisfit

        with pytest.raises(JMisfit):
            j_enc(ts, cols, 16)
        with pytest.raises(WireNarrowMisfit):
            p_enc(ts, cols, 16)

    def test_projection_still_applies(self):
        ts, cols = _sample(8)
        keep = frozenset(("sym", "flag"))
        pb, total = _check(8, keep, ENC, ts, cols, 8)
        _e, _d, total_all = P_SCHEMA.wire_codec(8, None, ENC)
        assert total < total_all
        assert set(pb.cols) == {n for n, _t in P_SCHEMA.attrs}  # shape kept

    @pytest.mark.parametrize("enc", [
        {},  # full width: int32 tsd offsets, every lane wide
        {"__tsd__": np.dtype(np.int16), "vol": np.dtype(np.int32)},  # sampled form
        {"__tsd__": np.dtype(np.int16), "sym": ("dict", np.dtype(np.uint16), 300)},
    ], ids=["full_width", "sampled", "dict_u16"])
    @pytest.mark.parametrize("cap,n", [(33, 33), (33, 20), (7, 1)])
    def test_ragged_layouts(self, enc, cap, n):
        """Sections at odd byte offsets (33 two-byte rows put the next lane at
        offset 66): the decode must not depend on alignment."""
        rng = np.random.default_rng(cap * 7 + n)
        ts = np.cumsum(rng.integers(0, 9, cap)).astype(np.int64) + 1_700_000_000_000
        cols = {
            "sym": rng.integers(1, 200, cap).astype(np.int32),
            "price": rng.uniform(-5, 5, cap).astype(np.float32),
            "vol": rng.integers(-30000, 30000, cap).astype(np.int64),
            "seq": rng.integers(0, 10**12, cap).astype(np.int64),
            "flag": rng.integers(0, 2, cap).astype(bool),
        }
        _check(cap, None, enc, ts, cols, n)


def _app_schema(ql):
    return siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)


QS_APP = """@app:batch(size='64')
    define stream S (symbol string, price float, volume long);
    @info(name='q') from S[price > 50] select symbol, price insert into Out;
"""


class TestProjection:
    """tests/test_wire_codec.py through the port's engine."""

    def test_projection_drops_unread_columns_and_shrinks_wire(self):
        rt = _app_schema(QS_APP)
        rt.start()
        fi = rt.junctions["S"].fused_ingest
        assert fi is not None
        keep = fi._compute_keep()
        assert keep is not None and "volume" not in keep and {"symbol", "price"} <= keep
        _e, _d, nb = rt.junctions["S"].schema.wire_codec(64, keep, {})
        assert nb == 64 * 12  # 4B ts offset + 4B symbol + 4B price
        rt.shutdown()

    def test_select_star_keeps_everything(self):
        rt = _app_schema(QS_APP.replace("select symbol, price", "select *"))
        rt.start()
        assert rt.junctions["S"].fused_ingest._compute_keep() is None
        rt.shutdown()

    def test_round_trip_with_dropped_column(self):
        keep = frozenset({"symbol"})
        schema_j = JSchema("S", [("symbol", JType.STRING), ("price", JType.FLOAT),
                                 ("volume", JType.LONG)])
        schema_p = PSchema("S", [("symbol", PType.STRING), ("price", PType.FLOAT),
                                 ("volume", PType.LONG)])
        ts = np.arange(5, dtype=np.int64) + 1_700_000_000_000
        cols = {"symbol": np.arange(1, 6, dtype=np.int32), "price": np.ones(5, np.float32),
                "volume": np.ones(5, np.int64)}
        je, jd, _ = schema_j.wire_codec(8, keep)
        pe, pd, _ = schema_p.wire_codec(8, keep)
        jbuf, jbase = je(ts, cols, 5)
        pbuf, pbase = pe(ts, cols, 5)
        assert np.array_equal(pbuf, np.asarray(jbuf))
        jb = jd(jbuf, np.int32(5), jbase)
        pb = pd(torch.from_numpy(pbuf[None].copy()), torch.tensor([5], dtype=torch.int32),
                torch.tensor([pbase]))
        for name in ("symbol", "price", "volume"):  # dropped ones: null fill
            assert _same_bits(pb.cols[name][0].numpy(), np.asarray(jb.cols[name])), name


class TestSpec:
    HINTS = {
        ("S", "vol"): ("range", 0, 30000),
        ("S", "sym"): ("dict", 16),
        ("S", "seq"): ("delta", np.dtype(np.int16)),
    }

    @pytest.mark.parametrize("capacity", [None, 8, 64])
    def test_build_wire_spec_agrees(self, capacity):
        j = JW.build_wire_spec("S", J_SCHEMA.attrs, self.HINTS, capacity)
        p = PW.build_wire_spec("S", P_SCHEMA.attrs, self.HINTS, capacity)
        assert p.encodings == j.encodings
        assert {k: PW.encoding_label(e) for k, e in p.encodings.items()} == j.to_dict()[
            "encodings"]
        assert p.encodings["flag"] == ("bitpack",)

    def test_spec_none_without_static_material(self):
        attrs = [("a", PType.INT), ("b", PType.FLOAT)]
        assert PW.build_wire_spec("X", attrs, {}) is None

    def test_choose_encodings_disabled_is_full_width(self):
        ts, cols = _sample(8)
        assert PW.choose_encodings(P_SCHEMA, None, None, False, ts, cols) == {}

    def test_choose_encodings_agrees(self):
        ts, cols = _sample(8)
        hints = {("S", "vol"): ("range", 0, 100000)}
        jspec = JW.build_wire_spec("S", J_SCHEMA.attrs, hints)
        pspec = PW.build_wire_spec("S", P_SCHEMA.attrs, hints)
        for keep in (None, frozenset({"vol", "flag"})):
            j = JW.choose_encodings(J_SCHEMA, keep, jspec, True, ts, cols)
            p = PW.choose_encodings(P_SCHEMA, keep, pspec, True, ts, cols)
            assert p == j
        assert p["vol"] == ("narrow", np.dtype(np.int32))  # declared beats sampled

    def test_estimates_and_report(self):
        assert PW.logical_row_bytes(P_SCHEMA.attrs) == JW.logical_row_bytes(J_SCHEMA.attrs)
        for keep in (None, frozenset({"sym"})):
            spec = PW.build_wire_spec("S", P_SCHEMA.attrs, {("S", "sym"): ("dict", 16)})
            jspec = JW.build_wire_spec("S", J_SCHEMA.attrs, {("S", "sym"): ("dict", 16)})
            p = PW.wire_report(P_SCHEMA, keep, ENC, spec, capacity=64)
            j = JW.wire_report(J_SCHEMA, keep, ENC, jspec, capacity=64)
            assert p == j


class _Ann:
    def __init__(self, elements):
        self.elements = elements

    def element(self, key, default=None):
        for k, v in self.elements:
            if k == key:
                return v
        return default


ANNOTATIONS = [
    [],
    [("disable", "true")],
    [("disable", "maybe")],
    [("range.S.price", "1..2")],
    [("range.S.vol", "5..1")],
    [("dict.Ghost.col", "8")],
    [("dict.S.sym", "1")],
    [("delta.S.seq", "int64")],
    [("zap.S.a", "1")],
    [(None, "x")],
    [("range.S.vol", "0..300"), ("dict.S.sym", "16"), ("delta.S.seq", "true")],
]


class TestAnnotation:
    @pytest.mark.parametrize("elements", ANNOTATIONS, ids=range(len(ANNOTATIONS)))
    def test_problems_and_hints_agree(self, elements):
        ann = _Ann(elements)
        assert list(PW.iter_wire_annotation_problems(ann)) == list(
            JW.iter_wire_annotation_problems(ann))
        assert PW.parse_wire_hints(ann) == JW.parse_wire_hints(ann)

    def test_resolve_defaults_on(self, monkeypatch):
        monkeypatch.delenv(PW.WIRE_ENV, raising=False)
        assert PW.resolve_wire_annotation(None) == (True, {})

    def test_env_precedence(self, monkeypatch):
        monkeypatch.setenv(PW.WIRE_ENV, "0")
        assert PW.resolve_wire_annotation(None)[0] is False
        monkeypatch.setenv(PW.WIRE_ENV, "1")
        assert PW.resolve_wire_annotation(_Ann([("disable", "true")]))[0] is True

    @pytest.mark.parametrize("ann", [
        "@app:wire(disable='maybe')",
        "@app:wire(range.S.a='9..1')",
        "@app:wire(zap.S.a='1')",
        "@app:ingestChunk(size='many')",
    ])
    def test_malformed_raises_at_creation(self, ann):
        ql = f"{ann}\ndefine stream S (a int);\nfrom S select a insert into Out;"
        with pytest.raises(SiddhiAppCreationError):
            siddhi_tpu_torch.SiddhiManager(device="cpu").create_siddhi_app_runtime(ql)
        if "wire" in ann:
            with pytest.raises(siddhi_tpu.core.errors.SiddhiAppCreationError):
                siddhi_tpu.SiddhiManager().create_siddhi_app_runtime(ql)
