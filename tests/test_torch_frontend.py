"""The port's copied SiddhiQL front end parses every app to the same AST as
the JAX package's, compared by a structural dump of class names and fields."""

import ast
import dataclasses
import enum
from pathlib import Path

import pytest

pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

import bench  # noqa: E402
from siddhi_tpu.compiler.siddhi_compiler import SiddhiCompiler as JaxCompiler  # noqa: E402
from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler  # noqa: E402
from siddhi_tpu_torch.core.errors import SiddhiParserError  # noqa: E402


def _parser_test_apps() -> list[str]:
    """Every literal app string that tests/test_parser.py hands to parse()."""
    tree = ast.parse((Path(__file__).parent / "test_parser.py").read_text())
    apps = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "parse"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            apps.append(node.args[0].value)
    return apps


APPS = (
    [("verify_" + k, v) for k, v in bench.VERIFY_CASES.items()]
    + [("verify_" + k, v[0]) for k, v in bench.VERIFY_TABLE_CASES.items()]
    + [(f"test_parser_{i}", s) for i, s in enumerate(_parser_test_apps())]
)


def dump(x):
    """Structural dump: class name + fields, enums by class and member name."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, dump(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, dump(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(dump(v) for v in x)
    assert x is None or isinstance(x, (str, int, float, bool)), type(x)
    return x


def test_parser_corpus_is_collected():
    assert len(_parser_test_apps()) >= 20


@pytest.mark.parametrize("name,app", APPS, ids=[n for n, _ in APPS])
def test_same_ast(name, app):
    try:
        want = dump(JaxCompiler.parse(app))
    except Exception as e:  # an app that must fail: the same error, same place
        with pytest.raises(Exception) as got:
            SiddhiCompiler.parse(app)
        assert (type(got.value).__name__, str(got.value)) == (type(e).__name__, str(e))
        return
    assert dump(SiddhiCompiler.parse(app)) == want


def test_parse_error_location():
    with pytest.raises(SiddhiParserError, match="line 2"):
        SiddhiCompiler.parse("define stream S (a int)\nfrom S select ^ insert into O;")
