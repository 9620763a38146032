"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and it runs on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from tests._torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads()

ROOT = Path(__file__).resolve().parent.parent


def _port_files():
    files = sorted((ROOT / "siddhi_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_out():
    # a fresh interpreter: this test process already imported jax (conftest)
    code = (
        "import sys, siddhi_tpu_torch, siddhi_tpu_torch.interop; "
        "import siddhi_tpu_torch.core.app_runtime; "
        "import siddhi_tpu_torch.core.wire, siddhi_tpu_torch.core.ingest, "
        "siddhi_tpu_torch.core.pipeline; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'siddhi_tpu' or m.startswith('siddhi_tpu.')); "
        "assert not bad, bad"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "siddhi_tpu"), (
                f"{path.name}:{node.lineno} imports {name}"
            )


def test_default_device_is_the_card(monkeypatch):
    from siddhi_tpu_torch import SiddhiManager

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SiddhiManager()
    assert SiddhiManager(device="cpu").device.type == "cpu"
