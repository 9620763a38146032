"""SiddhiManager — top-level entry point.

Reference: core/SiddhiManager.java:45-243 — create/validate/shutdown app runtimes.
Here it also owns the host-side intern table shared by all apps it creates and
the device every app's tensors live on.
"""

from __future__ import annotations

from typing import Union

import torch

from siddhi_tpu_torch.core.types import InternTable
from siddhi_tpu_torch.query_api.siddhi_app import SiddhiApp


class SiddhiManager:
    """`SiddhiManager(device="cuda")` — the default — runs every app on the
    card and raises if there is none; `device="cpu"` runs the plain PyTorch
    versions of the kernels on the host."""

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SiddhiManager: CUDA is not available on this host; pass "
                "device='cpu' to run the engine's plain PyTorch path"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"SiddhiManager: unsupported device {self.device}")
        self.interner = InternTable()
        self._runtimes: dict[str, object] = {}

    # app: SiddhiQL source text or a programmatic SiddhiApp AST
    def create_siddhi_app_runtime(self, app: Union[str, SiddhiApp]):
        from siddhi_tpu_torch.compiler.siddhi_compiler import SiddhiCompiler
        from siddhi_tpu_torch.core.app_runtime import SiddhiAppRuntime

        if isinstance(app, str):
            app = SiddhiCompiler.parse(app)
        runtime = SiddhiAppRuntime(app, self)
        old = self._runtimes.get(runtime.name)
        if old is not None:
            old.shutdown()
        self._runtimes[runtime.name] = runtime
        return runtime

    create_runtime = create_siddhi_app_runtime

    def get_siddhi_app_runtime(self, name: str):
        return self._runtimes.get(name)

    def flight_records(self) -> dict:
        """Every app's recorded flight rings: app -> stream -> [(ts, row)]."""
        out = {}
        for name, rt in list(self._runtimes.items()):
            recs = rt.flight_records()
            if recs:
                out[name] = recs
        return out

    def lineage_reports(self, resolve_recent: int = 1) -> dict:
        """Every lineage-enabled app's report: app -> per-stream arenas,
        per-query fan-in and the newest resolved chains."""
        out = {}
        for name, rt in list(self._runtimes.items()):
            rep = rt.lineage_report(resolve_recent=resolve_recent)
            if rep:
                out[name] = rep
        return out

    def lineage_text(self) -> str:
        """A human-readable lineage summary of every app."""
        from siddhi_tpu_torch.observability.lineage import render_lineage_text

        reports = self.lineage_reports()
        if not reports:
            return "no lineage-enabled apps (add @app:lineage)\n"
        return render_lineage_text(reports)

    def shutdown(self) -> None:
        for rt in list(self._runtimes.values()):
            rt.shutdown()
        self._runtimes.clear()
