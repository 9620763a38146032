"""siddhi_tpu_torch — the stream-processing / complex-event-processing engine on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

SiddhiQL apps compile into steps over micro-batched columnar event tensors with
device-resident carried state (window rings, aggregate carries). Timestamps are
int64 milliseconds; every other tensor uses a 32-bit or narrower dtype, and
nothing in the engine materialises float64.

`SiddhiManager()` runs on the card; `SiddhiManager(device="cpu")` runs the
same engine with the plain PyTorch version of every kernel. This package
imports no JAX.
"""

from siddhi_tpu_torch.core.manager import SiddhiManager
from siddhi_tpu_torch.core.types import AttrType

__version__ = "0.1.0"

__all__ = ["SiddhiManager", "AttrType", "__version__"]
