"""The intra-op thread count of torch for the port's tests.

The port's tests run small tensors, where torch's default of one intra-op
thread a core only costs: on an 8-core host, one test of
tests/test_torch_join_e2e.py took 65.8 s alone with 8 threads and 25.2 s with
one, and the suite runs six pytest-xdist workers side by side beside XLA's
own pools. Every `tests/test_torch_*.py` calls `cap_torch_threads()` at
import, after its `pytest.importorskip("torch")`.
"""


def cap_torch_threads() -> None:
    import torch

    if torch.get_num_threads() != 1:
        torch.set_num_threads(1)
