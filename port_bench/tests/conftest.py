"""Fixtures of the benchmark's tests: `card` skips a test that needs a CUDA
device on a machine without one (decided when the test runs, never while a
module is imported); `tiny` is the graph the CPU runs use in place of the
traffic's, at the cells' widths."""
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("runs the cell on a CUDA device")


@pytest.fixture
def tiny():
    return {"n_nodes": 3000, "n_edges": 20000, "train_nodes": 1600}


# bf16's gaps on 3,000 nodes read up to 4-5 times those on the cells' 169k
# (loss gaps up to 1.7e-4 and 1.4e-4 there, against 3.9e-5 and 1.6e-5); the
# float8 control's and the faults' read 2 to 100 times these limits
SMALL_GRAPH_SCALE = 5.0


@pytest.fixture
def tiny_limits():
    def limits(resolved):
        return {k: v * SMALL_GRAPH_SCALE for k, v in resolved["limits"]["limits"].items()}
    return limits
