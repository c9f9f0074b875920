import numpy as np
import pytest


@pytest.fixture(scope="session")
def small_graph():
    """Deterministic simple directed graph + dict oracle."""
    rng = np.random.default_rng(0)
    NV, E = 50, 400
    src = rng.integers(0, NV, E)
    dst = rng.integers(0, NV, E)
    pairs = sorted(set(zip(src.tolist(), dst.tolist())))
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    w = rng.random(len(src)).astype(np.float32)
    adj = {(int(s), int(d)): float(ww) for s, d, ww in zip(src, dst, w)}
    return NV, src, dst, w, adj


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (skips without them)")
