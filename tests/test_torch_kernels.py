"""Port kernels: the plain versions of ``gather_rows`` and ``segment_matmul``
against the JAX kernels (Pallas interpret mode and the XLA oracle), and the
wrappers' input checks.  The CUDA kernels themselves are held against their
plain versions in ``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import gather_rows as j_gather  # noqa: E402
from repro.kernels import segment_matmul as j_segmm  # noqa: E402
from repro_torch import backend  # noqa: E402
from repro_torch.kernels import gather_rows, segment_matmul  # noqa: E402
from repro_torch.kernels.segment_matmul.ops import sorted_layout  # noqa: E402

from torch_parity import assert_close, assert_exact, t  # noqa: E402


def _segments(seed, E, F, num_rows):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((E, F)).astype(np.float32)
    seg = rng.integers(-2, num_rows + 3, E).astype(np.int32)  # some dropped
    return data, seg


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("F", [1, 4])
def test_segment_sum_plain_matches_jax(impl, F):
    data, seg = _segments(F, 300, F, 37)
    ref = j_segmm(jnp.asarray(data), jnp.asarray(seg), 37, impl=impl)
    before = backend.LAUNCHES["segment_sum"]
    got = segment_matmul(t(data), t(seg), 37)
    assert got.shape == (37, F) and got.dtype == torch.float32
    assert_close(got, ref)
    assert backend.LAUNCHES["segment_sum"] == before     # CPU: no launch


def test_segment_sum_integer_valued_is_bit_exact():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 5, (400, 1)).astype(np.float32)
    seg = rng.integers(0, 20, 400).astype(np.int32)
    ref = j_segmm(jnp.asarray(data), jnp.asarray(seg), 20,
                  impl="pallas_interpret")
    assert_exact(segment_matmul(t(data), t(seg), 20), ref)


@pytest.mark.parametrize("impl", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("rows_per_step", [1, 8])
def test_gather_rows_plain_matches_jax(impl, rows_per_step):
    rng = np.random.default_rng(rows_per_step)
    table = rng.standard_normal((64, 3)).astype(np.float32)
    ids = rng.integers(0, 64 // rows_per_step, 25).astype(np.int32)
    ref = j_gather(jnp.asarray(table), jnp.asarray(ids),
                   rows_per_step=rows_per_step, impl=impl)
    assert_exact(gather_rows(t(table), t(ids), rows_per_step=rows_per_step),
                 ref)


def test_sorted_layout_spans_each_row():
    seg = torch.tensor([3, -1, 0, 3, 9, 1, 0], dtype=torch.int32)
    order, row_ptr = sorted_layout(seg, 4)
    assert row_ptr.tolist() == [0, 2, 3, 3, 5]
    assert order[:5].tolist() == [2, 6, 5, 0, 3]          # stable by row


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        segment_matmul(torch.zeros(4, 1, dtype=torch.float64),
                       torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        segment_matmul(torch.zeros(4, 1), torch.zeros(3, dtype=torch.int32),
                       2)
    with pytest.raises(ValueError):
        segment_matmul(torch.zeros(2, 4).T, torch.zeros(4, dtype=torch.int32),
                       2)
    with pytest.raises(TypeError):
        gather_rows(torch.zeros(8, 1), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(6, 1), torch.zeros(2, dtype=torch.int32),
                    rows_per_step=4)


def test_resolve_device_and_impl():
    assert backend.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        backend.resolve_impl("pallas")
