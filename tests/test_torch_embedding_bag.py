"""The plain versions of the port's EmbeddingBag against the JAX package:
``embedding_bag`` against ``embedding_bag_ref`` (the XLA oracle) and the
Pallas kernel in interpret mode, at the shapes of test_kernels.py, and
``embedding_bag_sorted`` against the Pallas kernel on a ragged stream; plus
the wrappers' input checks.  The CUDA kernel itself is held against the
plain versions in ``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.embedding_bag import embedding_bag as j_bag  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_ref as j_ref  # noqa
from repro.kernels.embedding_bag.kernel import \
    embedding_bag_sorted as j_sorted  # noqa: E402
from repro_torch import backend  # noqa: E402
from repro_torch.kernels import embedding_bag, embedding_bag_sorted  # noqa
from repro_torch.kernels.embedding_bag.ops import kernel_route  # noqa: E402

from torch_parity import assert_exact, t  # noqa: E402

ATOL = 1e-5          # as tests/test_kernels.py holds the Pallas kernel


def _jax(table, ids, w, impl):
    w = None if w is None else jnp.asarray(w)
    if impl == "xla":
        return j_ref(jnp.asarray(table), jnp.asarray(ids), w)
    return j_bag(jnp.asarray(table), jnp.asarray(ids), w, impl=impl)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("V,F,B,L", [(100, 16, 8, 5), (50, 32, 16, 3),
                                     (200, 64, 4, 10)])
def test_embedding_bag_plain_matches_jax(impl, weighted, V, F, B, L):
    rng = np.random.default_rng(V + F)
    table = rng.random((V, F), np.float32)
    ids = rng.integers(-1, V, (B, L)).astype(np.int32)
    w = rng.random((B, L), np.float32) if weighted else None
    before = backend.LAUNCHES["embedding_bag"]
    got = embedding_bag(t(table), t(ids), None if w is None else t(w))
    assert got.shape == (B, F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax(table, ids, w,
                                                            impl)),
                               atol=ATOL)
    assert backend.LAUNCHES["embedding_bag"] == before      # CPU: no launch


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_one_slot_bags_are_bit_exact(impl):
    """The SASRec lookup: one slot per bag, a scalar weight, -1 at pads."""
    rng = np.random.default_rng(5)
    table = (rng.standard_normal((300, 50)) * 0.02).astype(np.float32)
    ids = rng.integers(-1, 300, (64, 1)).astype(np.int32)
    w = np.float32(50 ** 0.5)
    got = embedding_bag(t(table), t(ids), torch.tensor(w))
    assert_exact(got, _jax(table, ids, np.full((64, 1), w), impl))
    live = ids[:, 0] >= 0       # and each live row is JAX's row * sqrt(d)
    assert_exact(got[live], jnp.asarray(table)[ids[live, 0]] * (50 ** 0.5))


def test_ids_past_the_table_clamp_as_jax():
    rng = np.random.default_rng(6)
    table = rng.random((20, 8), np.float32)
    ids = np.array([[19, 20, 1000], [-1, 25, 0]], np.int32)
    w = rng.random((2, 3), np.float32)
    got = embedding_bag(t(table), t(ids), t(w))
    assert_exact(got, _jax(table, ids, w, "xla"))
    np.testing.assert_allclose(got[0].numpy(), table[19] * w[0].sum(),
                               rtol=1e-6)


def test_embedding_bag_sorted_matches_pallas():
    """A ragged stream sorted by bag, every bag covered, ids -1 and >= V."""
    rng = np.random.default_rng(7)
    V, F, nb = 40, 12, 30
    lens = rng.integers(1, 12, nb)
    seg = np.repeat(np.arange(nb), lens).astype(np.int32)[:200]
    nb = int(seg[-1]) + 1
    ids = rng.integers(-1, V + 3, seg.size).astype(np.int32)
    w = rng.random(seg.size, np.float32)
    table = rng.random((V, F), np.float32)
    ref = j_sorted(jnp.asarray(table), jnp.asarray(ids),
                   jnp.asarray(seg), jnp.asarray(w), num_bags=nb,
                   interpret=True)
    got = embedding_bag_sorted(t(table), t(ids), t(seg), t(w), nb)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_sorted_drops_slots_outside_the_bags():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    seg = torch.tensor([-1, 0, 2, 5], dtype=torch.int32)
    w = torch.ones(4)
    got = embedding_bag_sorted(table, ids, seg, w, 3)
    assert torch.equal(got, torch.stack([table[2], torch.zeros(3), table[3]]))


@pytest.mark.parametrize("num_bags,bag_len,F,route", [
    (204_800, 1, 50, "short_bags"),     # the SASRec bulk-chunk lookup
    (512 * 50, 1, 50, "short_bags"),    # a serve_p99 request's lookup
    (10, 4, 49, "short_bags"),          # the longest short bag, odd F
    (65_536, 32, 50, "warp_per_bag"),   # long weighted bags
    (65_536, 5, 50, "warp_per_bag"),
    (65_536, 0, 50, "warp_per_bag"),    # a ragged stream (sorted wrapper)
    (0, 1, 50, "warp_per_bag"),         # nothing to launch
])
def test_kernel_route_is_a_function_of_the_shape(num_bags, bag_len, F, route):
    assert kernel_route(num_bags, bag_len, F) == route


@pytest.mark.parametrize("L", [1, 3])
def test_scalar_weight_gives_the_expanded_weights_bits(L):
    """A number, a one-element tensor and the weights expanded to [B, L]
    give the same bits (the number rounded to float32 first)."""
    rng = np.random.default_rng(8 + L)
    table = t(rng.standard_normal((500, 50)).astype(np.float32))
    ids = t(rng.integers(-1, 520, (300, L)).astype(np.int32))
    w = 50 ** 0.5
    full = embedding_bag(table, ids, torch.full((300, L), w))
    assert torch.equal(embedding_bag(table, ids, w), full)
    assert torch.equal(embedding_bag(table, ids, torch.tensor(w)), full)
    assert torch.equal(embedding_bag(table, ids, torch.full((1, 1), w)),
                       full)
    assert torch.equal(embedding_bag(table, ids, 1), embedding_bag(table,
                                                                   ids))


def test_wrappers_reject_bad_inputs():
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2, dtype=torch.float64), ids)
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2, dtype=torch.bfloat16), ids)
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2), ids.long())
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2), ids, torch.ones(2, 3,
                                                         dtype=torch.float64))
    with pytest.raises(TypeError):
        embedding_bag(torch.zeros(4, 2), ids, "1.0")
    with pytest.raises(ValueError):
        embedding_bag(torch.zeros(4, 2), ids.reshape(-1))
    with pytest.raises(ValueError):
        embedding_bag(torch.zeros(2, 4).T, ids)
    flat = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        embedding_bag_sorted(torch.zeros(4, 2), flat, flat[:2], torch.ones(3),
                             2)
    with pytest.raises(TypeError):
        embedding_bag_sorted(torch.zeros(4, 2), flat, flat.long(),
                             torch.ones(3), 2)
