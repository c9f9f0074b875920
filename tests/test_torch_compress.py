"""The port's gradient compressors (``repro_torch.optim.compress``) against
``repro.optim.compress``: top-k with error feedback over 6 rounds bit for
bit JAX's values, indices and residual (magnitudes distinct every round,
checked, so the order is defined), int8 ``q`` and ``scale`` bit for bit on
JAX's own noise (the test draws ``jax.random.uniform(key) - 0.5`` and hands
the port that draw), the decompressors, and the counterparts of
tests/test_optim.py's unbiasedness checks on the port's own noise."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as J
from repro_torch.optim import (ErrorFeedback, int8_compress, int8_decompress,
                               topk_compress, topk_decompress)
from torch_parity import assert_exact, t


@pytest.mark.parametrize("shape,k_frac", [((4096,), 0.05), ((64, 48), 0.1),
                                          ((7, 5, 3), 0.3)])
def test_topk_with_error_feedback_matches_jax(shape, k_frac):
    rng = np.random.default_rng(3)
    jef, ef = J.ErrorFeedback(jnp.zeros(int(np.prod(shape)))), None
    for r in range(6):
        while True:                  # a draw whose |g + residual| are distinct
            g = rng.standard_normal(shape).astype(np.float32)
            flat = g.reshape(-1) + np.asarray(jef.residual)
            if len(np.unique(np.abs(flat))) == flat.size:
                break
        jv, ji, jef = J.topk_compress(jnp.asarray(g), k_frac, jef)
        v, i, ef = topk_compress(t(g), k_frac, ef if r else None)
        assert i.dtype == torch.int32
        assert_exact(v, jv)
        assert_exact(i, ji)
        assert_exact(ef.residual, jef.residual)
        assert_exact(topk_decompress(v, i, shape),
                     J.topk_decompress(jv, ji, shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matches_jax_on_its_noise(dtype):
    rng = np.random.default_rng(5)
    g = jnp.asarray(rng.standard_normal((96, 40)) * 3.0, dtype=dtype)
    g_port = t(g.astype(jnp.float32)).to(getattr(torch, dtype))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        noise = jax.random.uniform(key, g.shape) - 0.5
        jq, js = J.int8_compress(g, key)
        q, s = int8_compress(g_port, t(noise))
        assert q.dtype == torch.int8 and s.dtype == g_port.dtype
        assert_exact(q, jq)
        assert_exact(s.float(), js.astype(jnp.float32))
        assert_exact(int8_decompress(q, s), J.int8_decompress(jq, js))


def test_int8_refuses_noise_of_another_shape():
    with pytest.raises(ValueError, match="shape"):
        int8_compress(torch.ones(4, 3), torch.zeros(12))


def test_topk_error_feedback_unbiased_over_time():
    """tests/test_optim.py's check on the port: over 20 rounds the stream
    carries all of g."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    ef = ErrorFeedback(torch.zeros(1000))
    acc = torch.zeros(1000)
    for _ in range(20):
        vals, idx, ef = topk_compress(g, 0.1, ef)
        acc = acc + topk_decompress(vals, idx, (1000,))
    np.testing.assert_allclose((acc / 20).numpy(), g.numpy(), atol=0.5)
    # nothing is lost: what was sent plus what waits is 20 g
    np.testing.assert_allclose((acc + ef.residual).numpy(), (20 * g).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_int8_compress_unbiased():
    """tests/test_optim.py's check on the port, its noise from a
    ``torch.Generator``."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    outs = [int8_decompress(*int8_compress(g, gen)) for _ in range(32)]
    np.testing.assert_allclose(torch.stack(outs).mean(0).numpy(), g.numpy(),
                               atol=0.02)
