"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

One graph, made with numpy from a seed, goes through the JAX package and
through ``repro_torch`` on the CPU; layouts and integer results compare bit
for bit, real-valued sums within a relative tolerance (summation order).

Importing it pins torch to one thread in a pytest-xdist worker: with torch's
default of a thread per core in each of the workers, the workers' threads
outnumber the cores many times over and a test runs tens of times slower.
Every ``tests/test_torch_*.py`` imports this module first, so the pin holds
before the file's first torch op, whichever files a worker runs.
"""
import os

import numpy as np
import torch

from repro_torch import interop

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
    if torch.get_num_interop_threads() != 1:
        try:
            torch.set_num_interop_threads(1)
        except RuntimeError:        # inter-op work has started: left as is
            pass

# the tests/test_engine_pallas.py graph shape: RMAT 200v/1500e on 2048x8
NV, NE, NB, BW = 200, 1500, 2048, 8
RTOL, ATOL = 1e-5, 1e-7          # real-valued sums: summation order differs


def graph(seed: int = 0, nv: int = NV, ne: int = NE):
    from repro.data import rmat_edges
    src, dst = rmat_edges(nv, ne, seed=seed)
    w = np.random.default_rng(seed).random(len(src)).astype(np.float32)
    return src, dst, w


def t(x) -> torch.Tensor:
    """A CPU tensor holding a copy of ``x`` (numpy or JAX array)."""
    return torch.as_tensor(np.array(np.asarray(x)))


def assert_cbl_equal(jax_cbl, torch_cbl) -> None:
    """Every vertex-table and store array equal, bit for bit."""
    got = interop.cbl_to_numpy(torch_cbl)
    for k, v in got.items():
        if k == "store":
            for sk, sv in v.items():
                ref = np.asarray(getattr(jax_cbl.store, sk))
                assert ref.dtype == sv.dtype, sk
                np.testing.assert_array_equal(sv, ref, err_msg=f"store.{sk}")
        else:
            np.testing.assert_array_equal(
                v, np.asarray(getattr(jax_cbl, k)), err_msg=k)


def assert_close(got, ref) -> None:
    np.testing.assert_allclose(interop.to_numpy(got), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def assert_exact(got, ref) -> None:
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(ref))


def lm_config(jax_cfg):
    """The port's LMConfig with the values of a JAX ``LMConfig``, its SPMD
    fields included."""
    import dataclasses

    from repro_torch.models.transformer.layers import LMConfig
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    kw = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(LMConfig)}
    kw["dtype"] = dtypes[np.dtype(jax_cfg.dtype).name]
    return LMConfig(**kw)
