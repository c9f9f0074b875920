"""Engine implementation choice for the port.

Only ``choose_engine_impl`` is carried over.  The JAX package's rule sends
sweeps to its kernels only on a TPU and only while GTChain contiguity lies
between its maintenance floor (0.85) and its all-hard cut (0.9), from v5e
constants; copied here it would keep the CUDA kernels off the service's
path almost always.  So the port routes every sum sweep on a CUDA tensor
through the kernels and runs the plain oracle on the CPU.  A gate derived
from measured H100 numbers is later work; min/max combines stay on
``scatter_reduce`` in the engine either way.
"""
from __future__ import annotations


def choose_engine_impl(cbl, task="scan_all") -> str:
    """The ``impl=`` for the engine sweeps over ``cbl``: ``"cuda"`` when its
    tensors lie on a CUDA device, else ``"torch"``.  ``task`` (a task string
    or a VertexProgram) is accepted for signature parity and not read."""
    del task
    return "cuda" if cbl.v_deg.is_cuda else "torch"
