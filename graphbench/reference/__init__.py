"""The benchmark's plain reference: the store and its analytics in
:mod:`graphbench.reference.graph`, and one module an analytics job,
``<job>.py`` with ``solve(src, dst, w, nv, params, store=None)`` and
``compare(got, want) -> {number: value}``, found by the job's name.  It
imports nothing of the program under test."""
