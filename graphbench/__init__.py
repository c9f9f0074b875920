"""The benchmark of ``repro_torch``: the GraphService's update stream and
snapshot refreshes on an NVIDIA H100 (``python3 graphbench/run.py``).

It imports the program under test (``repro_torch``) and nothing of the JAX
package beside it."""
