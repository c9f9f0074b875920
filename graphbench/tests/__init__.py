"""CPU tests of the benchmark harness (``test_graphbench_*.py``); tests
marked ``cuda`` need the card and skip without one."""
