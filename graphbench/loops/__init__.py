"""One module a loop kind, ``<loop>.py`` with ``round(driver, j, batch)``,
found by the ``"loop"`` a mix file names (see
:class:`graphbench.harness.Driver`).  A new kind of traffic loop is a new
file here, not an edit."""
