"""Model configurations of the port (its own copies) and the arch x shape
cell registry (``registry.py``)."""
