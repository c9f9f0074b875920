"""Model configurations of the port (own copies; no registry yet)."""
