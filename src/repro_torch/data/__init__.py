"""Synthetic graph data generated on the device."""
