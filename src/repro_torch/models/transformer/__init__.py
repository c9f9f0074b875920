"""Decoder-only LM: layers, paged KV cache, prefill and decode."""
