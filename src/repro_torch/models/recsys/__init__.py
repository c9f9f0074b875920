"""Recsys models: SASRec serving."""
