"""Recsys models: SASRec serving and training."""
