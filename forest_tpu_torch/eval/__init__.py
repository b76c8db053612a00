"""Frozen-encoder loading for inference paths."""
