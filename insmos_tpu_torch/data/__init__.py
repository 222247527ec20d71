"""Synthetic input data (numpy)."""
