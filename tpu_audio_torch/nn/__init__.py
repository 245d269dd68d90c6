"""Functional layers and attention over tensors."""
