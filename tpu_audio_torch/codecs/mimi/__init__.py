"""Mimi: the Kyutai neural codec of Marvis (24 kHz at 12.5 Hz, split RVQ)."""
