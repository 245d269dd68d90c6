"""SNAC: the multi-scale neural audio codec decoder of Orpheus (24 kHz)."""
