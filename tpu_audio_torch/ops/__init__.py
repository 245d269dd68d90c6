"""Signal-processing ops, caches and the hand-written kernels (`kernels/`)."""
