"""Hand-written CUDA kernels and their wrappers.

Each module holds one TPU kernel's port: a wrapper that launches the CUDA
kernel for CUDA tensors (or raises), the plain PyTorch version of the same
function (`*_plain`), which the wrapper takes for CPU tensors, and a
`LAUNCHES` dict counting kernel launches by wrapper name.
"""
