"""Device memory introspection (port of tpu_audio/utils/memory.py:
snapshot, log_stats, set_memory_fraction, clear_caches), over PyTorch's
CUDA caching allocator."""

from __future__ import annotations

import torch

from tpu_audio_torch.utils.logging import get_logger

_log = get_logger("perf")


def _cuda(device) -> torch.device | None:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device() if dev.index is None else dev.index)


def snapshot(device="cuda") -> dict:
    """{bytes_in_use, peak_bytes_in_use, bytes_limit, bytes_reserved,
    peak_bytes_reserved, num_allocs} of a CUDA device, under the JAX
    package's names where it has them: tensors' bytes (allocated), the
    allocator's (reserved), and the card's memory. {} for a CPU device or
    where there is no CUDA."""
    dev = _cuda(device)
    if dev is None:
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
            "num_allocs": s.get("allocation.all.allocated", 0)}


def log_stats(tag: str = "", device="cuda") -> None:
    s = snapshot(device)
    if not s:
        _log.info("memory stats unavailable on this device")
        return
    mb = 1024 * 1024
    _log.info("%s memory: in_use=%.0fMB peak=%.0fMB limit=%.0fMB", tag,
              s["bytes_in_use"] / mb, s["peak_bytes_in_use"] / mb, s["bytes_limit"] / mb)


def set_memory_fraction(fraction: float, device="cuda") -> None:
    """Cap this process's share of the card's memory
    (`torch.cuda.set_per_process_memory_fraction`); an allocation past it
    raises out-of-memory. Unlike the JAX setting it applies at any time."""
    dev = _cuda(device)
    if dev is not None:
        torch.cuda.set_per_process_memory_fraction(fraction, dev)


def clear_caches() -> None:
    """Return the allocator's unused cached blocks to the card
    (`torch.cuda.empty_cache`)."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
