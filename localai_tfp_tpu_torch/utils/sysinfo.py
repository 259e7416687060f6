"""Device and process memory introspection (counterpart of the parts of
localai_tfp_tpu/utils/sysinfo.py the server reads: ``/system``'s
``device_memory`` and the memory gauges).

On a card each row names it and reads ``torch.cuda.mem_get_info`` (the
device-wide view: every process's allocations, the caching allocator's
reserve included) beside the caching allocator's own counters. Without
a card there is one CPU row with zero limits, as the JAX function gives
on a host with no accelerator.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def device_memory() -> list[dict[str, Any]]:
    """Per-device memory: ``bytes_limit`` (the card's total),
    ``bytes_in_use`` (total less free), and the caching allocator's
    ``allocated_bytes`` and ``reserved_bytes`` of this process."""
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "bytes_limit": 0, "bytes_in_use": 0}]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({"id": i, "platform": "gpu",
                    "kind": torch.cuda.get_device_properties(i).name,
                    "bytes_limit": int(total),
                    "bytes_in_use": int(total - free),
                    "allocated_bytes": int(torch.cuda.memory_allocated(i)),
                    "reserved_bytes": int(torch.cuda.memory_reserved(i))})
    return out


def process_rss_bytes() -> int:
    """Resident set size of this process from /proc (0 where /proc is
    unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


def update_memory_gauges() -> None:
    """Sync ``device_hbm_used_bytes`` (each card's caching-allocator
    reserve, as the engines' scrape sets it) and ``process_rss_bytes``.
    The server calls it periodically unless metrics are disabled."""
    from ..telemetry import metrics as tm

    for row in device_memory():
        if "reserved_bytes" in row:
            tm.DEVICE_HBM_USED.labels(device=str(row["id"])).set(
                row["reserved_bytes"])
    rss = process_rss_bytes()
    if rss:
        tm.PROCESS_RSS.set(rss)
