"""Module-level device-introspection functions
(reference: src/nyx/python/nyxus/functions.py:3-6 — gpu_is_available /
get_gpu_properties over the CUDA device; here the accelerator is whatever
JAX sees, normally a GPU).
"""

from __future__ import annotations


def _accel_devices():
    import jax
    try:
        return [d for d in jax.devices() if d.platform != "cpu"]
    except RuntimeError:
        return []


def gpu_is_available(nyxus_instance_id=None):
    """True when a non-CPU accelerator (a GPU) backs the engine."""
    return len(_accel_devices()) > 0


def get_gpu_properties(nyxus_instance_id=None):
    """Per-device property dicts for every visible accelerator."""
    out = []
    for d in _accel_devices():
        props = {
            "id": d.id,
            "platform": d.platform,
            "device_kind": d.device_kind,
            "process_index": d.process_index,
        }
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        if "bytes_limit" in stats:
            props["memory_total"] = stats["bytes_limit"]
        if "bytes_in_use" in stats:
            props["memory_in_use"] = stats["bytes_in_use"]
        out.append(props)
    return out
