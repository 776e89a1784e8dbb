"""Per-stage timing and leveled logging.

The reference's CHECKTIMING facility accumulates a Stopwatch per
hierarchical stage name with a display color ("Texture/GLCM/GLCM/#bbbbbb"),
supports exclusive/inclusive accounting, prints a summary, and saves
``<seg>_nyxustiming.csv`` per slide (reference: src/nyx/helpers/timing.h:9-39,
dump at workflow_2d_segmented.cpp:369-394; verbosity macros VERBOSLVL1..5,
environment.h:280-284).

This build's equivalents:
* ``Stopwatch`` -- process-wide accumulator; ``stopwatch("Name/#color")``
  context manager; nesting tracked so exclusive mode subtracts child time
* enablement via ``NYXUS_TIMING=1`` or ``Stopwatch.enable()`` (always-on
  cheap counters would perturb the device pipeline)
* ``vlog(level, ...)`` -- leveled stdout logging gated by the configured
  verbosity
"""

from __future__ import annotations

import os
import threading
import time


class Stopwatch:
    """Hierarchical wall-time accumulator (one per process)."""

    _lock = threading.Lock()
    _totals: dict = {}        # key -> inclusive seconds
    _child: dict = {}         # key -> child seconds (for exclusive mode)
    _counts: dict = {}
    _stack = threading.local()
    _enabled = bool(int(os.environ.get("NYXUS_TIMING", "0")))
    exclusive = False

    @classmethod
    def enable(cls, on: bool = True):
        cls._enabled = on

    @classmethod
    def enabled(cls) -> bool:
        return cls._enabled

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._totals.clear()
            cls._child.clear()
            cls._counts.clear()

    @classmethod
    def add(cls, key: str, seconds: float):
        with cls._lock:
            cls._totals[key] = cls._totals.get(key, 0.0) + seconds
            cls._counts[key] = cls._counts.get(key, 0) + 1

    @classmethod
    def _add_child(cls, key: str, seconds: float):
        with cls._lock:
            cls._child[key] = cls._child.get(key, 0.0) + seconds

    @classmethod
    def totals(cls, exclusive: bool = None):
        """{stage_key: seconds}; exclusive subtracts nested stage time
        (the reference's --exclusivetiming toggle)."""
        if exclusive is None:
            exclusive = cls.exclusive
        with cls._lock:
            if not exclusive:
                return dict(cls._totals)
            return {k: v - cls._child.get(k, 0.0)
                    for k, v in cls._totals.items()}

    @classmethod
    def summary(cls, exclusive: bool = None) -> str:
        tot = cls.totals(exclusive)
        if not tot:
            return "no timing data (enable with NYXUS_TIMING=1)"
        width = max(len(_name(k)) for k in tot)
        grand = sum(tot.values()) or 1.0
        lines = ["%-*s %12s %8s %7s" % (width, "stage", "seconds", "calls",
                                        "%")]
        for k in sorted(tot, key=tot.get, reverse=True):
            lines.append("%-*s %12.6f %8d %6.1f%%" %
                         (width, _name(k), tot[k], cls._counts.get(k, 0),
                          100.0 * tot[k] / grand))
        return "\n".join(lines)

    @classmethod
    def save_csv(cls, path: str, exclusive: bool = None):
        """Write ``<seg>_nyxustiming.csv``-style output: header
        h1,h2,h3,color,seconds,calls (the reference's Stopwatch::save_stats
        shape, timing.h:35-39)."""
        tot = cls.totals(exclusive)
        with open(path, "w") as f:
            f.write("h1,h2,h3,color,seconds,calls\n")
            for k in sorted(tot):
                parts = (k.split("/") + ["", "", "", ""])[:4]
                if not parts[3].startswith("#"):
                    parts[3] = ""
                f.write("%s,%s,%s,%s,%.9f,%d\n" %
                        (parts[0], parts[1], parts[2], parts[3], tot[k],
                         cls._counts.get(k, 0)))


def _name(key: str) -> str:
    return "/".join(p for p in key.split("/") if not p.startswith("#"))


class stopwatch:
    """``with stopwatch("Texture/GLCM/GLCM/#bbbbbb"):`` accumulator."""

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        if not Stopwatch._enabled:
            return self
        st = Stopwatch._stack
        if not hasattr(st, "keys"):
            st.keys = []
        st.keys.append(self.key)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not Stopwatch._enabled:
            return False
        dt = time.perf_counter() - self.t0
        st = Stopwatch._stack
        st.keys.pop()
        Stopwatch.add(self.key, dt)
        if st.keys:
            Stopwatch._add_child(st.keys[-1], dt)
        return False


_VERBOSITY = int(os.environ.get("NYXUS_VERBOSITY", "0"))


def set_verbosity(level: int):
    global _VERBOSITY
    _VERBOSITY = int(level)


def get_verbosity() -> int:
    return _VERBOSITY


def vlog(level: int, *args):
    """VERBOSLVL<level> equivalent: prints when verbosity >= level."""
    if _VERBOSITY >= level:
        print(*args, flush=True)
