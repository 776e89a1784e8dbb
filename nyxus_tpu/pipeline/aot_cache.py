"""Opt-in ahead-of-time program cache: skip megakernel re-tracing.

jax's persistent compilation cache only serves the BACKEND compile; the
Python trace + StableHLO lowering of the `*ALL*` megakernel repeats in
every fresh process (its cost on the GPU host is not measured yet; ROADMAP
S7, D3).  With ``NYXUS_TPU_AOT_CACHE=<dir>`` the
serialized ``jax.export`` artifact of each (feature set, config, input
signature) is kept on disk:

* first time a signature runs, the normal jit path executes (tracing once,
  backend compile lands in the persistent cache) and a background thread
  exports + serializes the program to the cache dir;
* a FRESH process deserializes the artifact in milliseconds and dispatches
  its first slides through ``Exported.call`` (no tracing), while one
  background thread warms the regular jit path, which then takes over
  (``Exported.call`` dispatches more slowly than the jit path, so it only
  serves until the warm-up lands).

The cache key covers the family set, engine config, static metadata, input
shapes/dtypes, jax version, backend and the x64 flag, so a stale artifact
can never serve a different program.  Everything degrades to the plain jit
path on any error.  The reference has no analog: its C++ calculators cost
no per-process compilation (nyxus keeps per-feature ``calculate`` methods,
featureset.h); this recovers that cold-start property for the fused
program.
"""

import hashlib
import os
import threading

import jax

__all__ = ["AotSite", "enabled"]


def _cache_dir():
    return os.environ.get("NYXUS_TPU_AOT_CACHE", "")


def enabled() -> bool:
    return bool(_cache_dir())


class AotSite:
    """One dispatch site (a module-level jitted function) with an AOT
    artifact per static+shape signature."""

    def __init__(self, name: str):
        self.name = name
        self._jit_ready = set()    # keys whose in-process jit is compiled
        self._exps = {}            # key -> deserialized Exported
        self._warming = set()
        self._lock = threading.Lock()

    def _key(self, statics, arrays) -> str:
        avals = tuple((tuple(a.shape), str(a.dtype)) for a in arrays)
        s = repr((self.name, statics, avals, jax.version.__version__,
                  jax.default_backend(),
                  bool(jax.config.jax_enable_x64)))
        return hashlib.sha256(s.encode()).hexdigest()[:32]

    def call(self, statics, arrays, jit_call, flat_fn):
        """Dispatch through the fastest available path.

        ``statics``  hashable reprs of everything baked into the trace
        ``arrays``   the positional array arguments, flattened
        ``jit_call`` zero-arg closure running the regular jitted path
        ``flat_fn``  pure fn(*arrays) with statics baked, for export
        """
        d = _cache_dir()
        if not d:
            return jit_call()
        try:
            k = self._key(statics, arrays)
        except Exception:
            return jit_call()
        with self._lock:
            if k in self._jit_ready:
                return jit_call()
            exp = self._exps.get(k)
        path = os.path.join(d, "%s-%s.jaxexp" % (self.name, k))
        if exp is None and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    exp = jax.export.deserialize(bytearray(f.read()))
                with self._lock:
                    self._exps[k] = exp
            except Exception:
                exp = None
        if exp is None:
            out = jit_call()              # traces here, once per process
            with self._lock:
                self._jit_ready.add(k)
            self._spawn_export(path, flat_fn, arrays)
            return out
        with self._lock:
            start_warm = k not in self._warming
            if start_warm:
                self._warming.add(k)
        if start_warm:
            threading.Thread(target=self._warm_jit, args=(k, jit_call),
                             daemon=True).start()
        try:
            return exp.call(*arrays)
        except Exception:
            # artifact unusable (backend/version drift the key missed)
            with self._lock:
                self._exps.pop(k, None)
                self._jit_ready.add(k)
            return jit_call()

    def _warm_jit(self, k, jit_call):
        """Trace+compile the regular jit path off the critical path; its
        backend compile is served by the persistent cache."""
        try:
            jax.block_until_ready(jit_call())
        except Exception:
            return
        with self._lock:
            self._jit_ready.add(k)

    def _spawn_export(self, path, flat_fn, arrays):
        """Serialize the program for future processes.  Non-daemon: a
        warmup run (tools/warmup_cache.py) must not exit before the
        artifact lands; the export re-traces, so this costs one extra
        background trace in the process that first sees the signature."""
        sds = tuple(jax.ShapeDtypeStruct(a.shape, a.dtype) for a in arrays)

        def work():
            try:
                exp = jax.export.export(jax.jit(flat_fn))(*sds)
                blob = exp.serialize()
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                tmp = "%s.tmp.%d" % (path, os.getpid())
                with open(tmp, "wb") as f:
                    f.write(bytes(blob))
                os.replace(tmp, path)
            except Exception:
                try:
                    os.unlink(tmp)
                except Exception:
                    pass

        threading.Thread(target=work, daemon=False).start()
