"""Native (C++) runtime components, bound via ctypes.

The reference keeps its I/O and output stages native (libtiff loaders,
src/nyx/grayscale_tiff.h; CSV writer, src/nyx/output_2_csv.cpp). This package
provides their equivalents in two shared libraries:

* ``libnyxnative.so`` -- CSV writer, zarr/blosc codecs, contours, host
  geometry and label discovery (needs only zlib)
* ``libnyxtiff.so`` -- ``TiffReader``/``write_tiff``: tiled/strip grayscale
  TIFF region server + streaming prescan (any of u8/u16/u32/i8..i64/f32/f64,
  LZW/deflate/none compression via libtiff)

Both are compiled on first use with g++ into ``_build/`` for the CPU of the
host that loads them.  ``available()`` reports the first library and
``tiff_available()`` the second, so hosts without libtiff keep every other
native stage and read TIFF through Pillow.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_lib = None
_build_err = None
_tiff_lib = None
_tiff_err = None

# library file -> (sources, link flags)
_LIBS = {
    "libnyxnative.so": (("csv_writer.cpp", "zarr_codec.cpp", "contour.cpp",
                         "geomfeats.cpp", "geomfeats_batch.cpp",
                         "discover.cpp"), ("-l:libz.so.1",)),
    "libnyxtiff.so": (("tiff_reader.cpp",), ("-ltiff",)),
}

# -march=native: the library is built on the host that loads it, and the
# stamp below rebuilds it when it was copied from another CPU.  Loading an
# up-to-date build needs no compiler.
# -ffp-contract=off: FMA contraction would change double rounding and break
# bit-parity with the reference/oracle float semantics.
_CFLAGS = ("-O3", "-march=native", "-ffp-contract=off")


def _cpu_identity() -> str:
    """What ``-march=native`` resolves from, read without a compiler: the
    vendor, family, model and feature flags of the first CPU in
    /proc/cpuinfo, else the platform's machine and processor names."""
    keys = ("vendor_id", "cpu family", "model", "model name", "flags",
            "Features", "CPU implementer", "CPU part")
    try:
        with open("/proc/cpuinfo") as f:
            first = f.read().split("\n\n")[0]
    except OSError:
        first = ""
    lines = [ln for ln in first.splitlines()
             if ln.split(":")[0].strip() in keys]
    if not lines:
        import platform
        lines = [platform.machine(), platform.processor()]
    return "\n".join(lines)


def _stamp() -> str:
    """Compile flags plus a hash of the host CPU's identity."""
    host = hashlib.sha256(_cpu_identity().encode()).hexdigest()
    return " ".join(_CFLAGS) + " host=" + host


def _needs_build(lib_path: str, sources, stamp: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    # flag + host stamp: changing compile flags, or loading on another CPU,
    # must invalidate the cached .so (source mtimes alone once left a stale
    # build in place)
    try:
        with open(lib_path + ".flags") as f:
            if f.read() != stamp:
                return True
    except OSError:
        return True
    lib_mtime = os.path.getmtime(lib_path)
    return any(os.path.getmtime(os.path.join(_SRC, s)) > lib_mtime
               for s in sources)


def build(name: str, out_dir: str = _BUILD) -> str:
    """Compile library ``name`` of ``_LIBS`` into ``out_dir`` unless an
    up-to-date build for this host is there; returns its path."""
    sources, link = _LIBS[name]
    lib_path = os.path.join(out_dir, name)
    stamp = _stamp()
    if not _needs_build(lib_path, sources, stamp):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename into place: concurrent processes
    # (parallel test workers) never load a half-written library
    tmp = "%s.%d.tmp" % (lib_path, os.getpid())
    cmd = ["g++", *_CFLAGS, "-shared", "-fPIC", "-std=c++17", "-o", tmp,
           *[os.path.join(_SRC, s) for s in sources], *link]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("native build of %s failed:\n%s"
                           % (name, proc.stderr))
    os.replace(tmp, lib_path)
    with open(tmp, "w") as f:
        f.write(stamp)
    os.replace(tmp, lib_path + ".flags")
    return lib_path


def _load():
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build("libnyxnative.so"))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_err = e
            return None
        lib.nyxcsv_write.restype = ctypes.c_int
        lib.nyxcsv_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        for name in ("nyx_lz4_decompress", "nyx_lz4_compress",
                     "nyx_blosc_decompress"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_int]
        lib.nyx_blosc_compress_lz4.restype = ctypes.c_int
        lib.nyx_blosc_compress_lz4.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        for nm in ("nyx_caliper_feret", "nyx_caliper_martin",
                   "nyx_caliper_nassenstein"):
            fn = getattr(lib, nm)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
        lib.nyx_chords.restype = None
        lib.nyx_chords.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_long,
                                   ctypes.c_void_p, ctypes.c_int]
        lib.nyx_min_enclosing_circles.restype = None
        lib.nyx_min_enclosing_circles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
        lib.nyx_contour_sqdist_approx.restype = None
        lib.nyx_contour_sqdist_approx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.nyx_contours_batch.restype = None
        lib.nyx_contours_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        lib.nyx_contour.restype = ctypes.c_int
        lib.nyx_contour.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.nyx_convex_hull.restype = ctypes.c_int
        lib.nyx_convex_hull.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.nyx_geom_width.restype = ctypes.c_int
        lib.nyx_geom_width.argtypes = []
        lib.nyx_geom_batch.restype = None
        lib.nyx_geom_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_long,
            ctypes.c_uint32, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        lib.nyx_neighbors_batch.restype = None
        lib.nyx_neighbors_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_double, ctypes.c_long, ctypes.c_void_p, ctypes.c_int]
        lib.nyx_discover.restype = ctypes.c_int
        lib.nyx_discover.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_long,
                                     ctypes.c_long]
        lib.nyx_discover_fetch.restype = ctypes.c_int
        lib.nyx_discover_fetch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _load_tiff():
    global _tiff_lib, _tiff_err
    with _lock:
        if _tiff_lib is not None or _tiff_err is not None:
            return _tiff_lib
        try:
            lib = ctypes.CDLL(build("libnyxtiff.so"))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _tiff_err = e
            return None
        lib.nyxtiff_open.restype = ctypes.c_void_p
        lib.nyxtiff_open.argtypes = [ctypes.c_char_p]
        lib.nyxtiff_info.restype = ctypes.c_int
        lib.nyxtiff_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for name in ("f32", "f64", "u32"):
            fn = getattr(lib, "nyxtiff_read_region_" + name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
                           ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p]
        lib.nyxtiff_prescan.restype = ctypes.c_int
        lib.nyxtiff_prescan.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.nyxtiff_close.restype = None
        lib.nyxtiff_close.argtypes = [ctypes.c_void_p]
        lib.nyxtiff_write.restype = ctypes.c_int
        lib.nyxtiff_write.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32, ctypes.c_int]
        _tiff_lib = lib
        return _tiff_lib


def tiff_available() -> bool:
    return _load_tiff() is not None


_DTYPES = {"f32": np.float32, "f64": np.float64, "u32": np.uint32}


class TiffReader:
    """Region server over one grayscale TIFF (tiled or stripped)."""

    def __init__(self, path: str):
        lib = _load_tiff()
        if lib is None:
            raise RuntimeError("native TIFF library unavailable: %r"
                               % _tiff_err)
        self._lib = lib
        self._h = lib.nyxtiff_open(path.encode())
        if not self._h:
            raise IOError("cannot open TIFF: %s" % path)
        dims = np.zeros(8, np.uint32)
        lib.nyxtiff_info(self._h, dims.ctypes.data_as(ctypes.c_void_p))
        (self.width, self.height, self.tile_width, self.tile_height,
         tiled, self.bits, sample_format, self.samples_per_pixel) = (
            int(x) for x in dims)
        self.tiled = bool(tiled)
        self.is_float = sample_format == 3      # SAMPLEFORMAT_IEEEFP
        self.is_signed = sample_format == 2     # SAMPLEFORMAT_INT

    def read_region(self, y0: int, x0: int, h: int, w: int, dtype="f32"):
        """Dense [h, w] region at (y0, x0); out-of-image margins are 0."""
        out = np.empty((h, w), _DTYPES[dtype])
        fn = getattr(self._lib, "nyxtiff_read_region_" + dtype)
        rc = fn(self._h, y0, x0, h, w, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError("TIFF region read failed (rc=%d)" % rc)
        return out

    def read_all(self, dtype="f32"):
        return self.read_region(0, 0, self.height, self.width, dtype)

    def prescan(self):
        """(min, max, nonzero_count) over the whole slide, streamed
        tile-by-tile (the reference's SlideProps prescan)."""
        mn = ctypes.c_double()
        mx = ctypes.c_double()
        nz = ctypes.c_int64()
        rc = self._lib.nyxtiff_prescan(
            self._h, ctypes.byref(mn), ctypes.byref(mx), ctypes.byref(nz))
        if rc != 0:
            raise IOError("TIFF prescan failed (rc=%d)" % rc)
        return mn.value, mx.value, nz.value

    def close(self):
        if self._h:
            self._lib.nyxtiff_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_WRITE_DTYPES = {np.dtype(np.uint8): 1, np.dtype(np.uint16): 2,
                 np.dtype(np.uint32): 4, np.dtype(np.float32): 16}


def write_tiff(path, arr, tile_size=0, compression="lzw"):
    """Write a grayscale TIFF (stripped, or tiled when tile_size > 0)."""
    lib = _load_tiff()
    if lib is None:
        raise RuntimeError("native TIFF library unavailable: %r" % _tiff_err)
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _WRITE_DTYPES:
        arr = np.ascontiguousarray(arr, np.float32)
    comp = {"none": 0, "lzw": 1, "deflate": 2}[compression]
    rc = lib.nyxtiff_write(path.encode(),
                           arr.ctypes.data_as(ctypes.c_void_p),
                           arr.shape[0], arr.shape[1],
                           _WRITE_DTYPES[arr.dtype], tile_size, comp)
    if rc != 0:
        raise IOError("TIFF write failed (rc=%d)" % rc)


def write_csv(path, header, row_prefixes, values, noval_text="nan",
              append=False, precision=6, sub_negzero=False):
    """Write a feature table to CSV natively.

    header: str or None; row_prefixes: list[str] pre-rendered string-column
    prefixes (no trailing comma); values: [nrows, ncols] float64.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    values = np.ascontiguousarray(values, np.float64)
    n = values.shape[0]
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in row_prefixes])
    rc = lib.nyxcsv_write(
        path.encode(), header.encode() if header else None, arr,
        values.ctypes.data_as(ctypes.c_void_p), n, values.shape[1],
        noval_text.encode(), 1 if append else 0, precision,
        1 if sub_negzero else 0, _n_threads())
    if rc != 0:
        raise IOError("CSV write failed (rc=%d)" % rc)


def blosc_decompress(buf: bytes, nbytes_out: int) -> bytes:
    """Decode one c-blosc1 container (lz4/zlib/memcpy codecs, byte shuffle)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    out = ctypes.create_string_buffer(nbytes_out)
    rc = lib.nyx_blosc_decompress(buf, len(buf), out, nbytes_out)
    if rc == -2:
        raise ValueError("blosc bitshuffle filter is not supported")
    if rc == -3:
        raise ValueError("unsupported blosc inner codec (only lz4/zlib)")
    if rc < 0:
        raise ValueError("corrupt blosc stream")
    return out.raw[:rc]


def blosc_compress_lz4(buf: bytes, typesize: int = 1,
                       shuffle: bool = True) -> bytes:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    cap = 16 + 8 + len(buf) + len(buf) // 128 + 64
    out = ctypes.create_string_buffer(cap)
    rc = lib.nyx_blosc_compress_lz4(buf, len(buf), typesize,
                                    1 if shuffle else 0, out, cap)
    if rc < 0:
        raise ValueError("blosc compress failed")
    return out.raw[:rc]


def lz4_roundtrip_check(buf: bytes) -> bool:
    """Mechanics self-test helper: compress+decompress equals input."""
    lib = _load()
    cap = len(buf) + len(buf) // 128 + 64
    comp = ctypes.create_string_buffer(cap)
    n = lib.nyx_lz4_compress(buf, len(buf), comp, cap)
    if n < 0:
        return False
    out = ctypes.create_string_buffer(len(buf))
    m = lib.nyx_lz4_decompress(comp, n, out, len(buf))
    return m == len(buf) and out.raw == buf


def contour(mask, inten):
    """Merged multicontour of one ROI crop as [K, 3] (x, y, inten) int64 in
    +1-shifted local coordinates (native port of pipeline/contour.py)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    mask = np.ascontiguousarray(mask, np.uint8)
    inten = np.ascontiguousarray(inten, np.int64)
    h, w = mask.shape
    cap = int(mask.sum()) + 16
    out = np.empty((cap, 3), np.int64)
    k = lib.nyx_contour(mask.ctypes.data_as(ctypes.c_void_p),
                        inten.ctypes.data_as(ctypes.c_void_p), h, w,
                        out.ctypes.data_as(ctypes.c_void_p), cap)
    if k < 0:
        raise RuntimeError("contour buffer overflow")
    return out[:k].copy()


def contour_sqdist_approx(px, py, cx, cy, want_min=True, want_max=False):
    """Approximate min/max squared distance from points to an ORDERED contour
    (semantic port of the reference's sampling search, pixel.cpp:36-143).
    Returns (min_d2 | None, max_d2 | None) float64 arrays."""
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    cx = np.ascontiguousarray(cx, np.float64)
    cy = np.ascontiguousarray(cy, np.float64)
    n = len(px)
    out_min = np.empty(n, np.float64) if want_min else None
    out_max = np.empty(n, np.float64) if want_max else None
    lib = _load()
    if lib is not None:
        def run(lo, hi):
            lib.nyx_contour_sqdist_approx(
                px[lo:hi].ctypes.data_as(ctypes.c_void_p),
                py[lo:hi].ctypes.data_as(ctypes.c_void_p), hi - lo,
                cx.ctypes.data_as(ctypes.c_void_p),
                cy.ctypes.data_as(ctypes.c_void_p), len(cx),
                out_min[lo:hi].ctypes.data_as(ctypes.c_void_p)
                if want_min else None,
                out_max[lo:hi].ctypes.data_as(ctypes.c_void_p)
                if want_max else None)

        # the per-point search is independent and GIL-free: fan big point
        # sets over threads (the giant streamed-ROI weighted-moment pass
        # calls this with ~1e6 points)
        nthr = min(os.cpu_count() or 1, max(1, n // 65536))
        if nthr > 1:
            from concurrent.futures import ThreadPoolExecutor
            step = (n + nthr - 1) // nthr
            with ThreadPoolExecutor(nthr) as ex:
                list(ex.map(lambda lo: run(lo, min(n, lo + step)),
                            range(0, n, step)))
        else:
            run(0, n)
        return out_min, out_max
    # pure-Python fallback (parity oracle; slow)
    import math

    def one(x, y, want_max_):
        nc = len(cx)
        if nc == 0:
            return 0.0
        d0 = (x - cx[0]) ** 2 + (y - cy[0]) ** 2
        if nc == 1:
            return d0
        a, b = 0, nc
        ext_d, ext_i = d0, 0
        step = max(1, int((b - a) / math.log(b - a)))
        while True:
            i = a + step
            while i < b:
                d = (x - cx[i]) ** 2 + (y - cy[i]) ** 2
                if (ext_d < d) if want_max_ else (ext_d > d):
                    ext_d, ext_i = d, i
                i += step
            stepL = step if ext_i >= step else ext_i
            stepR = step if ext_i + step < nc else nc - ext_i
            a, b = ext_i - stepL, ext_i + stepR
            step = 1 if b - a <= 10 else max(1, int((b - a) / math.log(b - a)))
            if b - a <= 2:
                return ext_d

    for i in range(n):
        if want_min:
            out_min[i] = one(px[i], py[i], False)
        if want_max:
            out_max[i] = one(px[i], py[i], True)
    return out_min, out_max


def convex_hull(xs, ys):
    """Monotone-chain hull, reference vertex order; [K, 2] float64 (x, y)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    xs = np.ascontiguousarray(xs, np.int64)
    ys = np.ascontiguousarray(ys, np.int64)
    out = np.empty((len(xs) + 4, 2), np.float64)
    k = lib.nyx_convex_hull(xs.ctypes.data_as(ctypes.c_void_p),
                            ys.ctypes.data_as(ctypes.c_void_p), len(xs),
                            out.ctypes.data_as(ctypes.c_void_p))
    return out[:k].copy()


def _concat_offsets(arrays, dtype):
    """Concatenate per-ROI 1-D arrays -> (flat, offsets[int64, N+1])."""
    offsets = np.zeros(len(arrays) + 1, np.int64)
    for i, a in enumerate(arrays):
        offsets[i + 1] = offsets[i] + len(a)
    if offsets[-1] == 0:
        return np.zeros(0, dtype), offsets
    flat = np.concatenate([np.ascontiguousarray(a, dtype) for a in arrays])
    return flat, offsets


def _n_threads():
    env = os.environ.get("NYXUS_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


def caliper_batch(kind, hulls, fill):
    """Run a caliper family natively over all ROIs.

    kind: 'feret' (8 outputs) | 'martin' | 'nassenstein' (6 outputs);
    hulls: list of [K, 2] float arrays (global coords) or None.
    Returns [N, W] float64 initialized to ``fill``."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    width = 8 if kind == "feret" else 6
    n = len(hulls)
    out = np.full((n, width), fill, np.float64)
    hx, off = _concat_offsets(
        [h[:, 0] if h is not None else np.zeros(0) for h in hulls], np.float64)
    hy, _ = _concat_offsets(
        [h[:, 1] if h is not None else np.zeros(0) for h in hulls], np.float64)
    fn = getattr(lib, "nyx_caliper_" + kind)
    fn(hx.ctypes.data_as(ctypes.c_void_p), hy.ctypes.data_as(ctypes.c_void_p),
       off.ctypes.data_as(ctypes.c_void_p), n,
       out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def chords_batch(points, aabbs):
    """Chord statistics natively over all ROIs.

    points: list of (gx int64, gy int64, inten float64) in cloud order;
    aabbs: [N, 4] int64 (x0, x1, y0, y1).  Returns [N, 16] float64
    (-0.0 rows where no chords)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    n = len(points)
    out = np.full((n, 16), -0.0, np.float64)
    gx, off = _concat_offsets([p[0] for p in points], np.int64)
    gy, _ = _concat_offsets([p[1] for p in points], np.int64)
    it, _ = _concat_offsets([p[2] for p in points], np.float64)
    ab = np.ascontiguousarray(aabbs, np.int64)
    lib.nyx_chords(gx.ctypes.data_as(ctypes.c_void_p),
                   gy.ctypes.data_as(ctypes.c_void_p),
                   it.ctypes.data_as(ctypes.c_void_p),
                   off.ctypes.data_as(ctypes.c_void_p),
                   ab.ctypes.data_as(ctypes.c_void_p), n,
                   out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def min_enclosing_circles(contours):
    """Min enclosing circle DIAMETER per ROI (float32 reference algorithm,
    circle.cpp:28-216).  contours: list of [K, 2] float arrays or None."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    n = len(contours)
    out = np.zeros(n, np.float64)
    px, off = _concat_offsets(
        [c[:, 0] if c is not None else np.zeros(0) for c in contours],
        np.float64)
    py, _ = _concat_offsets(
        [c[:, 1] if c is not None else np.zeros(0) for c in contours],
        np.float64)
    lib.nyx_min_enclosing_circles(
        px.ctypes.data_as(ctypes.c_void_p), py.ctypes.data_as(ctypes.c_void_p),
        off.ctypes.data_as(ctypes.c_void_p), n,
        out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


_DISCOVER_DTYPES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                    np.dtype(np.uint32): 2, np.dtype(np.int32): 3,
                    np.dtype(np.float32): 4, np.dtype(np.float64): 5,
                    np.dtype(np.int64): 6}


def _labels_i32(labels_img, validated=False):
    """Contiguous int32 view of a label image; raises instead of silently
    wrapping labels >= 2**31 negative (uint32/uint64 label schemes --
    callers fall back to the numpy paths, pipeline.labels).  Callers that
    already ran pipeline.labels._native_labels_ok pass ``validated`` to
    skip the (full-image max) re-check."""
    labels_img = np.asarray(labels_img)
    if not validated and (labels_img.dtype == np.uint32
                          or (labels_img.dtype.kind in "iu"
                              and labels_img.dtype.itemsize > 4)) \
            and labels_img.size and int(labels_img.max()) >= 2 ** 31:
        raise ValueError("labels exceed int32 range; the native scan "
                         "cannot represent them (use the numpy fallback)")
    return np.ascontiguousarray(labels_img, np.int32)
_discover_lock = threading.Lock()


def discover(labels_img, intens, want_clouds=False,
             labels_validated=False):
    """One-pass label discovery (+ optional raster-order cloud assembly).

    labels_img: [H, W] int-like; intens: [H, W] numeric (same shape).
    Returns (recs int64 [n, 8] (label, area, y0, y1, x0, x1, 0, 0),
             fmm float64 [n, 2] (vmin, vmax), slide_min, slide_max,
             clouds | None) with clouds = (gx, gy, inten, offsets)
    concatenated per ascending label in raster order."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    labels_img = _labels_i32(labels_img, validated=labels_validated)
    intens = np.ascontiguousarray(intens)
    if intens.dtype not in _DISCOVER_DTYPES:
        intens = np.ascontiguousarray(intens, np.float64)
    dt = _DISCOVER_DTYPES[intens.dtype]
    H, W = labels_img.shape
    lp = labels_img.ctypes.data_as(ctypes.c_void_p)
    ip = intens.ctypes.data_as(ctypes.c_void_p)
    with _discover_lock:   # thread_local native state pair of calls
        n = lib.nyx_discover(lp, ip, dt, H, W)
        if n < 0:
            raise RuntimeError("nyx_discover failed")
        recs = np.zeros((n, 8), np.int64)
        fmm = np.zeros((n, 2), np.float64)
        extrema = np.zeros(2, np.float64)
        if want_clouds:
            total = int(np.count_nonzero(labels_img)) if n else 0
            off = np.zeros(n + 1, np.int64)
            gx = np.empty(total, np.int64)
            gy = np.empty(total, np.int64)
            gi = np.empty(total, np.float64)
            lib.nyx_discover_fetch(
                lp, ip, dt, recs.ctypes.data_as(ctypes.c_void_p),
                fmm.ctypes.data_as(ctypes.c_void_p),
                extrema.ctypes.data_as(ctypes.c_void_p),
                off.ctypes.data_as(ctypes.c_void_p),
                gx.ctypes.data_as(ctypes.c_void_p),
                gy.ctypes.data_as(ctypes.c_void_p),
                gi.ctypes.data_as(ctypes.c_void_p))
            clouds = (gx, gy, gi, off)
        else:
            lib.nyx_discover_fetch(
                lp, ip, dt, recs.ctypes.data_as(ctypes.c_void_p),
                fmm.ctypes.data_as(ctypes.c_void_p),
                extrema.ctypes.data_as(ctypes.c_void_p),
                None, None, None, None)
            clouds = None
    return recs, fmm, float(extrema[0]), float(extrema[1]), clouds


def geom_batch(clouds, contours, recs_mat, flags, hull_points, groups,
               logw_eps=0.0, out=None, want_logw=False, n_threads=None):
    """One-call batched host-geometry pass (contour stats, fractal perimeter,
    convex hull features, 3 calipers, chords, ROI radius, radial
    distribution, weighted-moment log distances) over all ROIs.

    clouds: (gx int64, gy int64, inten float64, offsets int64[n+1]) global
    raster-order pixel clouds; contours: (flat [K,3] int64, offsets[n+1])
    merged contours in +1-shifted local coords; recs_mat: [n, 9] int64
    (x0, x1, y0, y1, rep_x0, rep_x1, rep_y0, rep_y1, area); flags: uint8[n]
    bit0 has_cloud, bit1 hull_from_points; hull_points: (flat [M,2] int64
    global (x, y), offsets[n+1]) hull candidates of the bit1 rows;
    groups: bitmask (GEOM_GROUPS in
    pipeline.hostfeats); out: pre-filled [n, nyx_geom_width] sentinel matrix.
    Returns (out, logw_flat | None)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    gx, gy, it, coff = clouds
    ctr, koff = contours
    hpts, hoff = hull_points
    n = len(recs_mat)
    if out is None:
        out = np.zeros((n, lib.nyx_geom_width()), np.float64)
    logw = np.zeros(int(coff[-1]), np.float64) if want_logw else None
    gx = np.ascontiguousarray(gx, np.int64)
    gy = np.ascontiguousarray(gy, np.int64)
    it = np.ascontiguousarray(it, np.float64)
    coff = np.ascontiguousarray(coff, np.int64)
    ctr = np.ascontiguousarray(ctr, np.int64)
    koff = np.ascontiguousarray(koff, np.int64)
    hpts = np.ascontiguousarray(hpts, np.int64)
    hoff = np.ascontiguousarray(hoff, np.int64)
    recs_mat = np.ascontiguousarray(recs_mat, np.int64)
    flags = np.ascontiguousarray(flags, np.uint8)
    lib.nyx_geom_batch(
        gx.ctypes.data_as(ctypes.c_void_p), gy.ctypes.data_as(ctypes.c_void_p),
        it.ctypes.data_as(ctypes.c_void_p),
        coff.ctypes.data_as(ctypes.c_void_p),
        ctr.ctypes.data_as(ctypes.c_void_p),
        koff.ctypes.data_as(ctypes.c_void_p),
        recs_mat.ctypes.data_as(ctypes.c_void_p),
        flags.ctypes.data_as(ctypes.c_void_p),
        hpts.ctypes.data_as(ctypes.c_void_p),
        hoff.ctypes.data_as(ctypes.c_void_p), n, groups, logw_eps,
        out.ctypes.data_as(ctypes.c_void_p),
        logw.ctypes.data_as(ctypes.c_void_p) if want_logw else None,
        n_threads or _n_threads())
    return out, logw


def neighbors_batch(contours_global, aabbs, cenx, ceny, radius):
    """Cross-ROI neighbor features natively.  contours_global: list of
    [K, >=2] float arrays (global coords) or None; aabbs [n,4] int64
    (x0, x1, y0, y1); cenx/ceny float64 [n].  Returns [n, 9] float64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    n = len(contours_global)
    kx, koff = _concat_offsets(
        [c[:, 0] if c is not None else np.zeros(0) for c in contours_global],
        np.float64)
    ky, _ = _concat_offsets(
        [c[:, 1] if c is not None else np.zeros(0) for c in contours_global],
        np.float64)
    ab = np.ascontiguousarray(aabbs, np.int64)
    cenx = np.ascontiguousarray(cenx, np.float64)
    ceny = np.ascontiguousarray(ceny, np.float64)
    out = np.zeros((n, 9), np.float64)
    lib.nyx_neighbors_batch(
        kx.ctypes.data_as(ctypes.c_void_p), ky.ctypes.data_as(ctypes.c_void_p),
        koff.ctypes.data_as(ctypes.c_void_p),
        ab.ctypes.data_as(ctypes.c_void_p),
        cenx.ctypes.data_as(ctypes.c_void_p),
        ceny.ctypes.data_as(ctypes.c_void_p), float(radius), n,
        out.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return out


def contours_batch(labels_img, intens_img, recs):
    """Merged multicontours of every ROI of a resident slide in one call.

    labels_img: [H, W] int-like; intens_img: [H, W] numeric; recs: iterable
    of RoiRecord-likes (label, y0, x0, height, width).  Returns a list of
    [K, 3] int64 (x, y, inten) arrays in +1-shifted local coordinates."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable: %r" % _build_err)
    labels_img = _labels_i32(labels_img)
    intens_img = np.ascontiguousarray(intens_img, np.int64)
    H, W = labels_img.shape
    n = len(recs)
    rmat = np.zeros((n, 5), np.int64)
    caps = np.zeros(n + 1, np.int64)
    for i, r in enumerate(recs):
        rmat[i] = (r.label, r.y0, r.x0, r.height, r.width)
        caps[i + 1] = caps[i] + r.height * r.width + 16
    out = np.empty((int(caps[-1]), 3), np.int64)
    counts = np.zeros(n, np.int64)
    lib.nyx_contours_batch(
        labels_img.ctypes.data_as(ctypes.c_void_p),
        intens_img.ctypes.data_as(ctypes.c_void_p), H, W,
        rmat.ctypes.data_as(ctypes.c_void_p), n,
        caps.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p), _n_threads())
    return [out[caps[i]:caps[i] + counts[i]].copy() for i in range(n)]
