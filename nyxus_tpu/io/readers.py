"""Image readers (whole-image entry points + format dispatch).

The reference uses native libtiff/z5/DCMTK/NIfTI loaders (src/nyx/
grayscale_tiff.h, omezarr.h, nyxus_dicom_loader.h, raw_nifti.*).  This
build's equivalents: the native C++ tiled/strip TIFF region server
(``nyxus_tpu.native.TiffReader``, used for all tile-streamed paths), the
self-written NIfTI-1/2 reader (``nifti.py``), DICOM incl. encapsulated
RLE/JPEG transfer syntaxes (``dicom.py``), and OME-Zarr v2 with native
blosc/zlib codecs (``zarr.py``).  PIL reads what libtiff cannot open (e.g.
PNG masks in tests), and reads TIFF on hosts without libtiff.
"""

from __future__ import annotations

import os

import numpy as np


def read_gray(path: str) -> np.ndarray:
    """Read a grayscale image (TIFF/PNG/OME-Zarr/DICOM/...) as a 2D numpy
    array, preserving bit depth."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".zarr" or os.path.isdir(path):
        from .zarr import OmeZarrReader
        return OmeZarrReader(path).read_slice()
    if ext in (".dcm", ".dicom"):
        from .dicom import read_dicom_gray
        return read_dicom_gray(path)
    if ext in (".tif", ".tiff"):
        # fast path: native libtiff region server (tiled/strip, any dtype)
        try:
            from .. import native
            if native.tiff_available():
                with native.TiffReader(path) as r:
                    if r.is_float:
                        return r.read_all("f32")
                    arr = r.read_all("u32")
                    if r.is_signed:
                        arr = arr.view(np.int32).copy()
                    if not r.is_signed and r.bits <= 16:
                        arr = arr.astype(np.uint16)
                    return arr
        except Exception:
            pass
    try:
        from PIL import Image
        Image.MAX_IMAGE_PIXELS = None
        with Image.open(path) as im:
            arr = np.array(im)
            if arr.ndim == 3:
                arr = arr[..., 0]
            return arr
    except Exception:
        pass
    import cv2
    arr = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
    if arr is None:
        raise IOError("cannot read image: %s" % path)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def write_gray(path: str, arr: np.ndarray):
    from PIL import Image
    Image.fromarray(arr).save(path)


# ---------------------------------------------------------------------------
# NIfTI-1/2 volumes (reference: src/nyx/raw_nifti.h:188-330 NiftiLoader over
# the vendored nifti2_io; voxel order on disk is x-fastest, so the in-memory
# layout is [t][z][y][x])

_NIFTI_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}


def _nifti_blob(path: str) -> bytes:
    import gzip
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            return gzip.decompress(f.read())
        return f.read()


def read_nifti(path: str, with_meta: bool = False):
    """Read a .nii/.nii.gz volume as [T, Z, Y, X] (T dropped when nt<=1 and
    with_meta is False).  Pure-numpy NIfTI-1/NIfTI-2 parser; byte order is
    detected from sizeof_hdr.  The raw stored values are returned (the
    reference applies scl_slope/inter only in preserve_hu mode,
    raw_nifti.h:243-245); meta carries the header rescale for that mode.

    Uncompressed single-file .nii volumes come back as a read-only
    np.memmap: z-slab consumers (the slice-streamed 3D oversized path)
    page only the slices they touch, so over-RAM volumes never fully
    materialize (the reference's streamed NIfTI reads, raw_nifti.h:189)."""
    is_mmap = False
    if not path.lower().endswith(".gz"):
        with open(path, "rb") as f:
            head = f.read(2)
        if head != b"\x1f\x8b":
            with open(path, "rb") as f:
                blob = f.read(600)      # NIfTI-1/2 headers fit in 544 B
            is_mmap = True
    if not is_mmap:
        blob = _nifti_blob(path)
    hdr_size = int(np.frombuffer(blob, "<i4", 1, 0)[0])
    bo = "<"
    if hdr_size not in (348, 540):
        hdr_size = int(np.frombuffer(blob, ">i4", 1, 0)[0])
        bo = ">"
        if hdr_size not in (348, 540):
            raise IOError("not a NIfTI file: %s" % path)
    if hdr_size == 348:                      # NIfTI-1
        dim = np.frombuffer(blob, bo + "i2", 8, 40).astype(np.int64)
        datatype = int(np.frombuffer(blob, bo + "i2", 1, 70)[0])
        vox_offset = int(np.frombuffer(blob, bo + "f4", 1, 108)[0])
        scl_slope = float(np.frombuffer(blob, bo + "f4", 1, 112)[0])
        scl_inter = float(np.frombuffer(blob, bo + "f4", 1, 116)[0])
    else:                                    # NIfTI-2
        datatype = int(np.frombuffer(blob, bo + "i2", 1, 12)[0])
        dim = np.frombuffer(blob, bo + "i8", 8, 16).astype(np.int64)
        vox_offset = int(np.frombuffer(blob, bo + "i8", 1, 168)[0])
        scl_slope = float(np.frombuffer(blob, bo + "f8", 1, 176)[0])
        scl_inter = float(np.frombuffer(blob, bo + "f8", 1, 184)[0])
    if datatype not in _NIFTI_DTYPES:
        raise IOError("unrecognized NIFTI data type %d in %s" % (datatype, path))
    ndim = int(dim[0])
    nx = max(int(dim[1]), 1)
    ny = max(int(dim[2]), 1) if ndim >= 2 else 1
    nz = max(int(dim[3]), 1) if ndim >= 3 else 1
    nt = max(int(dim[4]), 1) if ndim >= 4 else 1
    dt = np.dtype(_NIFTI_DTYPES[datatype]).newbyteorder(bo)
    nvox = nx * ny * nz * nt
    if is_mmap:
        vol = np.memmap(path, dtype=dt, mode="r", offset=vox_offset,
                        shape=(nt, nz, ny, nx))
    else:
        data = np.frombuffer(blob, dt, nvox, vox_offset)
        vol = data.reshape(nt, nz, ny, nx)
    if with_meta:
        meta = {"scl_slope": scl_slope if scl_slope != 0.0 else 1.0,
                "scl_inter": scl_inter if scl_slope != 0.0 else 0.0,
                "nt": nt}
        return vol, meta
    return vol if nt > 1 else vol[0]


def write_nifti(path: str, vol: np.ndarray):
    """Write a [Z, Y, X] or [T, Z, Y, X] volume as NIfTI-1 (test/roundtrip
    support)."""
    import gzip
    if vol.ndim == 3:
        vol = vol[None]
    nt, nz, ny, nx = vol.shape
    code = None
    for c, d in _NIFTI_DTYPES.items():
        if np.dtype(d) == vol.dtype:
            code = c
            break
    if code is None:
        vol = vol.astype(np.float64)
        code = 64
    hdr = bytearray(352)
    hdr[0:4] = np.int32(348).tobytes()
    dim = np.zeros(8, np.int16)
    dim[0] = 4 if nt > 1 else 3
    dim[1:5] = (nx, ny, nz, nt)
    dim[5:] = 1
    hdr[40:56] = dim.tobytes()
    hdr[70:72] = np.int16(code).tobytes()
    hdr[72:74] = np.int16(vol.dtype.itemsize * 8).tobytes()
    pixdim = np.ones(8, np.float32)
    hdr[76:108] = pixdim.tobytes()
    hdr[108:112] = np.float32(352).tobytes()
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + np.ascontiguousarray(vol).tobytes()
    if path.endswith(".gz"):
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(payload)


def read_volume(path: str, with_meta: bool = False):
    """Read a volume file as [T, Z, Y, X]: NIfTI (.nii/.nii.gz) or OME-Zarr
    (.zarr directory) -- the reference's ImageLoader extension dispatch
    (image_loader.cpp:27-176) for volumetric inputs."""
    low = path.lower()
    if low.endswith(".zarr") or os.path.isdir(path):
        from .zarr import OmeZarrReader
        z = OmeZarrReader(path)
        vol = np.stack([z.read_volume(t=t) for t in range(z.nt)])
        return (vol, {"nt": z.nt, "slope": 1.0, "inter": 0.0}) \
            if with_meta else vol
    return read_nifti(path, with_meta)
