"""Public Python API: the ``Nyxus`` family of classes.

Mirrors the reference's Python surface (reference:
src/nyx/python/nyxus/nyxus.py:29-2311) on top of the JAX engine.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from . import columns as col
from . import taxonomy as tx
from .config import EngineConfig
from .pipeline.runner import PairRunner

_VALID_OUTPUT_TYPES = ("pandas", "arrowipc", "parquet")

_KWARG_MAP = {
    # constructor kwarg -> EngineConfig field (None = handled separately)
    "neighbor_distance": "pixel_distance",
    "pixels_per_micron": "pixels_per_micron",
    "coarse_gray_depth": "coarse_gray_depth",
    "n_feature_calc_threads": "n_feature_calc_threads",
    "ibsi": "ibsi",
    "mergerois": "mergerois",
    "gabor_kersize": "gabor_kersize",
    "gabor_gamma": "gabor_gamma",
    "gabor_sig2lam": "gabor_sig2lam",
    "gabor_f0": "gabor_f0",
    "gabor_thold": "gabor_thold",
    "dynamic_range": "fpimg_target_dr",
    "min_intensity": "fpimg_min",
    "max_intensity": "fpimg_max",
    "preserve_hu": "preserve_hu",
    "ram_limit": "ram_limit_mb",
    "anisotropy_x": "aniso_x",
    "anisotropy_y": "aniso_y",
    "precision": "precision",
}


def _force_finite(values: np.ndarray, noval: float) -> np.ndarray:
    """Reference: Nyxus::force_finite_number at output time."""
    out = values.copy()
    out[~np.isfinite(out)] = noval
    return out


def _prefetched(load, n):
    """Yield (k, load(k)) with item k+1 loading on a reader thread while
    item k is consumed (double-buffered IO; reference overlaps IO with
    compute via threaded tile loaders, abs_tile_loader.h:19)."""
    from concurrent.futures import ThreadPoolExecutor
    if n == 0:
        return
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        fut = ex.submit(load, 0)
        for k in range(n):
            item = fut.result()
            fut = ex.submit(load, k + 1) if k + 1 < n else None
            yield k, item
    finally:
        ex.shutdown(wait=False)


# ImageQuality is defined after Nyxus (it reuses its whole file/parameter
# surface); see below.


def _frame(header, int_name, seg_name, labs, values):
    n = len(labs)
    data = {
        col.COL_INTENSITY: [int_name] * n,
        col.COL_MASK: [seg_name] * n,
        col.COL_LABEL: labs.astype(np.uint32),
        col.COL_T: np.zeros(n),
    }
    for j, cname in enumerate(header[4:]):
        data[cname] = values[:, j]
    return pd.DataFrame(data)


class Nyxus:
    """2D feature extractor (reference: nyxus.py:29-909)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, **kwargs):
        self.features = list(features)
        cfg = EngineConfig()
        updates = {}
        for k, v in kwargs.items():
            field = _KWARG_MAP.get(k)
            if field is not None and v is not None:
                updates[field] = v
        if "gabor_thetas" in kwargs:
            updates["gabor_thetas"] = tuple(kwargs["gabor_thetas"])
        if "gabor_freqs" in kwargs:
            updates["gabor_freqs"] = tuple(kwargs["gabor_freqs"])
        if "verbose" in kwargs:
            self.verbosity = kwargs["verbose"]
        # Python-API calibration: xyRes = pixelSizeUm = pixels_per_micron
        # (default 1.0, new_bindings_py.cpp:93).  NOTE the reference never
        # copies xyRes into the Fsettings XYRES slot (env_features.cpp:
        # 711-737), so micron-gated outputs stay unassigned either way --
        # see ops/morphology.py AREA_UM2.
        updates.setdefault("xyres", float(updates.get("pixels_per_micron",
                                                      1.0)))
        # every reference entry path narrows anisotropy to C float
        # (new_bindings_py.cpp:80-82, cli_anisotropy_options.cpp:6-12);
        # mirror the rounding so AABB scaling arithmetic matches bit-for-bit
        for k in ("aniso_x", "aniso_y", "aniso_z"):
            if k in updates:
                updates[k] = float(np.float32(updates[k]))
        self.cfg = cfg.replace(**updates)
        self.error_message = ""
        # scale-out knobs (net-new vs the reference; SURVEY §2.11):
        # n_devices: shard ROI batches over a device mesh (-1 = all local
        # devices); shard_slides: this process handles pairs[pid::pcount]
        self._n_devices = kwargs.get("n_devices", 1)
        self._shard_slides = bool(kwargs.get("shard_slides", False))
        from .blacklist import RoiBlacklist
        self._blacklist = RoiBlacklist()
        self._compile()

    # -- setup ------------------------------------------------------------

    def _mesh(self):
        if self._n_devices in (None, 0, 1):
            return None
        from .parallel import roi_mesh
        return roi_mesh(None if self._n_devices == -1 else self._n_devices)

    def use_gpu_device(self, device_id: int):
        """Reference-compat accelerator selector (reference: nyxus.py:509
        use_gpu_device).  On this build the accelerator is whichever device
        JAX exposes; device_id selects one local accelerator by index and
        -1 means "default placement" (all numeric work already runs
        device-side, so there is no CPU-offload mode to toggle)."""
        from . import functions
        devs = functions._accel_devices()
        if device_id != -1 and not (0 <= device_id < len(devs)):
            raise ValueError("device id %d out of range (%d accelerator(s))"
                             % (device_id, len(devs)))
        self._device_id = device_id

    def _compile(self):
        self.fset = tx.parse_feature_request(
            self.features, dim=2, ibsi=self.cfg.ibsi)
        self.header, _ = col.build_header(self.fset, self.cfg)
        self._runner = PairRunner(self.fset, self.cfg, mesh=self._mesh())

    # -- featurize (in-memory NumPy montage) ------------------------------

    def featurize(self, intensity_images: np.ndarray, label_images: np.ndarray,
                  intensity_names: list = [], label_names: list = [],
                  output_type: str = "pandas", output_path: str = ""):
        if not isinstance(intensity_images, np.ndarray):
            raise ValueError("intensity_images parameter must be numpy.ndarray")
        if not isinstance(label_images, np.ndarray):
            raise ValueError("label_images parameter must be numpy.ndarray")

        if intensity_images.ndim == 2:
            if label_images.ndim != 2:
                raise ValueError("Both intensity and label arrays must be the same dimension")
            intensity_images = intensity_images[None]
            label_images = label_images[None]
        elif intensity_images.ndim != 3:
            raise ValueError("Intensity and label arrays must be 2D or 3D")
        if intensity_images.shape != label_images.shape:
            raise ValueError("Intensity and label image arrays must have the same "
                             "number of images with matching dimensions")

        n_img = intensity_images.shape[0]
        if not intensity_names:
            intensity_names = ["Intensity%d" % i for i in range(n_img)]
        if not label_names:
            label_names = ["Segmentation%d" % i for i in range(n_img)]
        if len(intensity_names) != n_img or len(label_names) != n_img:
            raise ValueError("Number of image names must equal the number of images")

        # Hounsfield-style shift + uint cast (reference: nyxus.py:469-477);
        # under --preserve-hu the slope-1 offset u = round(x - floor(min))
        # is recorded so IH_* can report in the original HU domain
        I = intensity_images
        min_raw = I.min() if I.size else 0
        hu_off = 0.0
        if self.cfg.preserve_hu:
            hu_off = float(np.floor(min_raw))
            I = np.maximum(np.round(I - hu_off), 0)
        elif min_raw < 0:
            I = I - min_raw
        if I.dtype.kind != "u":     # narrow unsigned dtypes ship as-is
            I = I.astype(np.uint32)
        M = label_images.astype(np.uint32)

        frames = []
        for i in range(n_img):
            labs, values = self._runner.run(I[i], M[i], hu_offset=hu_off)
            values = _force_finite(values, self.cfg.noval)
            frames.append(self._to_frame(intensity_names[i], label_names[i],
                                         labs, values))
        df = pd.concat(frames, ignore_index=True) if frames else self._to_frame("", "", np.zeros(0, np.int64), np.zeros((0, len(self.header) - 4)))
        if output_type == "pandas":
            return df
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types are %s."
                             % (output_type, self._valid_output_types))
        from .io import writers
        self._arrow_path = writers.write_dataframe(df, output_type, output_path)
        return self._arrow_path

    def _to_frame(self, int_name, seg_name, labs, values):
        n = len(labs)
        data = {
            col.COL_INTENSITY: [int_name] * n,
            col.COL_MASK: [seg_name] * n,
            col.COL_LABEL: labs.astype(np.uint32),
            col.COL_T: np.zeros(n),
        }
        for j, cname in enumerate(self.header[4:]):
            data[cname] = values[:, j]
        return pd.DataFrame(data)

    # -- file-based featurization ------------------------------------------

    def featurize_directory(self, intensity_dir: str, label_dir: str = None,
                            file_pattern: str = ".*",
                            output_type: str = "pandas",
                            output_path: str = ""):
        """Extract features from all image pairs in a directory
        (reference: nyxus.py:291-370)."""
        import os
        from .io import dataset as ds
        from .io import readers

        if not os.path.exists(intensity_dir):
            raise IOError("Provided intensity image directory '%s' does not exist."
                          % intensity_dir)
        if label_dir is not None and not os.path.exists(label_dir):
            raise IOError("Provided label image directory '%s' does not exist."
                          % label_dir)
        if label_dir is None:
            label_dir = intensity_dir
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types are %s."
                             % (output_type, self._valid_output_types))

        if output_type == "pandas":
            frames = [f for _, _, f in self._iter_directory_frames(
                intensity_dir, label_dir, file_pattern)]
            return pd.concat(frames, ignore_index=True) if frames else \
                self._to_frame("", "", np.zeros(0, np.int64),
                               np.zeros((0, len(self.header) - 4)))
        # arrow/parquet: per-slide streamed commits, constant memory over
        # the dataset (reference: workflow_2d_segmented.cpp:322-352,
        # arrow_output_stream.h:22-57)
        from .io import writers
        w = writers.StreamingArrowWriter(output_type, output_path)
        wrote = False
        try:
            for _, _, frame in self._iter_directory_frames(
                    intensity_dir, label_dir, file_pattern):
                w.write(frame)
                wrote = True
            if not wrote:
                w.write(self._to_frame("", "", np.zeros(0, np.int64),
                                       np.zeros((0, len(self.header) - 4))))
        finally:
            w.close()
        self._arrow_path = w.path
        return self._arrow_path

    def _iter_directory_frames(self, intensity_dir, label_dir, file_pattern):
        """Yield (int_path, seg_path, per-slide DataFrame) one pair at a
        time; the backbone of both the accumulating and the streaming
        output modes."""
        for ipath, lpath, labs, values in self._iter_directory_raw(
                intensity_dir, label_dir, file_pattern):
            yield ipath, lpath, self._to_frame(ipath, lpath, labs, values)

    def _iter_directory_raw(self, intensity_dir, label_dir, file_pattern):
        """Yield (int_path, seg_path, labels, values ndarray) per pair --
        the frame-free backbone (the CSV writer consumes the raw matrix;
        building a 750-column DataFrame costs ~50 ms per slide)."""
        import os
        from .io import dataset as ds

        int_files, lab_files, wholeslide = ds.read_2d_dataset(
            intensity_dir, label_dir, file_pattern)
        if self._shard_slides:
            from .parallel import process_shard
            pairs = process_shard(list(zip(int_files, lab_files)))
            int_files = [p[0] for p in pairs]
            lab_files = [p[1] for p in pairs]
        # double-buffered IO: a reader thread decodes the NEXT pair while
        # the current pair computes (reference overlaps IO with compute via
        # threaded tile loaders, abs_tile_loader.h:19, grayscale_tiff.h:33)
        from concurrent.futures import ThreadPoolExecutor
        pairs = list(zip(int_files, lab_files))
        ex = ThreadPoolExecutor(max_workers=1)

        def load(k):
            try:
                return self._load_pair_arrays(pairs[k][0], pairs[k][1],
                                              wholeslide)
            except Exception:
                return None     # unreadable here -> re-read in-line below

        # two-slide software pipeline: slide k's ASYNC device execution
        # overlaps slide k+1's host stages (discovery, contours, geometry,
        # dispatch); `finish` collects k's results right after k+1 launches
        def finalize(entry):
            ipath, lpath, labs, fin = entry
            values = _force_finite(fin() if callable(fin) else fin,
                                   self.cfg.noval)
            return ipath, lpath, labs, values

        from collections import deque
        # three-deep pipeline, with collection on worker threads: slide k's
        # result collection (device fetch + device-dependent host families)
        # runs CONCURRENTLY with k+1's collection and k+2's dispatch, so
        # the main thread's per-slide critical path is dispatch + yield
        # only.  Results still yield in submission order.
        fin_ex = ThreadPoolExecutor(max_workers=4,
                                    thread_name_prefix="nyx-collect")
        inflight = deque()       # ordered futures of finalize()
        try:
            fut = ex.submit(load, 0) if pairs else None
            for k, (ipath, lpath) in enumerate(pairs):
                pre = fut.result() if fut is not None else None
                fut = (ex.submit(load, k + 1)
                       if k + 1 < len(pairs) else None)
                fname = os.path.basename(lpath or ipath)
                labs, fin = self._run_pair_file(ipath, lpath, wholeslide,
                                                fname, preloaded=pre,
                                                async_collect=True)
                inflight.append(fin_ex.submit(
                    finalize, (ipath, lpath, labs, fin)))
                if len(inflight) > 4:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            ex.shutdown(wait=False)
            fin_ex.shutdown(wait=False)

    def featurize_files(self, intensity_files, mask_files, single_roi=False,
                        output_type: str = "pandas", output_path: str = ""):
        """Extract features from explicit file-pair lists
        (reference: nyxus.py:512-558)."""
        import os

        def gen():
            for k, ipath in enumerate(intensity_files):
                lpath = ipath if single_roi else mask_files[k]
                labs, values = self._run_pair_file(ipath, lpath, single_roi,
                                                   os.path.basename(lpath))
                values = _force_finite(values, self.cfg.noval)
                yield self._to_frame(ipath, lpath, labs, values)

        if output_type == "pandas":
            return pd.concat(list(gen()), ignore_index=True)
        # streamed per-slide commits (arrow_output_stream.h:22-57)
        from .io import writers
        w = writers.StreamingArrowWriter(output_type, output_path)
        try:
            for frame in gen():
                w.write(frame)
        finally:
            w.close()
        self._arrow_path = w.path
        return self._arrow_path

    def _open_stream_source(self, ipath, lpath, wholeslide):
        """A region-read PairSource for ``ipath``'s format, or None when
        the format only supports whole-image decode.  Streamable formats:
        tiled/strip TIFF (native region server), OME-Zarr v2/v3 (chunk
        reads), tiled multi-frame DICOM (per-frame decode).  Mirrors the
        reference's per-format tile loaders (grayscale_tiff.h:25,
        omezarr.h:10-48, nyxus_dicom_loader.h:4-19)."""
        import os
        from .pipeline import sources
        ext = os.path.splitext(ipath)[1].lower()
        try:
            if ext in (".tif", ".tiff"):
                from . import native
                if not native.tiff_available():
                    return None
                return (sources.WholeSlideTiffSource(ipath) if wholeslide
                        else sources.TiffPairSource(ipath, lpath))
            if ext == ".zarr" or os.path.isdir(ipath):
                return sources.ZarrPairSource(
                    ipath, None if wholeslide else lpath)
            if ext in (".dcm", ".dicom"):
                return sources.DicomPairSource(
                    ipath, None if wholeslide else lpath)
        except Exception:
            return None     # unreadable/untiled -> whole-image fallback
        return None

    def _stream_gate(self, shape) -> bool:
        """True when a slide of ``shape`` must take the streamed path
        (16 B/px in-memory footprint: f64 intens + i64 labels; reference
        RAM gate, workflow_2d_segmented.cpp:124-139)."""
        H, W = shape
        return H * W * 16 > (self.cfg.ram_limit_mb << 20) // 2

    def _load_pair_arrays(self, ipath, lpath, wholeslide):
        """Pre-decode one pair into in-memory arrays (prefetch worker);
        None when the pair exceeds the RAM gate and must stream."""
        from .io import readers
        src = self._open_stream_source(ipath, lpath, wholeslide)
        if src is not None:
            over = self._stream_gate(src.shape)
            src.close()
            if over:
                return None
        intens = readers.read_gray(ipath)
        labmat = (np.ones(intens.shape, np.uint32) if wholeslide
                  else readers.read_gray(lpath).astype(np.uint32))
        I, hu_off = self._prep_intensity(intens)
        # run the NEXT slide's phase-1 discovery here on the prefetch
        # thread (native, GIL-free) so the main thread's per-slide critical
        # path starts at the contour pass
        pre_disc = None
        if not (self.cfg.mergerois or self.cfg.aniso_customized):
            try:
                from .pipeline import labels as labels_mod
                pre_disc = labels_mod.discover_rois_clouds(I, labmat)
            except Exception:
                pre_disc = None
        return I, labmat, hu_off, pre_disc

    def _run_pair_file(self, ipath, lpath, wholeslide, fname,
                       preloaded=None, async_collect=False):
        """Featurize one on-disk pair; big pairs in a region-readable
        format (TIFF/zarr/tiled DICOM) stream block-by-block instead of
        materializing (reference RAM gate: nontrivial split,
        phase1.cpp:104-118).  With ``async_collect`` the second element
        returned is a finish() callable (see PairRunner._run_core)."""
        from .io import readers
        if preloaded is not None:
            I, labmat, hu_off, pre_disc = preloaded
            return self._runner.run(I, labmat, blacklist=self._blacklist,
                                    wholeslide=wholeslide, fname=fname,
                                    async_collect=async_collect,
                                    hu_offset=hu_off,
                                    pre_discovery=pre_disc)
        src = self._open_stream_source(ipath, lpath, wholeslide)
        if src is not None:
            if self._stream_gate(src.shape):
                with src:
                    return self._runner.run_streamed(
                        src, blacklist=self._blacklist, fname=fname,
                        wholeslide=wholeslide)
            src.close()
        intens = readers.read_gray(ipath)
        if wholeslide:
            labmat = np.ones(intens.shape, np.uint32)
        else:
            labmat = readers.read_gray(lpath).astype(np.uint32)
        I, hu_off = self._prep_intensity(intens)
        return self._runner.run(I, labmat, blacklist=self._blacklist,
                                wholeslide=wholeslide,
                                fname=fname, hu_offset=hu_off)

    def _prep_intensity(self, intens: np.ndarray):
        """(offset uint image, hu_offset): the load-time float->uint map.
        Under --preserve-hu: u = round(x - floor(slide_min)) clamped at 0
        (reference: slideprops.h:48-66 uint_friendly_inten), with the offset
        returned so IH_* can undo it."""
        if self.cfg.preserve_hu and intens.size:
            off = float(np.floor(intens.min()))
            return np.maximum(np.round(intens - off), 0).astype(np.uint32), \
                off
        if intens.size and intens.min() < 0:
            intens = intens - intens.min()
        if intens.dtype.kind == "u":
            # keep the narrow dtype: uint16 slides ship to the device in
            # half the bytes of the uint32 upcast (whether that pays on
            # the GPU is ROADMAP D2)
            return intens, 0.0
        return intens.astype(np.uint32), 0.0

    # -- ROI blacklist (reference: nyxus.py:771-830) -----------------------

    def blacklist_roi(self, raw: str):
        self._blacklist.parse_raw_string(raw)

    def clear_roi_blacklist(self):
        self._blacklist.clear()

    def roi_blacklist_get_summary(self) -> str:
        return self._blacklist.summary()

    # -- Arrow accessors ----------------------------------------------------

    def get_arrow_ipc_file(self):
        return getattr(self, "_arrow_path", "")

    def get_parquet_file(self):
        return getattr(self, "_arrow_path", "")

    @staticmethod
    def arrow_is_enabled():
        try:
            import pyarrow  # noqa: F401
            return True
        except ImportError:
            return False

    # -- parameter access (reference: nyxus.py:560-770) -------------------

    def set_params(self, **params):
        updates = {}
        for k, v in params.items():
            field = _KWARG_MAP.get(k)
            if field is not None:
                updates[field] = v
            elif k == "features":
                self.features = list(v)
            elif k in ("gabor_thetas", "gabor_freqs"):
                updates[k] = tuple(v)
        if updates:
            self.cfg = self.cfg.replace(**updates)
        self._compile()

    def get_params(self, *args):
        inv = {v: k for k, v in _KWARG_MAP.items()}
        out = {"features": self.features}
        for field, kwarg in inv.items():
            out[kwarg] = getattr(self.cfg, field)
        out["gabor_thetas"] = list(self.cfg.gabor_thetas)
        out["gabor_freqs"] = list(self.cfg.gabor_freqs)
        if args:
            return {k: v for k, v in out.items() if k in args}
        return out

    def set_environment_params(self, **params):
        """Alias surface of set_params (reference: nyxus.py:718-770)."""
        self.set_params(**params)

    # -- metaparameters (reference: nyxus.py:252-289, env_metaparams.cpp) --

    def set_metaparam(self, paramval: str):
        from . import metaparams
        cfg, err = metaparams.set_metaparam(self.cfg, paramval)
        if err is not None:
            raise ValueError("Invalid metaparameter value %s: %s"
                             % (paramval, err))
        self.cfg = cfg
        self._compile()

    def get_metaparam(self, paramname: str):
        from . import metaparams
        val, err = metaparams.get_metaparam(self.cfg, paramname)
        if err:
            raise NameError("Invalid metaparameter name %s: %s"
                            % (paramname, err))
        return val

    # -- Gabor customization (reference: nyxus.py:660-716) -----------------

    def set_gabor_feature_params(self, **kwargs):
        valid = ("kersize", "gamma", "sig2lam", "f0", "thold", "thetas",
                 "freqs")
        for key in kwargs:
            if key not in valid:
                raise ValueError("Invalid Gabor parameter %s. The valid "
                                 "parameters are: %s" % (key, list(valid)))
        if not kwargs:
            raise IOError("Illegal arguments passed to "
                          "set_gabor_feature_params()")
        updates = {}
        if "kersize" in kwargs:
            updates["gabor_kersize"] = int(kwargs["kersize"])
        if "gamma" in kwargs:
            updates["gabor_gamma"] = float(kwargs["gamma"])
        if "sig2lam" in kwargs:
            updates["gabor_sig2lam"] = float(kwargs["sig2lam"])
        if "f0" in kwargs:
            updates["gabor_f0"] = float(kwargs["f0"])
        if "thold" in kwargs:
            updates["gabor_thold"] = float(kwargs["thold"])
        if "thetas" in kwargs:
            updates["gabor_thetas"] = tuple(float(t) for t in kwargs["thetas"])
        if "freqs" in kwargs:
            updates["gabor_freqs"] = tuple(float(f) for f in kwargs["freqs"])
        if ("thetas" in kwargs) != ("freqs" in kwargs) or (
                "thetas" in kwargs
                and len(updates["gabor_thetas"]) != len(updates["gabor_freqs"])):
            raise ValueError("Gabor thetas and freqs must be specified "
                             "together with matching lengths")
        self.cfg = self.cfg.replace(**updates)
        self._compile()


class ImageQuality(Nyxus):
    """Image-quality feature extractor (reference: nyxus.py:1468-2188).

    Runs the IMQ family over whole images (a virtual ROI covering every
    pixel) or per labeled ROI when a label image is supplied; shares the
    full file/parameter surface of ``Nyxus`` (featurize_directory,
    featurize_files, blacklist, set/get_params, ...)."""

    def __init__(self, features=("*ALL_IMQ*",), **kwargs):
        super().__init__(list(features), **kwargs)

    def _compile(self):
        self.fset = tx.parse_feature_request(self.features, imq=True)
        self.header, _ = col.build_header(self.fset, self.cfg)
        self._runner = PairRunner(self.fset, self.cfg, mesh=self._mesh())

    def featurize(self, intensity_images: np.ndarray, label_images=None,
                  intensity_names: list = [], label_names: list = [],
                  output_type: str = "pandas", output_path: str = ""):
        # whole-image quality: a constant-1 label image per slide
        # (reference: nyxus.py ImageQuality.featurize label default)
        if label_images is None:
            label_images = np.ones(np.asarray(intensity_images).shape,
                                   np.int32)
        return super().featurize(intensity_images, label_images,
                                 intensity_names, label_names,
                                 output_type, output_path)


class Nyxus3D:
    """3D feature extractor over NIfTI volumes or in-memory voxel arrays
    (reference: nyxus.py:911-1466)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, **kwargs):
        self.features = list(features)
        cfg = EngineConfig()
        updates = {}
        for k, v in kwargs.items():
            field = _KWARG_MAP.get(k)
            if field is not None and v is not None:
                updates[field] = v
        if kwargs.get("anisotropy_z") is not None:
            updates["aniso_z"] = kwargs["anisotropy_z"]
        if "verbose" in kwargs:
            self.verbosity = kwargs["verbose"]
        # Python-API calibration: xyRes = pixelSizeUm = pixels_per_micron
        # (default 1.0, new_bindings_py.cpp:93).  NOTE the reference never
        # copies xyRes into the Fsettings XYRES slot (env_features.cpp:
        # 711-737), so micron-gated outputs stay unassigned either way --
        # see ops/morphology.py AREA_UM2.
        updates.setdefault("xyres", float(updates.get("pixels_per_micron",
                                                      1.0)))
        # every reference entry path narrows anisotropy to C float
        # (new_bindings_py.cpp:80-82, cli_anisotropy_options.cpp:6-12);
        # mirror the rounding so AABB scaling arithmetic matches bit-for-bit
        for k in ("aniso_x", "aniso_y", "aniso_z"):
            if k in updates:
                updates[k] = float(np.float32(updates[k]))
        self.cfg = cfg.replace(**updates)
        self.error_message = ""
        self._n_devices = kwargs.get("n_devices", 1)
        self._shard_slides = bool(kwargs.get("shard_slides", False))
        self._compile()

    _mesh = Nyxus._mesh
    use_gpu_device = Nyxus.use_gpu_device
    # metaparameter surface (reference nyxus.py:252-289 exposes it on the
    # 3D class too; the 3D-family paths are 3glcm/..., 3ngtdm/radius, ...)
    set_metaparam = Nyxus.set_metaparam
    get_metaparam = Nyxus.get_metaparam

    def _compile(self):
        self.fset = tx.parse_feature_request(
            self.features, dim=3, ibsi=self.cfg.ibsi)
        self.header, _ = col.build_header(self.fset, self.cfg)
        from .pipeline.runner3d import VolumeRunner
        self._runner = VolumeRunner(self.fset, self.cfg, mesh=self._mesh())

    def featurize(self, intensity_volumes, label_volumes,
                  intensity_names: list = [], label_names: list = []):
        """Featurize in-memory [Z, Y, X] volume pairs (or lists thereof)."""
        if isinstance(intensity_volumes, np.ndarray) and intensity_volumes.ndim == 3:
            intensity_volumes = [intensity_volumes]
            label_volumes = [label_volumes]
        frames = []
        for i, (I, M) in enumerate(zip(intensity_volumes, label_volumes)):
            iname = intensity_names[i] if intensity_names else "Intensity%d" % i
            lname = label_names[i] if label_names else "Segmentation%d" % i
            labs, values = self._runner.run(self._prep(np.asarray(I)),
                                            np.asarray(M).astype(np.int32))
            values = _force_finite(values, self.cfg.noval)
            frames.append(_frame(self.header, iname, lname, labs, values))
        return pd.concat(frames, ignore_index=True)

    def featurize_directory(self, intensity_dir: str, label_dir: str,
                            file_pattern: str = ".*",
                            output_type: str = "pandas",
                            output_path: str = ""):
        import os
        from .io import dataset as ds
        from .io import readers

        if not os.path.exists(intensity_dir):
            raise IOError("Provided intensity image directory '%s' does not exist."
                          % intensity_dir)
        if label_dir is not None and not os.path.exists(label_dir):
            raise IOError("Provided label image directory '%s' does not exist."
                          % label_dir)
        if label_dir is None:
            label_dir = intensity_dir
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types are %s."
                             % (output_type, self._valid_output_types))
        from .io.strpat import StringPattern
        if StringPattern.is_layoutA_fpattern(file_pattern):
            # 2.5D: z-stacks of 2D slice files form volumes (reference:
            # phase2_25d.cpp, Imgfile3D_layoutA).  Stack k+1 assembles on
            # the reader thread while stack k computes (the 2D directory
            # path's IO/compute overlap; reference thread-per-volume,
            # workflow_3d_whole.cpp:294)
            groups = list(ds.read_3d_layoutA(
                intensity_dir, label_dir, file_pattern))
            from .pipeline.sources import LayoutAStack

            def _prep_slice(a):
                a = np.asarray(a, np.float64)
                if a.size and a.min() < 0:
                    # global min-shift needs the whole stack; fall back
                    raise ValueError("negative intensities")
                return np.floor(a)

            def load_stack(k):
                _, ipaths, lpaths = groups[k]
                # RAM gate (reference tile-streams 2.5D like 2D,
                # phase1.cpp:130 gatherRoisMetrics_25D): over-budget
                # stacks return a lazy per-slice source instead of
                # np.stack-ing the whole z-stack
                try:
                    stack = LayoutAStack(ipaths, lpaths, prep=_prep_slice)
                    D, H, W = stack.full_shape
                    if D * H * W * 16 > (self.cfg.ram_limit_mb << 20) // 2:
                        return stack
                except ValueError:
                    pass
                return (np.stack([readers.read_gray(p) for p in ipaths]),
                        np.stack([readers.read_gray(p) for p in lpaths]))

            def gen():
                for k, vols in _prefetched(load_stack, len(groups)):
                    key = groups[k][0]
                    if isinstance(vols, LayoutAStack):
                        try:
                            labs, values = self._runner.run(vols.intens,
                                                            vols.labels)
                        except ValueError:
                            # negative intensities mid-stack: materialize
                            _, ipaths, lpaths = groups[k]
                            ivol = np.stack([readers.read_gray(p)
                                             for p in ipaths])
                            lvol = np.stack([readers.read_gray(p)
                                             for p in lpaths])
                            labs, values = self._runner.run(
                                self._prep(ivol), lvol.astype(np.int32))
                    else:
                        ivol, lvol = vols
                        labs, values = self._runner.run(
                            self._prep(ivol), lvol.astype(np.int32))
                    values = _force_finite(values, self.cfg.noval)
                    yield _frame(self.header,
                                 os.path.join(intensity_dir, key),
                                 os.path.join(label_dir, key),
                                 labs, values)
        else:
            int_files, lab_files, _ = ds.read_3d_dataset(
                intensity_dir, label_dir, file_pattern)
            vol_pairs = list(zip(int_files, lab_files))
            if self._shard_slides:
                from .parallel import process_shard
                vol_pairs = process_shard(vol_pairs)

            def gen():
                yield from self._iter_volume_pairs(vol_pairs)
        return self._emit(gen(), output_type, output_path)

    def featurize_files(self, intensity_files, mask_files, single_roi=False,
                        output_type: str = "pandas", output_path: str = ""):
        if intensity_files is None:
            raise IOError("The list of intensity file paths is empty")
        if mask_files is None and not single_roi:
            raise IOError("The list of segment file paths is empty")
        pairs = [(ipath, ipath if single_roi else mask_files[k])
                 for k, ipath in enumerate(intensity_files)]
        return self._emit(self._iter_volume_pairs(pairs,
                                                  single_roi=single_roi),
                          output_type, output_path)

    def _emit(self, frame_gen, output_type, output_path):
        """pandas: concatenate; arrow/parquet: per-volume streamed commits
        in constant memory (the 2D path's behavior; reference streams per
        volume too, workflow_3d_whole.cpp:172-186
        save_features_2_apache_wholeslide)."""
        if output_type == "pandas":
            frames = list(frame_gen)
            return pd.concat(frames, ignore_index=True) if frames else \
                _frame(self.header, "", "", np.zeros(0, np.int64),
                       np.zeros((0, len(self.header) - 4)))
        from .io import writers
        w = writers.StreamingArrowWriter(output_type, output_path)
        try:
            wrote = False
            for frame in frame_gen:
                w.write(frame)
                wrote = True
            if not wrote:
                w.write(_frame(self.header, "", "", np.zeros(0, np.int64),
                               np.zeros((0, len(self.header) - 4))))
        finally:
            w.close()
        self._arrow_path = w.path
        return self._arrow_path

    def _iter_volume_pairs(self, pairs, single_roi=False):
        """Per-slide frames for a volume pair list; volume k+1 decodes on a
        reader thread while volume k computes (the 2D path's IO/compute
        overlap; the reference fans whole volumes over threads,
        workflow_3d_whole.cpp:294)."""
        from .io import readers

        def load(k):
            ipath, lpath = pairs[k]
            ivol, imeta = readers.read_volume(ipath, with_meta=True)
            if single_roi:
                lvol = np.ones(ivol.shape, np.int32)
            else:
                lvol, _ = readers.read_volume(lpath, with_meta=True)
            return ivol, imeta, lvol

        for k, (ivol, imeta, lvol) in _prefetched(load, len(pairs)):
            ipath, lpath = pairs[k]
            yield self._featurize_volume_arrays(
                ipath, "" if single_roi else lpath, ivol, imeta, lvol,
                wholeslide=single_roi)

    def _featurize_volume_pair(self, ipath, lpath, single_roi=False):
        """One volume pair, loaded and featurized strictly serially --
        kept as the no-prefetch baseline the pipelined-vs-serial parity
        test compares against (tests/test_stream_sources.py)."""
        from .io import readers
        ivol, imeta = readers.read_volume(ipath, with_meta=True)
        if single_roi:
            lvol = np.ones(ivol.shape, np.int32)
        else:
            lvol, _ = readers.read_volume(lpath, with_meta=True)
        return self._featurize_volume_arrays(
            ipath, "" if single_roi else lpath, ivol, imeta, lvol,
            wholeslide=single_roi)

    def _featurize_volume_arrays(self, ipath, lname, ivol, imeta, lvol,
                                 wholeslide=False):
        nt = max(imeta["nt"], 1)
        frames = []
        for t in range(nt):
            lt = lvol[t] if lvol.shape[0] > t else lvol[0]
            labs, values = self._runner.run(self._prep(ivol[t]),
                                            lt.astype(np.int32),
                                            wholeslide=wholeslide)
            values = _force_finite(values, self.cfg.noval)
            f = _frame(self.header, ipath, lname, labs, values)
            f[col.COL_T] = float(t)
            frames.append(f)
        return pd.concat(frames, ignore_index=True)

    def _prep(self, vol: np.ndarray) -> np.ndarray:
        vol = np.asarray(vol, np.float64)
        if vol.size and vol.min() < 0:
            vol = vol - vol.min()
        return np.floor(vol)

    def get_arrow_ipc_file(self):
        return getattr(self, "_arrow_path", "")

    def get_parquet_file(self):
        return getattr(self, "_arrow_path", "")

    @staticmethod
    def arrow_is_enabled():
        return Nyxus.arrow_is_enabled()

    def set_params(self, **params):
        updates = {}
        for k, v in params.items():
            field = _KWARG_MAP.get(k)
            if field is not None:
                updates[field] = v
            elif k == "features":
                self.features = list(v)
        if updates:
            self.cfg = self.cfg.replace(**updates)
        self._compile()

    def get_params(self, *args):
        inv = {v: k for k, v in _KWARG_MAP.items()}
        out = {"features": self.features}
        for field, kwarg in inv.items():
            out[kwarg] = getattr(self.cfg, field)
        if args:
            return {k: v for k, v in out.items() if k in args}
        return out

    set_metaparam = Nyxus.set_metaparam
    get_metaparam = Nyxus.get_metaparam
    set_environment_params = Nyxus.set_environment_params
