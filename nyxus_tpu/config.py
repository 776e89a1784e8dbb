"""Engine configuration: this engine's equivalent of the reference's
Environment + per-family Fsettings (reference: src/nyx/environment.h:30-278,
src/nyx/feature_settings.h:6-81, defaults env_features.cpp:714-738).

Everything that changes compiled-kernel behavior lives in the hashable,
frozen ``EngineConfig`` so it can be a static jit argument.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # result conventions (reference: cli_result_options.h, roi_cache.h:17)
    noval: float = -0.0            # soft NAN placeholder (--noval)
    tinyval: float = 1e-10         # tiny value substitute (--tinyval)

    # binning / texture (reference: environment.cpp:106, cli_glcm_options.h)
    coarse_gray_depth: int = 64
    ibsi: bool = False
    glcm_angles: Tuple[int, ...] = (0, 45, 90, 135)
    glcm_offset: int = 1
    pixel_distance: int = 5        # neighbor distance (--pixelDistance)
    mergerois: bool = False        # merge all nonzero labels into one ROI
                                   # (--mergerois, environment.h:56-60)

    # per-family grey-depth overrides (metaparams, env_metaparams.cpp);
    # None -> inherit coarse_gray_depth
    glcm_greydepth: int | None = None
    gldm_greydepth: int | None = None
    glrlm_greydepth: int | None = None
    glszm_greydepth: int | None = None
    ngtdm_greydepth: int | None = None
    ngtdm_radius: int = 1

    # 3D-family slots (metaparam paths 3glcm/..., env_metaparams.cpp:109-246)
    d3_glcm_greydepth: int | None = None
    d3_glcm_offset: int | None = None       # falls back to glcm_offset
    d3_glcm_numang: int = 13                # stored; calculator uses all 13
    d3_glcm_sparseintensities: int = 0      # stored; accepted for parity
    d3_gldm_greydepth: int | None = None
    d3_ngtdm_greydepth: int | None = None
    d3_glrlm_greydepth: int | None = None
    d3_glszm_greydepth: int | None = None
    # reference default is 0 (env_features.cpp:712-736 zero-initializes
    # NGTDM_RADIUS): the 3D NGTDM neighborhood is empty and all five members
    # are emitted as 0.0 unless --featureParams=3ngtdm/radius=N is given
    d3_ngtdm_radius: int = 0

    # gabor defaults (reference: gabor.h:52-66, nyxus.py:90-103)
    gabor_kersize: int = 16
    gabor_gamma: float = 0.1
    gabor_sig2lam: float = 0.8
    gabor_f0: float = 0.1
    gabor_thold: float = 0.025
    gabor_thetas: Tuple[float, ...] = (0, 45, 90, 135)
    gabor_freqs: Tuple[float, ...] = (4, 16, 32, 64)

    # float-image quantization (reference: slideprops.h:48-66)
    fpimg_active: bool = False
    fpimg_target_dr: float = 1e4
    fpimg_min: float = 0.0
    fpimg_max: float = 1.0
    preserve_hu: bool = False

    # anisotropy (reference: cli_anisotropy_options)
    aniso_x: float = 1.0
    aniso_y: float = 1.0
    aniso_z: float = 1.0

    # physical pixel calibration.  The reference gates micron-unit outputs on
    # xyRes > 0 (environment.cpp:298, basic_morphology.cpp:23-28); the CLI
    # sets it via --pixelsPerCentimeter (pixelSizeUm = 1e4 / xyRes,
    # environment.cpp:904) while the Python API sets BOTH xyRes and
    # pixelSizeUm to pixels_per_micron (new_bindings_py.cpp:93).
    pixels_per_micron: float = 1.0
    xyres: float = 0.0

    @property
    def aniso_customized(self) -> bool:
        """True when x/y anisotropy is non-default (AnisotropyOptions
        set_aniso_* near_eq gate, cli_anisotropy_options.h:24-27)."""
        eps = 1.1920929e-07  # FLT_EPSILON (helpers.h:484-487)
        return abs(self.aniso_x - 1.0) > eps or abs(self.aniso_y - 1.0) > eps

    # compute precision: 'f32' (production) or 'f64' (reference parity;
    # needs JAX's 64-bit mode)
    precision: str = "f32"

    # batching
    ram_limit_mb: int = 4096       # HBM budget per ROI batch
    n_feature_calc_threads: int = 4

    def texture_greydepth(self, family: str) -> int:
        v = getattr(self, family + "_greydepth", None)
        return self.coarse_gray_depth if v is None else v

    def texture_greydepth3(self, family: str) -> int:
        """3D family grey depth: the d3_* metaparam slot, else the
        reference's per-family DEFAULT.  env_features.cpp:712-736 only
        seeds GLCM_GREYDEPTH with the global coarse depth; the
        GLRLM/GLSZM/GLDM/NGTDM slots stay zero-initialized, and greyInfo=0
        selects the no-binning (raw-intensity) path in bin_intensities_3d
        (texture_feature.h:52-76) with background=0 excluded."""
        v = getattr(self, "d3_" + family + "_greydepth", None)
        if v is not None:
            return v
        return self.coarse_gray_depth if family == "glcm" else 0

    @property
    def glcm3_offset(self) -> int:
        return self.glcm_offset if self.d3_glcm_offset is None \
            else self.d3_glcm_offset

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = EngineConfig()
