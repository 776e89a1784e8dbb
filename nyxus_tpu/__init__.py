"""nyxus_tpu: a JAX/XLA scalable image feature-extraction framework with the
capabilities of PolusAI/nyxus.

Computes engineered intensity / texture / morphology / image-quality features
per segmented ROI or whole slide, batched over padded ROI tensors on the
accelerator JAX exposes (a GPU in production), sharded over device meshes for
scale-out.
"""

import os as _os

# persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset: a
# fixed path, because the cache directory is part of each entry's key
_DEFAULT_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _setup_compile_cache():
    """Persistent XLA compilation cache: bucket-shape kernels compile once per
    machine, not once per process.  A set ``JAX_COMPILATION_CACHE_DIR``
    (which JAX reads itself) names the directory; otherwise it is
    ``<checkout>/.jax_cache``."""
    import jax
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", _DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)


_setup_compile_cache()

from .api import ImageQuality, Nyxus, Nyxus3D
from .config import EngineConfig
from .functions import get_gpu_properties, gpu_is_available
from .nested import Nested

__version__ = "0.1.0"

__all__ = ["Nyxus", "Nyxus3D", "ImageQuality", "Nested", "EngineConfig",
           "gpu_is_available", "get_gpu_properties", "__version__"]
