"""Build hook: compile the native runtime into the wheel.

The package works from a plain source checkout too (nyxus_tpu.native
compiles on first use); this hook pre-bakes the libraries of
``nyxus_tpu.native._LIBS`` for the build host.  A library whose host stamp
does not match the CPU that loads it is rebuilt there on first use
(reference analog: the CMake + setup.py + cibuildwheel stack,
/root/reference/CMakeLists.txt:425-442, setup.py)."""

import importlib.util
import os

from setuptools import setup
from setuptools.command.build_py import build_py


def _native_module():
    # load the build helpers without importing the package (and JAX)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nyxus_tpu", "native", "__init__.py")
    spec = importlib.util.spec_from_file_location("_nyx_native_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class BuildWithNative(build_py):
    def run(self):
        super().run()
        native = _native_module()
        out_dir = os.path.join(self.build_lib, "nyxus_tpu", "native",
                               "_build")
        for name in native._LIBS:
            try:
                print("built", native.build(name, out_dir))
            except RuntimeError as e:  # e.g. no libtiff: built on first use
                print("WARNING: native build of %s skipped (%s)" % (name, e))


setup(cmdclass={"build_py": BuildWithNative})
