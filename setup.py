"""Build hook: compile the native classical layer (native/qc_classical.cpp)
into the package as a plain shared library.

The library is loaded with ctypes (algorithms/_native.py), not imported, so
it is NOT a Python extension module — we only borrow setuptools' build_ext
machinery for the compiler invocation and wheel placement.  Builds degrade
gracefully: if no C++ toolchain is available the wheel ships without the
library and the pure-Python number_theory implementations take over
(the same fallback the dev layout uses)."""

import os

from setuptools import setup
from setuptools.command.build_ext import build_ext
from setuptools.extension import Extension


class BuildSharedLib(build_ext):
    def build_extension(self, ext):
        try:
            super().build_extension(ext)
        except Exception as exc:  # missing compiler: ship pure-Python
            self.warn(f"native classical layer skipped ({exc}); "
                      "pure-Python fallback will be used")

    def get_ext_filename(self, fullname):
        # Plain .so name (no CPython ABI suffix): ctypes.CDLL target.
        return os.path.join(*fullname.split(".")) + ".so"

    def get_export_symbols(self, ext):
        return ext.export_symbols  # no PyInit_* symbol: not an import module


setup(
    ext_modules=[
        Extension(
            "quantumcomputer.libqc_classical",
            sources=["native/qc_classical.cpp"],
            language="c++",
            extra_compile_args=["-O2", "-std=c++17", "-fPIC"],
        )
    ],
    cmdclass={"build_ext": BuildSharedLib},
)
