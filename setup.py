"""Package build for horovod_tpu.

Analog of the reference's setup machinery
(reference: setup.py:35-120 — CMake-built native extensions per framework
plus the ``horovodrun`` console entry point). The native coordination core
here is a plain shared library built with make (horovod_tpu/core/build.py
triggers it lazily at first use, so a source install works without a
compile step); ``build_native`` forces the compile at install time.
"""

import subprocess
import sys
from pathlib import Path

from setuptools import Command, find_packages, setup


class build_native(Command):
    """Compile the C++ coordination core (make -C horovod_tpu/core/src)."""

    description = "build the native coordination core"
    user_options = []

    def initialize_options(self):
        pass

    def finalize_options(self):
        pass

    def run(self):
        src = Path(__file__).parent / "horovod_tpu" / "core" / "src"
        subprocess.check_call(["make", "-C", str(src)])


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native distributed training framework "
                 "(Horovod-capability rebuild on JAX/XLA)"),
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={"horovod_tpu.core": ["src/*.cc", "src/*.h",
                                       "src/Makefile"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "flax", "optax"],
    extras_require={
        "torch": ["torch"],
        "tensorflow": ["tensorflow"],
        "spark": ["pyspark", "pandas", "pyarrow"],
        "ray": ["ray"],
    },
    entry_points={
        "console_scripts": [
            "hvdrun = horovod_tpu.runner.launch:main",
            "horovodrun = horovod_tpu.runner.launch:main",
        ],
    },
    cmdclass={"build_native": build_native},
)
