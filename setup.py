"""Wheel packaging — the reference's python/setup.py role (cmake-driven
there; here setuptools + the native Makefile). ``tools/ci.sh wheel``
drives it; the native .so files ship inside paddle_tpu/native/."""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        native = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "paddle_tpu", "native")
        try:
            subprocess.run(["make", "-C", native, "-s"], check=True)
        except (OSError, subprocess.CalledProcessError) as e:
            print(f"warning: native build skipped ({e}); the wrapper "
                  "rebuilds on demand at import")
        super().run()


setup(
    name="paddle_tpu",
    version="0.3.0",
    description="TPU-native rebuild of the PaddlePaddle Fluid capability "
                "surface on JAX/XLA/Pallas",
    packages=find_packages(include=["paddle_tpu", "paddle_tpu.*",
                                    "paddle_tpu_torch",
                                    "paddle_tpu_torch.*"]),
    package_data={"paddle_tpu.native": ["*.so", "Makefile", "src/*"],
                  "paddle_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    cmdclass={"build_py": BuildWithNative},
)
