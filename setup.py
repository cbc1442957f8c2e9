"""Install script (plain setuptools, like the reference's setup.py)."""

import os

from setuptools import setup

try:
    from setuptools import Extension
    from setuptools.command.build_ext import build_ext

    class BuildMesher(build_ext):
        """Build the C++ mesher core alongside the package (optional —
        the Python fallback is used when the shared library is absent)."""

        def run(self):
            src = os.path.join("raft_tpu", "native")
            if os.path.exists(os.path.join(src, "Makefile")):
                os.system(f"make -C {src}")
            super().run()

    cmdclass = {"build_ext": BuildMesher}
except ImportError:  # pragma: no cover
    cmdclass = {}

setup(
    name="raft-tpu",
    version="0.1.0",
    description=(
        "TPU-native frequency-domain dynamics framework for floating "
        "offshore wind turbines (RAFT-capability, JAX/XLA core)"
    ),
    packages=["raft_tpu", "raft_tpu.io", "raft_tpu.utils",
              "raft_tpu_torch", "raft_tpu_torch.io", "raft_tpu_torch.utils",
              "raft_tpu_torch.kernels", "raft_tpu_torch.serve",
              "raft_tpu_torch.grad", "raft_tpu_torch.obs"],
    package_data={"raft_tpu": ["native/*.cpp", "native/Makefile"],
                  "raft_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                     "data/*.npz"]},
    python_requires=">=3.9",
    # numpy>=2.0: np.trapezoid (raft_tpu/fatigue.py, tests)
    install_requires=["numpy>=2.0", "scipy", "pyyaml", "jax"],
    extras_require={"viz": ["matplotlib"], "omdao": ["openmdao"]},
    cmdclass=cmdclass,
)
