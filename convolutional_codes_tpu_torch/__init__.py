"""PyTorch/CUDA port of the convolutional-code Monte-Carlo simulator.

A second package beside ``convolutional_codes_tpu`` (the JAX/Pallas
reference).  It keeps that package's layout (``ops/``, ``parallel/``,
``sim/``, ``utils/``) and public function names, and runs on one NVIDIA
H100: plain tensor code is PyTorch, and every Pallas kernel on the ported
path is a hand-written CUDA C++ kernel in ``csrc/`` (built with ``nvcc``
for ``sm_90a`` at first use, bound with ``ctypes``).

The code tables, trellis and compat-parity quirk are not copied: they come
from the reference's pure-numpy ``convolutional_codes_tpu.models`` modules,
which import no JAX.  Nothing else of the reference package is imported.
"""

__version__ = "0.1.0"

from convolutional_codes_tpu.models.codebook import Code, get_code, list_codes, register_code

__all__ = ["Code", "get_code", "register_code", "list_codes", "__version__"]
