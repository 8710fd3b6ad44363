"""divans_tpu_torch: the PyTorch and CUDA port of divans_tpu.

A second package beside divans_tpu (the JAX reference, which it imports
nothing of).  Host stages run in the repo's native C++ library (or,
where it cannot be built or loaded, in the reference's Python routes:
native.py); the device stages run on an NVIDIA H100 through
hand-written CUDA kernels (csrc/) with plain PyTorch around them.  Both entry points, compress
and decompress, run on "cuda" unless the caller passes device="cpu",
where each kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"

from .options import DivansOptions  # noqa: F401
from .api import compress, decompress  # noqa: F401
