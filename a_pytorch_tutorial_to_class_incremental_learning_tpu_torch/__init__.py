"""PyTorch/CUDA port of the class-incremental learning framework.

The second package beside the JAX one: the same WA protocol (head growth,
CE + λ·KD against a frozen teacher, weight alignment, herding rehearsal,
per-slice evaluation) on PyTorch, with the masked cross-entropy of the
train step as hand-written CUDA C++ kernels for the H100.  It imports
neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .config import CilConfig  # noqa: F401
