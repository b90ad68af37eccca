"""repro_torch: the PyTorch/CUDA port of the SU3_Bench package ``repro``.

Same module layout as ``repro`` (``core/su3/{layouts,registry,variants,plan,
engine}``, ``kernels/{ref,su3_matmul,ops}``, ``core/roofline``,
``configs/su3_bench``), so each module's counterpart is found by name.  The
port imports neither ``jax`` nor ``repro``; the multiply kernel is the
hand-written CUDA source ``csrc/su3_mult.cu``, built with ``nvcc`` at first
use.  Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
