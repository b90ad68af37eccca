"""repro_torch: the PyTorch/CUDA port of the SU3_Bench package ``repro``.

Same module layout as ``repro`` (``core/su3/{layouts,registry,variants,plan,
engine}``, ``kernels/{ref,su3_matmul,su3_stencil,flash_attention,ops}``,
``core/roofline``, ``configs``, ``serve/su3``, and the LM serving path
``models/{common,ffn,attention,transformer,registry}``, ``serve/engine``,
``launch/serve``), so each module's counterpart is found by name.  The port
imports neither ``jax`` nor ``repro``; the kernels are the hand-written CUDA
sources under ``csrc/``, built with ``nvcc`` at first use.  Entry points run
on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
