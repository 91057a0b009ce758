"""PyTorch/CUDA port of ddsp_tpu: multi-stream DDSP serving on an NVIDIA GPU.

The JAX package ``ddsp_tpu`` is the reference; this package never imports
it or jax.  Its serving entry points (``runtime.multistream.MultiStreamServer``,
``runtime.server.StreamServer`` and its CLI) run on CUDA unless the caller
asks for ``device="cpu"``.
"""

from ddsp_tpu_torch.config import Config

__all__ = ["Config"]
