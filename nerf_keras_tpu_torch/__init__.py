"""nerf_keras_tpu_torch — the PyTorch + CUDA port of ``nerf_keras_tpu``.

The JAX package beside it is the reference: every module here keeps the
name of its JAX counterpart, its public functions keep the JAX layouts,
and the tests hold each one against the JAX function on the same inputs.

This package serves a trained NeRF checkpoint (the float coarse+fine
render path with its full maps, and the proposal render) and trains both
the coarse+fine parity step and the online proposal sampler
(``engine/step.py``, ``engine/trainer.py``).  Its kernels are the ray
megakernel K1 (``csrc/fused_render_fwd.cu``: positions, Fourier encoding,
the MLP and alpha compositing per ray tile, with training residuals), its
backward K2 (``csrc/fused_render_bwd.cu``), both behind
``ops/kernels/fused_render.py``, and the MLP kernel over encodings K5
(``csrc/fused_mlp_fwd.cu``, ``csrc/fused_mlp_bwd.cu``) behind
``ops/kernels/fused_mlp.py``.

The port imports nothing of the JAX package: ``NeRFConfig`` and its JSON
helpers are the port's own copy (``nerf_keras_tpu_torch/config.py``).
Entry points run on the card; the CPU only when the caller asks for it.
"""

__version__ = "0.1.0"

from nerf_keras_tpu_torch.config import NeRFConfig, load_config

__all__ = ["NeRFConfig", "load_config", "__version__"]
