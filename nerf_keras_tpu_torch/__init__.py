"""nerf_keras_tpu_torch — the PyTorch + CUDA port of ``nerf_keras_tpu``.

The JAX package beside it is the reference: every module here keeps the
name of its JAX counterpart, its public functions keep the JAX layouts,
and the tests hold each one against the JAX function on the same inputs.

This package serves a trained NeRF checkpoint (the float coarse+fine
render path, and the proposal render) and trains with the online
proposal sampler (``engine/step.py``, ``engine/trainer.py``).  Its
kernels (``ops/kernels/fused_render.py``) are the ray megakernel K1
(``csrc/fused_render_fwd.cu``: positions, Fourier encoding, the MLP and
alpha compositing per ray tile, with training residuals) and its backward
K2 (``csrc/fused_render_bwd.cu``).  The coarse+fine training step is
later work.

The config schema stays single-sourced: ``NeRFConfig`` and its JSON
helpers come from ``nerf_keras_tpu.config``, which is stdlib-only.  No
other module of the JAX package is imported here.
"""

__version__ = "0.1.0"

from nerf_keras_tpu.config import NeRFConfig, load_config

__all__ = ["NeRFConfig", "load_config", "__version__"]
