"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (sources under ``nerf_keras_tpu_torch/csrc``)."""
