"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (sources under ``nerf_keras_tpu_torch/csrc``)."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count in this process."""
    from nerf_keras_tpu_torch.ops.kernels import fused_f32 as f32
    from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
    from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
    from nerf_keras_tpu_torch.ops.kernels import pdf_union as k7
    from nerf_keras_tpu_torch.ops.kernels import quant_render as k4

    return {"k1_fwd": k1.launches - k1.train_launches, "k1_train": k1.train_launches,
            "k2": k1.bwd_launches, "k3": k1.recompute_launches, "k5_fwd": k5.launches,
            "k5_bwd": k5.bwd_launches, "k4": k4.launches, "k6_fwd": k1.enc_launches,
            "k6_bwd": k1.enc_bwd_launches, "k7": k7.launches,
            # the float32 kernels (csrc/fused_render_f32.cu)
            "k1_fwd_f32": f32.launches - f32.train_launches,
            "k1_train_f32": f32.train_launches, "k2_f32": f32.bwd_launches,
            "k3_f32": f32.recompute_launches, "k5_fwd_f32": f32.mlp_launches,
            "k5_bwd_f32": f32.mlp_bwd_launches, "k6_fwd_f32": f32.enc_launches,
            "k6_bwd_f32": f32.enc_bwd_launches}
