"""Where K2's gradients at 8x512 part from the plain path's, on one card.

    python -m nerf_keras_tpu_torch.exp_wide_numerics [--out FILE]

The yardstick is independent of both bf16 paths: the MLP with the kernels'
roundings (bf16 encodings, weights, post-ReLU activations, the feature
before the concat and each dPre where it is a product's operand: the JAX
kernel's, ``fused_mlp._mlp_bwd_tile``) and every sum, the compositing and
its VJP in float64 (``sr64_forward``/``sr64_backward``).  Cases: the
``wide`` phase's model after its 10 training steps (trained here as
``chip_smoke.phase_wide`` trains it) and before them, on ``chip_smoke``'s
one-tile rays (1 x 64); the seeded 8x512 model of
``tests/test_torch_cuda.py``'s wide tests on 3 x 100 and 41 x 100 rays, and
the same seed at 8x256 on 3 x 100.  For each, per-leaf relative L2 (the
largest, and ``trunk.0.weight``'s): K2 against the plain path (what the
smoke gates), K2 and the plain path against the yardstick, K2 fed the
plain path's predictions, K5's backward and the plain MLP's given one
cotangent (the MLP alone, no compositing), and the ReLU signs of K2's
recomputed activations (from its workspace) that differ from the
yardstick's, layer by layer.  One JSON line per case (``NUMERICS``).
"""

from __future__ import annotations

import argparse
import copy
import json

import torch

D64 = torch.float64


def bf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to(torch.bfloat16).to(D64)


def rel(a: torch.Tensor, c: torch.Tensor) -> float:
    a, c = a.detach().double(), c.detach().double()
    return float(torch.linalg.vector_norm(a - c) / torch.linalg.vector_norm(c).clamp_min(1e-300))


def sr64_forward(mlp, xe, de):
    """Raw predictions (N, 4) float64 and the state for sr64_backward."""
    from nerf_keras_tpu_torch.models.mlp import is_skip
    W = lambda layer: bf(layer.weight)  # noqa: E731
    B = lambda layer: layer.bias.detach().to(D64)  # noqa: E731
    xe, de = bf(xe), bf(de)
    x, acts, masks = xe, [], []
    for i, layer in enumerate(mlp.trunk):
        acts.append(x)
        h = bf(torch.relu(x @ W(layer).T + B(layer)))
        masks.append(h > 0)
        x = torch.cat([h, xe], -1) if is_skip(i, mlp.skip_layer) else h
    sigma = x @ W(mlp.sigma).T + B(mlp.sigma)
    fin = torch.cat([bf(x @ W(mlp.feature).T + B(mlp.feature)), de], -1)
    h2 = bf(torch.relu(fin @ W(mlp.branch).T + B(mlp.branch)))
    return torch.cat([h2 @ W(mlp.rgb).T + B(mlp.rgb), sigma], -1), (acts, masks, x, fin, h2)


def sr64_backward(mlp, state, g) -> list[torch.Tensor]:
    """The parameter gradients (``mlp.parameters()`` order) for the
    predictions' cotangent ``g``."""
    acts, masks, x_last, fin, h2 = state
    W = lambda layer: bf(layer.weight)  # noqa: E731
    g = g.to(D64)
    hid = mlp.hidden_dim
    out = {}
    drgb = g[:, :3]
    out["rgb"] = (bf(drgb).T @ h2, drgb.sum(0))
    dh2 = (bf(drgb) @ W(mlp.rgb)) * (h2 > 0)
    out["branch"] = (bf(dh2).T @ fin, dh2.sum(0))
    dfeat, dsig = (bf(dh2) @ W(mlp.branch))[:, :hid], g[:, 3:4]
    out["feature"] = (bf(dfeat).T @ x_last, dfeat.sum(0))
    out["sigma"] = (bf(dsig).T @ x_last, dsig.sum(0))
    dx = bf(dfeat) @ W(mlp.feature) + bf(dsig) @ W(mlp.sigma)
    for i in reversed(range(mlp.num_layers)):
        dpre = dx[:, :hid] * masks[i]
        out[f"trunk.{i}"] = (bf(dpre).T @ acts[i], dpre.sum(0))
        if i > 0:
            dx = bf(dpre) @ W(mlp.trunk[i])
    by_name = {f"{k}.{w}": v for k, (gw, gb) in out.items()
               for w, v in (("weight", gw), ("bias", gb))}
    return [by_name[n] for n, _ in mlp.named_parameters()]


def dpreds(preds, t, g_rgb, g_w, dtype):
    """The compositing VJP (``ops/volume.py``'s formula) in ``dtype``."""
    p = preds.detach().to(dtype).requires_grad_(True)
    with torch.enable_grad():
        tt = t.to(dtype)
        delta = torch.diff(tt, dim=-1)
        delta = torch.cat([delta, torch.full_like(delta[..., :1], 1e10)], -1)
        alpha = 1.0 - torch.exp(-torch.relu(p[..., 3]) * delta)
        trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
        w = alpha * trans
        rgb = (w[..., None] * torch.sigmoid(p[..., :3])).sum(-2)
        return torch.autograd.grad([rgb, w], [p], [g_rgb.to(dtype), g_w.to(dtype)])[0]


def leaves(mlp, got, want) -> dict:
    names = [n for n, _ in mlp.named_parameters()]
    r = [rel(a, c) for a, c in zip(got, want)]
    return {"max": max(r), "worst": names[r.index(max(r))],
            "trunk0": r[names.index("trunk.0.weight")]}


def case(mlp, o, d, t, g_rgb, g_w) -> dict:
    from nerf_keras_tpu_torch.ops.encoding import encode_position
    from nerf_keras_tpu_torch.ops.kernels import fused_mlp as k5
    from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
    b, s = t.shape
    n, hid = b * s, mlp.hidden_dim
    with torch.no_grad():
        _, _, x_res, preds_k = k1.launch_k1(mlp, o, d, t, mlp.l_xyz, mlp.l_dir, train=True)
        de = encode_position(d, mlp.l_dir)[:, None, :].expand(b, s, -1).reshape(n, -1)
        de = de.to(torch.bfloat16).contiguous()
        xe = encode_position(o[:, None, :] + d[:, None, :] * t[..., None], mlp.l_xyz)
        preds_p = mlp(xe.reshape(n, -1), de.float())
        preds_s, state = sr64_forward(mlp, x_res, de)
        kern = k1.launch_k2(mlp, x_res, d, t, preds_k, g_rgb, g_w, mlp.l_xyz, mlp.l_dir)
        fed = k1.launch_k2(mlp, x_res, d, t, preds_p.contiguous(), g_rgb, g_w,
                           mlp.l_xyz, mlp.l_dir)
    plain = k1.render_rays_reference_vjp(mlp, o, d, t, g_rgb, g_w)
    g64 = dpreds(preds_s.view(b, s, 4), t, g_rgb, g_w, D64).reshape(n, 4)
    yard = sr64_backward(mlp, state, g64)
    g5 = g64.float().contiguous()
    with torch.no_grad():
        fwd, ws = k1.launch_rows(k1._ROWS_K5, mlp, None, None, None, None, mlp.l_xyz,
                                 mlp.l_dir, x_res=x_res.contiguous(), d_enc=de, g=g5)
        k5_grads = k1.unpack_grads(mlp, fwd, ws.layout, ws.dw, ws.db)
    # K2's recomputed activations (layer i + 1's stored input) against the
    # yardstick's ReLU signs.
    tile_rows = k1.SPLIT_ROWS if k1.kernel_width(hid) > k1.SPLIT_ABOVE else 128
    rows = -(-n // tile_rows) * tile_rows
    flips = []
    for i in range(mlp.num_layers):
        a_col, a_w = (int(v) for v in ws.layout[i + 1][:2])
        tile = ws.ws_a[rows * a_col:rows * a_col + rows * a_w].view(rows // 64, a_w // 8, 64, 8)
        h = tile.permute(0, 2, 1, 3).reshape(rows, a_w)[:n, :hid]
        flips.append(int(((h > 0) != state[1][i]).sum()))
    p5 = k5.apply_nerf_mlp_reference_vjp(mlp, x_res.contiguous(), de, g5, False)[0]
    return {"B": b, "S": s, "hidden": hid,
            "k2_vs_plain": leaves(mlp, kern, plain),
            "k2_vs_yardstick": leaves(mlp, kern, yard),
            "plain_vs_yardstick": leaves(mlp, plain, yard),
            "k2_fed_plain_preds_vs_plain": leaves(mlp, fed, plain),
            "mlp_alone": {"k5_vs_yardstick": leaves(mlp, k5_grads, yard),
                          "plain_vs_yardstick": leaves(mlp, p5, yard)},
            "preds": {"k1_vs_yardstick": rel(preds_k, preds_s),
                      "plain_vs_yardstick": rel(preds_p, preds_s)},
            "relu_flips_by_layer": flips}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = parser.parse_args()
    import chip_smoke as cs
    from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
    from nerf_keras_tpu_torch.runtime import card_string, configure_numerics
    configure_numerics()
    dev = torch.device("cuda")
    out = {"card": card_string()}
    cfg = cs.wide_config()
    trainer = cs.Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(5))
    init = copy.deepcopy(trainer.params["fine"])
    batch = trainer.put_batch(cs.bench_batch(cfg.batch_size))
    cs._grads_kernel_vs_plain(cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=7)
    cs._train_steps(trainer, batch, cs.WIDE_STEPS, dict(cs.ZERO, k1_train=2, k2=2))
    cases = {}
    for tag, mlp in (("trained_1x64", trainer.params["fine"]), ("init_1x64", init)):
        x = cs._suite_inputs(mlp, 1, 64, seed=13)
        cases[tag] = (mlp, x["o"], x["d"], x["t"], x["g_rgb"], x["g_w"])
    for hidden, b in ((512, 3), (512, 41), (256, 3)):
        gen = torch.Generator().manual_seed(35)
        mlp = randomize_biases_(NeRFMLP(num_layers=8, hidden_dim=hidden, skip_layer=4,
                                        generator=gen, device=dev), gen)
        g = torch.Generator().manual_seed(11)
        o = (torch.randn((b, 3), generator=g) * 0.3 + torch.tensor([0.0, 0.0, 4.0])).to(dev)
        d = torch.randn((b, 3), generator=g).to(dev)
        t = torch.sort(torch.rand((b, 100), generator=g) * 4.0 + 2.0, dim=-1).values
        g = torch.Generator().manual_seed(12)
        cases[f"seed35_h{hidden}_{b}x100"] = (
            mlp, o, d, t.to(dev).contiguous(), torch.randn((b, 3), generator=g).to(dev),
            torch.randn((b, 100), generator=g).to(dev))
    for tag, args_ in cases.items():
        out[tag] = case(*args_)
        print("NUMERICS " + json.dumps({tag: out[tag]}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
