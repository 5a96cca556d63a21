"""Where K2's gradients at 8x512 part from the plain path's, on one card.

    python -m nerf_keras_tpu_torch.exp_wide_numerics [--out FILE] [--trained FILE]
    python -m nerf_keras_tpu_torch.exp_wide_numerics --sweep N [--out FILE]

The yardstick is independent of both bf16 paths: the MLP with the kernels'
roundings (bf16 encodings, weights, post-ReLU activations, the feature
before the concat and each dPre where it is a product's operand: the JAX
kernel's, ``fused_mlp._mlp_bwd_tile``) and every sum, the compositing and
its VJP in float64 (``sr64_forward``/``sr64_backward``).  Cases: the
``wide`` phase's model after its 10 training steps (trained here as
``chip_smoke.phase_wide`` trains it, or loaded from ``--trained`` where that
file exists, else written there: so that two trees measure one trained
model) and before them, on ``chip_smoke``'s one-tile rays (1 x 64); the
seeded 8x512 model of ``tests/test_torch_cuda.py``'s wide tests on 3 x 100
and 41 x 100 rays, the same seed at 8x256 and 8x1024 on 3 x 100, and
``test_wide_k2_matches_plain_vjp``'s 8x320 case without the weights
cotangent (333 x 100).  For each, per-leaf relative L2 (the
largest, and ``trunk.0.weight``'s): K2 against the plain path (what the
smoke gates), K2 and the plain path against the yardstick, K2 fed the
plain path's predictions, K5's backward and the plain MLP's given one
cotangent (the MLP alone, no compositing), and the ReLU signs of K2's
recomputed activations (from its workspace) that differ from the
yardstick's, layer by layer, and ``sums``: K1's float32 sigma and rgb
logits against float64 sums over K2's recomputed head and rgb inputs (the
last trunk activation, the branch's), beside float32 sums of the same bf16
operands with round-to-nearest adds (``torch.matmul`` in float32, TF32
off).  Errors are in units of 2^-24 times the sum of |terms|: a value
far above the sum's depth means K1's activations are not K2's; ``bias`` is
the mean error toward the exact value's sign (negative: toward zero), and
``toward_zero`` the share of the nonzero errors that point to zero.  One
JSON line per case (``NUMERICS``).

``--sweep N`` measures only the seeded cases, each on N seeds (model,
rays and cotangents; the first are the cases above), and prints one
``SWEEP`` line per case and seed with its largest leaf distances (K2 from
the plain path and K2 and the plain path from the yardstick) and its
flipped ReLU signs: whether a kernel's sums stay nearer the yardstick than
another's over many draws, not on one.
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
    """The compositing VJP (``ops/volume.py``'s formula) in ``dtype``
    (``g_w`` None: no weights cotangent)."""
    g_w = torch.zeros_like(t) if g_w is None else g_w
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


def ws_tile(flat: torch.Tensor, rows: int, col: int, width: int) -> torch.Tensor:
    """A layer's (rows, width) tile of the dW workspace (64-row stages of
    8-column strips: nerf_wgmlp.cuh, store_ws)."""
    blk = flat[rows * col:rows * col + rows * width].view(rows // 64, width // 8, 64, 8)
    return blk.permute(0, 2, 1, 3).reshape(rows, width)


def err_stats(got: torch.Tensor, exact: torch.Tensor, unit: torch.Tensor) -> dict:
    e = (got.double() - exact) * torch.sign(exact)
    nz = e != 0
    return {"max": float((e.abs() / unit).max()), "bias": float((e / unit).mean()),
            "toward_zero": float((e[nz] < 0).double().mean()) if bool(nz.any()) else 0.0}


def sums(mlp, ws, rows: int, n: int, preds_k: torch.Tensor) -> dict:
    """K1's sigma and rgb logits (float32, from K1's activations) against
    float64 and float32 round-to-nearest sums over K2's recomputed inputs."""
    hid, L = mlp.hidden_dim, mlp.num_layers
    out = {}
    for name, li, layer, cols, k in (("sigma", L, mlp.sigma, [3], hid),
                                     ("rgb", L + 2, mlp.rgb, [0, 1, 2], hid // 2)):
        a_col, a_w = (int(v) for v in ws.layout[li][:2])
        h = ws_tile(ws.ws_a, rows, a_col, a_w)[:n, :k].double()
        w, b = bf(layer.weight), layer.bias.detach().double()
        exact = h @ w.T + b
        unit = (h.abs() @ w.abs().T + b.abs()) * 2.0 ** -24
        f32 = h.float() @ w.float().T + b.float()
        kern = preds_k[:, cols]
        out[name] = {"k": k, "kernel": err_stats(kern, exact, unit),
                     "f32_nearest": err_stats(f32, exact, unit),
                     "kernel_equals_f32_nearest": float((kern == f32).double().mean())}
    return out


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
        h = ws_tile(ws.ws_a, rows, a_col, a_w)[:n, :hid]
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
            "relu_flips_by_layer": flips,
            "sums": sums(mlp, ws, rows, n, preds_k)}


def seeded(hidden: int, seed: int, b: int, ray_seed: int, cot_seed: int, with_gw: bool = True):
    """``tests/test_torch_cuda.py``'s seeded 8 x ``hidden`` model
    (``_wide_mlp``) on ``b`` rays of 100 samples (``_rays``) with a seeded
    cotangent: ``(mlp, o, d, t, g_rgb, g_w)`` on the card."""
    from nerf_keras_tpu_torch.models.mlp import NeRFMLP, randomize_biases_
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    mlp = randomize_biases_(NeRFMLP(num_layers=8, hidden_dim=hidden, skip_layer=4,
                                    generator=gen, device=dev), gen)
    g = torch.Generator().manual_seed(ray_seed)
    o = (torch.randn((b, 3), generator=g) * 0.3 + torch.tensor([0.0, 0.0, 4.0])).to(dev)
    d = torch.randn((b, 3), generator=g).to(dev)
    t = torch.sort(torch.rand((b, 100), generator=g) * 4.0 + 2.0, dim=-1).values
    g = torch.Generator().manual_seed(cot_seed)
    g_rgb = torch.randn((b, 3), generator=g).to(dev)
    g_w = torch.randn((b, 100), generator=g).to(dev) if with_gw else None
    return mlp, o, d, t.to(dev).contiguous(), g_rgb, g_w


# The seeded cases: (tag, hidden, rays, model seed, ray seed, cotangent
# seed, with g_w); draw m of a sweep adds m to the model seed and 2m to the
# others.
SEEDED = (("h512_3x100", 512, 3, 35, 11, 12, True),
          ("h512_41x100", 512, 41, 35, 11, 12, True),
          ("h256_3x100", 256, 3, 35, 11, 12, True),
          ("h1024_3x100", 1024, 3, 35, 11, 12, True),
          ("h320_333x100_no_gw", 320, 333, 32, 5, 6, False))


def sweep(draws: int, out: dict) -> None:
    for tag, hidden, b, seed, ray_seed, cot_seed, with_gw in SEEDED:
        for m in range(draws):
            args = seeded(hidden, seed + m, b, ray_seed + 2 * m, cot_seed + 2 * m, with_gw)
            try:
                r = case(*args)
                rec = {"k2_vs_plain": r["k2_vs_plain"],
                       "k2_vs_yardstick": r["k2_vs_yardstick"]["max"],
                       "plain_vs_yardstick": r["plain_vs_yardstick"]["max"],
                       "relu_flips": sum(r["relu_flips_by_layer"])}
            except NotImplementedError as err:  # a tree whose kernels refuse the width
                rec = {"refused": str(err)}
            out.setdefault("sweep", {}).setdefault(tag, []).append(rec)
            print("SWEEP " + json.dumps({"case": tag, "draw": m, **rec}), flush=True)
            del args
            torch.cuda.empty_cache()


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the records to this JSON file")
    parser.add_argument("--trained", default=None,
                        help="the trained case's weights: loaded if the file exists, else "
                             "trained and written there")
    parser.add_argument("--sweep", type=int, default=0,
                        help="only the seeded cases, each on this many seeds")
    args = parser.parse_args()
    import os
    import chip_smoke as cs
    from nerf_keras_tpu_torch.models.mlp import randomize_biases_
    from nerf_keras_tpu_torch.runtime import card_string, configure_numerics
    configure_numerics()
    out = {"card": card_string()}
    if args.sweep:
        sweep(args.sweep, out)
        if args.out:
            with open(args.out, "w") as fh:
                json.dump(out, fh, indent=1)
        return
    cfg = cs.wide_config()
    trainer = cs.Trainer(cfg, 2.0, 6.0, device="cuda")
    for m in trainer.params.values():
        randomize_biases_(m, torch.Generator().manual_seed(5))
    init = copy.deepcopy(trainer.params["fine"])
    if args.trained and os.path.exists(args.trained):
        trainer.params["fine"].load_state_dict(torch.load(args.trained))
    else:
        batch = trainer.put_batch(cs.bench_batch(cfg.batch_size))
        cs._grads_kernel_vs_plain(cfg, trainer, batch, [(cfg.batch_size, cfg.ns_fine)], seed=7)
        cs._train_steps(trainer, batch, cs.WIDE_STEPS, dict(cs.ZERO, k1_train=2, k2=2))
        if args.trained:
            torch.save(trainer.params["fine"].state_dict(), args.trained)
    cases = {}
    for tag, mlp in (("trained_1x64", trainer.params["fine"]), ("init_1x64", init)):
        x = cs._suite_inputs(mlp, 1, 64, seed=13)
        cases[tag] = (mlp, x["o"], x["d"], x["t"], x["g_rgb"], x["g_w"])
    for tag, hidden, b, seed, ray_seed, cot_seed, with_gw in SEEDED:
        cases[f"seed{seed}_{tag}"] = seeded(hidden, seed, b, ray_seed, cot_seed, with_gw)
    for tag, args_ in cases.items():
        try:
            out[tag] = case(*args_)
        except NotImplementedError as err:  # a tree whose kernels refuse the width
            out[tag] = {"refused": str(err)}
        print("NUMERICS " + json.dumps({tag: out[tag]}), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
