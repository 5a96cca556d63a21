"""The dW product's design measurements at hidden 512 and 1024 on one card: patched copies, timed in turn.

    python -m nerf_keras_tpu_torch.exp_dw prepare SRC OUT VARIANT [VARIANT ...]
    python -m nerf_keras_tpu_torch.exp_dw time [--hidden 1024] TREE [TREE ...]

``prepare`` copies the port of the checkout SRC (``nerf_keras_tpu_torch``,
``chip_smoke.py``, ``config``) into ``OUT/<variant>`` for each
variant and applies the variant's text patches.  Make OUT a directory that
``.gitignore`` lists (``_archive/``).  Each variant answers one question
about the dW product of K2's backward at 8x512 or 8x1024 (``nerf_dw.cuh``'s
``mlp_dw_window_kernel``: a persistent walk over the host's units of up
to 128 rows by 256 D columns, ``fused_render.dw_schedule``); the
ablations compute wrong values on purpose:

* ``reuse``: each ring slot filled once, then reused: no workspace read
  after a block's first stages;
* ``noslab``: no partial tile loaded from, added into or written to its
  slab (the products kept: a flag the compiler cannot see skips it);
* ``as_is``: no patch.

``time`` builds every TREE's K1/K2 sources at once, then runs each tree in
a process of its own, in the order given (name a tree twice to
interleave), and prints one JSON line per tree: K2 on ``chip_smoke``'s
8x512 (or ``--hidden 1024``: 8x1024) suite model at B=4096, S=192 (CUDA
events, median of 5), its device ms per kernel (the dW product's in all
and per chunk's launch), the dW launch's blocks, units and parts of 128
columns (the most a block walks against the mean: what an even spread
would take),
the workspace bytes an SM reads from L2 a sample and a K2 (from the
plan) and a digest of K2's gradients; before them, one line per tree of
its dW kernels' ``-Xptxas -v`` report and ptxas's ``wgmma`` notes.
(Where K2's gradients part from the plain path's: ``python -m
nerf_keras_tpu_torch.exp_wide_numerics``.)
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

_DW = "csrc/nerf_dw.cuh"

_REUSE_AT = ("          mbar_wait(&empty[st], ph ^ 1u);\n"
             "          mbar_expect_tx(&full[st], a_bytes + d_bytes);\n"
             "          unsigned char* dst = buf + (size_t)st * kDwWinStage;")


def _skip_copies(at: str, indent: str, count: str) -> str:
    """``at`` with the stage's copies skipped once ``count`` stages were
    filled: the full barrier's arrival alone."""
    wait, expect = at.split("\n", 1)
    return (f"{wait}\n{indent}if ({count}++ >= kDwStages) {{\n"
            f"{indent}  mbar_arrive(&full[st]);\n"
            f"{indent}  if (++st == kDwStages) {{\n{indent}    st = 0;\n{indent}    ph ^= 1u;\n"
            f"{indent}  }}\n{indent}  continue;\n{indent}}}\n{expect}")


VARIANTS = {
    "as_is": [],
    "reuse": [(_DW, "      int st = 0;\n      uint32_t ph = 0;\n      for (int u = u0; u < u1; ++u) {",
               "      int st = 0, nfill = 0;\n      uint32_t ph = 0;\n"
               "      for (int u = u0; u < u1; ++u) {"),
              (_DW, _REUSE_AT, _skip_copies(_REUSE_AT, "          ", "nfill"))],
    "noslab": [(_DW, "      if (r >= a_rows) continue;", "      if (p.nst >= 0) continue;")],
}


def patch_tree(pkg: str, variant: str) -> None:
    """Apply the variant's patches under the package ``pkg``; raises if one
    does not apply."""
    for name, old, new in VARIANTS[variant]:
        path = os.path.join(pkg, name)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise ValueError(f"{variant}: {name} has no single {old[:60]!r}")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))


def prepare(src_root: str, out: str, variants: list[str]) -> None:
    for variant in variants:
        dst = os.path.join(out, variant)
        shutil.rmtree(dst, ignore_errors=True)
        os.makedirs(dst)
        shutil.copytree(os.path.join(src_root, "nerf_keras_tpu_torch"),
                        os.path.join(dst, "nerf_keras_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copytree(os.path.join(src_root, "config"), os.path.join(dst, "config"))
        shutil.copy(os.path.join(src_root, "chip_smoke.py"), dst)
        patch_tree(os.path.join(dst, "nerf_keras_tpu_torch"), variant)


_CHILD = r'''
import hashlib, json, os, re, sys
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build
hidden = int(sys.argv[2])
_build._sources = lambda: [_build.CSRC / "fused_render_fwd.cu",
                           _build.CSRC / f"fused_render_bwd_{hidden}.cu"]
if sys.argv[1] == "build":
    _build.build()
    ptxas, name = [], None
    for ln in _build.build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if found:
            name = found.group(1)
        elif name and "mlp_dw" in name and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{name}: {ln.strip()}")
        if "wgmma" in ln and "mlp_dw" in ln:
            ptxas.append(ln.strip())
    print("DWPTX " + json.dumps({"tree": os.getcwd(), "ptxas": ptxas}), flush=True)
    sys.exit(0)
import chip_smoke as cs
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.runtime import card_string, configure_numerics, cuda_ms
configure_numerics()
dev = torch.device("cuda")
sms = torch.cuda.get_device_properties(dev).multi_processor_count
out = {"tree": os.getcwd(), "card": card_string()}
mlp = cs._suite_mlp(dev, hidden, seed=525)
b, s = 4096, 192
x = cs._suite_inputs(mlp, b, s, seed=525)
k2 = cs._suite_calls(mlp, x)["k2"]
fwd, bwd = k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev)
layout = k1.workspace_layout(fwd, bwd)
bps = k1.DwBuffers.bytes_per_sample(fwd, bwd)
plan = k1.chunk_plan(b, s, bps)
families = cs.K2_STAGES
with torch.no_grad():
    got = k2()
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for g in got:
        h.update(g.detach().float().cpu().numpy().tobytes())
    out["k2_digest"] = h.hexdigest()[:16]
    out["k2_ms"] = cuda_ms(k2, reps=5)
    out["k2_device_ms"] = cs.device_ms_by_kernel(k2, families)
out["chunks"] = len(plan)
out["dw_ms_per_launch"] = out["k2_device_ms"]["dw"] / len(plan)
# The workspace bytes an SM reads from L2, a sample: what each block's
# producer brings each 64-sample stage, over 64, for one sample range.
ws = k1.DwBuffers.allocate(fwd, bwd, -(-plan[0][1] * s // 128) * 128, 1, dev)
nsplit, units = ws.nsplit, getattr(ws, "units", None)
if units is not None:
    lists = k1.dw_schedule(units, sms)
    parts = [sum(-(-u[3] // k1.DW_PART_N) for u in mine) for mine in lists]
    per = sum(2 * (min(128, int(layout[li][1]) - m0) + -(-c_hi // k1.DW_PART_N) * k1.DW_PART_N)
              * 64 for mine in lists for li, m0, _, c_hi, _ in mine) / nsplit
    out["dw_blocks"], out["dw_units"] = len(lists), sum(map(len, lists))
    out["dw_parts_max"], out["dw_parts_mean"] = max(parts), sum(parts) / len(parts)
else:
    out["dw_blocks"] = int(sum(-(-int(a) // 128) for a in layout[:, 1])) * nsplit
    per = sum(2 * (min(128, a_w - m0) + d_w) * 64 for _, a_w, _, d_w, _ in layout.tolist()
              for m0 in range(0, a_w, 128))
del ws
out["dw_nsplit"] = nsplit
out["dw_l2_bytes_per_sample"] = per / 64
out["dw_l2_gb_per_k2"] = per / 64 * b * s / 1e9
out["dw_hbm_gb_per_k2"] = bps * b * s / 1e9
del got
torch.cuda.empty_cache()

print("DWVAR " + json.dumps(out), flush=True)
'''


def time_trees(trees: list[str], hidden: int = 512) -> int:
    builds = [subprocess.Popen([sys.executable, "-c", _CHILD, "build", str(hidden)],
                               cwd=os.path.abspath(tree),
                               stdout=subprocess.PIPE, text=True)
              for tree in dict.fromkeys(trees)]
    failed = 0
    for proc in builds:
        out, _ = proc.communicate()
        print(*[ln for ln in out.splitlines() if ln.startswith("DWPTX ")], sep="\n", flush=True)
        failed += proc.returncode != 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, "time", str(hidden)],
                              cwd=os.path.abspath(tree),
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("DWVAR ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[exp_dw] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
    return failed


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("prepare")
    p.add_argument("src")
    p.add_argument("out")
    p.add_argument("variants", nargs="+", choices=sorted(VARIANTS))
    t = sub.add_parser("time")
    t.add_argument("--hidden", type=int, choices=(512, 1024), default=512)
    t.add_argument("trees", nargs="+")
    args = parser.parse_args()
    if args.cmd == "prepare":
        prepare(args.src, args.out, args.variants)
    else:
        sys.exit(1 if time_trees(args.trees, args.hidden) else 0)


if __name__ == "__main__":
    main()
