"""The hidden-512 kernels' design measurements on one card: patched copies, timed in turn.

    python -m nerf_keras_tpu_torch.exp_wide prepare SRC OUT VARIANT [VARIANT ...]
    python -m nerf_keras_tpu_torch.exp_wide time TREE [TREE ...]

``prepare`` copies the port of the checkout SRC (``nerf_keras_tpu_torch``,
``chip_smoke.py``, ``config``) into ``OUT/<variant>`` for each variant and
applies the variant's text patches to the split tile's sources
(``csrc/nerf_wgmlp.cuh``, ``nerf_hopper.cuh``, ``nerf_rows.cuh``).
Make OUT a directory that ``.gitignore`` lists (``_archive/``).  Each
variant answers one question about K1 and K2 at 8x512 (the split tile:
64-row tiles in clusters of two blocks that share each weight stage):

* ``nocluster``: the blocks of a cluster run apart (no peer: each brings
  its own stages, releases only its own);
* ``fence``: a consumer's release of the peer's stage with release at
  cluster scope (``mbarrier.arrive.release.cluster``) instead of CUTLASS's
  default form;
* ``fwd_nopipe``: the forward waits on each stage's products before the
  next stage's issue; ``rows_pipe``: the rows kernel keeps a group in
  flight across stages as the forward does;
* ``rows_smem_db``: the rows kernel's bias sums in shared memory, so its
  ring has two stages, not three;
* ``ks16``: 16-deep weight stages (twice as many in the same bytes);
* ablations, which compute wrong values on purpose: ``nostream`` (each
  ring slot filled once, then reused: no weight stream after the first
  stages), ``noepi`` (the split tile's epilogues, workspace stores and bias
  sums skipped; the activation tile is never written, so later layers
  multiply stale data);
* ``as_is``: no patch.

``nostream`` and ``noepi`` apply to the parent commit's split tile too
(one tile a block, stage by stage: ``git archive 0fabf52``).

``time`` builds every TREE's K1/K2 sources at once, then runs each tree in
a process of its own, in the order given (name a tree twice to
interleave; a checkout of another commit, unpacked with ``git archive``,
runs as it is), and prints one JSON line per tree: K1 in both forms and K2
on ``chip_smoke``'s 8x512 suite model at B=4096, S=192 (CUDA events, median
of 10; K2 of 5), K2's device ms per kernel and the weight bytes a tile
brings from L2 (K1's pack, the rows kernel's two packs); before them, one
line per tree of its 512 instantiations' ``-Xptxas -v`` report.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

_WG = "nerf_wgmlp.cuh"
_HOPPER = "nerf_hopper.cuh"
_BWD = "nerf_rows.cuh"

_PEER = "  if constexpr (WgTile<H>::kSplit) r.peer = static_cast<int>(cluster_rank() ^ 1u);"
_FULL = "    mbar_expect_tx(&r.full[p.st], bytes);"
_SPLIT_RETURN = "  if (WgTile<H>::kSplit) return;\n"


def _early_return(head: str, tail: str) -> tuple[str, str, str]:
    """A patch that returns at once from a split-tile function whose body
    follows ``head`` (its last signature line) and starts with ``tail``."""
    return _WG, head + tail, head + _SPLIT_RETURN + tail


VARIANTS = {
    "as_is": [],
    "nocluster": [(_WG, _PEER, "  (void)r;")],
    "fence": [(_HOPPER, '"mbarrier.arrive.shared::cluster.b64 _, [ra];\\n"',
               '"mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\\n"')],
    "fwd_nopipe": [(_WG, "constexpr bool kPipeForward = true, kPipeRows = false;",
                    "constexpr bool kPipeForward = false, kPipeRows = false;")],
    "rows_pipe": [(_WG, "constexpr bool kPipeForward = true, kPipeRows = false;",
                   "constexpr bool kPipeForward = true, kPipeRows = true;")],
    "rows_smem_db": [
        (_BWD, "  float* db = T::kSplit ? p.db_blk + (size_t)blockIdx.x * p.total_b\n"
               "                        : scratch + 2 * T::kRowWarps * p.sld;",
         "  float* db = scratch + 2 * T::kRowWarps * p.sld;"),
        (_BWD, "(split ? 0 : total_b)));", "(size_t)total_b));")],
    "ks16": [(_WG, "  return hidden > kSplitAbove ? kKsNarrow : kKs;",
              "  return hidden > kSplitAbove ? 16 : kKs;")],
    "nostream": [
        (_WG, "  uint32_t ph = 0;\n", "  uint32_t ph = 0;\n  int n = 0;\n"),
        (_WG, "    if (++st == stages) {", "    ++n;\n    if (++st == stages) {"),
        (_WG, _FULL, "    if (p.n >= r.stages) {\n      mbar_arrive(&r.full[p.st]);\n"
                     "      p.next(r.stages);\n      continue;\n    }\n" + _FULL)],
    "noepi": [
        _early_return("int ldx, uint32_t* mask, int mw) {\n",
                      "  if constexpr (!WgTile<H>::kSplit) {\n    epi_relu"),
        _early_return("int ldx, float* sig, int valid) {\n",
                      "  if constexpr (!WgTile<H>::kSplit) {\n    epi_feature_sigma"),
        _early_return("int mw, float* srow) {\n",
                      "  if constexpr (!WgTile<H>::kSplit) {\n    epi_bwd"),
        _early_return("int valid) {\n", "  if (col_part<H>() == 0) epi_rgb"),
        _early_return("int W, int rbase) {\n", "  const int vecs = W >> 3;"),
        (_WG, "  consumer_sync(kWgConsumers);\n  for (int c = threadIdx.x; c < n;",
         "  if (kRowW == 4) return;\n  consumer_sync(kWgConsumers);\n"
         "  for (int c = threadIdx.x; c < n;")],
}


def patch_tree(csrc: str, variant: str) -> None:
    """Apply the variant's patches under ``csrc``; raises if one does not apply."""
    for name, old, new in VARIANTS[variant]:
        path = os.path.join(csrc, name)
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
        patch_tree(os.path.join(dst, "nerf_keras_tpu_torch", "csrc"), variant)


_CHILD = r'''
import json, os, re, sys
sys.path.insert(0, os.getcwd())
import torch
from nerf_keras_tpu_torch.ops.kernels import _build
_build._sources = lambda: [_build.CSRC / "fused_render_fwd.cu",
                           _build.CSRC / "fused_render_bwd_512.cu"]
if sys.argv[1] == "build":
    _build.build()
    ptxas, name = [], None
    for ln in _build.build_log.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if found:
            name = found.group(1)
        elif name and "ILi512E" in name and ("Used" in ln or "spill" in ln):
            ptxas.append(f"{name}: {ln.strip()}")
    print("WIDEPTX " + json.dumps({"tree": os.getcwd(), "ptxas512": ptxas}), flush=True)
    sys.exit(0)
import chip_smoke as cs
from nerf_keras_tpu_torch.ops.kernels import fused_render as k1
from nerf_keras_tpu_torch.runtime import card_string, configure_numerics, cuda_ms
configure_numerics()
out = {"tree": os.getcwd(), "card": card_string()}
dev = torch.device("cuda")
mlp = cs._suite_mlp(dev, 512, seed=525)
x = cs._suite_inputs(mlp, 4096, 192, seed=525)
calls = cs._suite_calls(mlp, x)
with torch.no_grad():
    for kernel in ("k1", "k1_train", "k2"):
        out[f"{kernel}_ms"] = cuda_ms(calls[kernel], reps=5 if kernel == "k2" else 10)
    out["k2_device_ms"] = cs.device_ms_by_kernel(calls["k2"], cs.K2_STAGES)
fwd, bwd = k1.kernel_pack(mlp, dev), k1.kernel_pack_bwd(mlp, dev)
L = mlp.num_layers
nbytes = lambda desc, idx: sum(int(desc[i, 0]) * int(desc[i, 2]) * 2 for i in idx)
out["k1_tile_weight_bytes"] = nbytes(fwd.desc, range(L + 3))
out["rows_tile_weight_bytes"] = nbytes(fwd.desc, range(L + 2)) + nbytes(bwd.desc, range(1, L + 3))
print("WIDEVAR " + json.dumps(out), flush=True)
'''


def time_trees(trees: list[str]) -> int:
    builds = [subprocess.Popen([sys.executable, "-c", _CHILD, "build"], cwd=os.path.abspath(tree),
                               stdout=subprocess.PIPE, text=True)
              for tree in dict.fromkeys(trees)]
    failed = 0
    for proc in builds:
        out, _ = proc.communicate()
        print(*[ln for ln in out.splitlines() if ln.startswith("WIDEPTX ")], sep="\n", flush=True)
        failed += proc.returncode != 0
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD, "time"], cwd=os.path.abspath(tree),
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("WIDEVAR ")]
        print(*lines, sep="\n", flush=True)
        if proc.returncode != 0 or not lines:
            failed += 1
            print(f"[exp_wide] {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}",
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
    t.add_argument("trees", nargs="+")
    args = parser.parse_args()
    if args.cmd == "prepare":
        prepare(args.src, args.out, args.variants)
    else:
        sys.exit(1 if time_trees(args.trees) else 0)


if __name__ == "__main__":
    main()
