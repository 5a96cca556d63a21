"""Render server for the PyTorch port (counterpart of
``nerf_keras_tpu/serving.py``): stdlib ``http.server`` over a trained
checkpoint, rendering through K1 on the card.

    python -m nerf_keras_tpu_torch.serving --config config/lego_batch_h256_tpu.json \
        --checkpoint models/<run> --device cuda --port 8042 [--quant int8] \
        [--sampler proposal] [--infer-cache models/<run>/model.infer.npz]

    GET /render?theta=30&phi=-30&radius=4&width=200&height=200  -> PNG
    GET /render?...&map=depth        -> normalized depth map as PNG
    GET /healthz                     -> 200 ok
    GET /stats                       -> JSON
    POST /reload                     -> re-resolve + install the newest
                                        checkpoint

Render requests serialize through a lock; handler threads come from
``ThreadingHTTPServer``.  Launched as N ranks (``torchrun``, or the
``NERF_*`` trio; see ``parallel/distributed.py``), one a GPU, rank 0 runs
the HTTP server and ranks 1..N-1 a follower loop that opens no port
(:meth:`RenderService.follow`).  Under the render lock rank 0 checks each
request, then broadcasts one command (render with its size, focal, pose,
the served int8 and sampler setting and map; ``reload``; ``stop`` at
shutdown), and every rank runs the same service method, so the
collectives of ``restore``, of the gates and of ``render_rays`` (each rank
renders its rows of every chunk) line up.  A request rank 0 refuses is
refused before the broadcast; a command that fails after it (a pose an
NDC model cannot render, memory) fails on every rank, rank 0 answers 500
and every rank goes on to the next command.  Rank 0 resolves the
checkpoint at start and at ``/reload`` and shares the path; the int8
tables and the distilled net are built, or read from ``--infer-cache``,
on rank 0 and shared; rank 0 alone encodes PNGs, keeps ``/stats`` and
writes the cache.

The float path renders through
K1; ``--quant int8`` calibrates int8 tables at startup (and at every
``/reload``), gates the int8 render against the float one on the default
pose (``--quant-gate-db``, PSNR) and, when it passes, renders every frame
through K4; when it fails the server says so and serves the float path,
as the JAX server does.  ``--sampler proposal`` on a coarse-trained
checkpoint distills a proposal net from the fine model on the same orbit
(``--proposal-steps``), gates its render of the default pose against the
coarse sampler's at the quant setting already decided
(``--sampler-gate-db``) and, when it passes, renders every frame with one
fine pass (K1, or K4 with int8) and no coarse pass.  On a proposal-trained
checkpoint (``TRAIN_SAMPLER=proposal``) it serves unchanged, since every
render already places its samples with the checkpoint's proposal nets.
``--infer-cache`` keeps the int8 tables and the distilled net in an
``.infer.npz`` keyed to the weights (``utils/infer_cache.py``): a start
loads it when it matches, ignores it with a notice when it does not, and
saves it when anything new was built.
"""

from __future__ import annotations

import argparse
import json
import math
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from nerf_keras_tpu_torch.config import load_config
from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.parallel.distributed import launched
from nerf_keras_tpu_torch.parallel.mesh import (
    broadcast_object,
    config_mesh,
    is_main,
    share_from_main,
)
from nerf_keras_tpu_torch.utils.checkpoint import (
    load_checkpoint_scene,
    resolve_checkpoint,
    resolve_infer_config,
)
from nerf_keras_tpu_torch.utils.image_metrics import accuracy_gate
from nerf_keras_tpu_torch.utils.image import normalize_depth, to_uint8
from nerf_keras_tpu_torch.utils.infer_cache import load_if_fresh
from nerf_keras_tpu_torch.utils.png import encode_png


class RenderService:
    """Owns the Trainer + checkpoint; thread-safe render calls.  Under a
    mesh (a launch of N ranks) every rank builds one; rank 0's
    serves requests and ranks 1..N-1 run :meth:`follow`."""

    def __init__(
        self, cfg, checkpoint: str,
        near: float | None = None, far: float | None = None,
        device: str | None = None,
        quant: bool = False, quant_gate_db: float = 30.0,
        sampler: str = "coarse", sampler_gate_db: float = 30.0,
        proposal_steps: int = 1500, infer_cache: str | None = None,
    ):
        if sampler not in ("coarse", "proposal"):
            raise ValueError(f"sampler must be 'coarse' or 'proposal', got {sampler!r}")
        self._sampler_requested = sampler
        self._sampler_gate_db = sampler_gate_db
        self._proposal_steps = proposal_steps
        self._infer_cache = infer_cache
        self._quant_requested = quant
        self._quant_gate_db = quant_gate_db
        self.use_quant = False
        self.use_sampler = "coarse"
        self.sampler_gate_psnr: float | None = None
        self.quant_gate_psnr: float | None = None
        self._arg_checkpoint = checkpoint
        self._arg_cfg = cfg
        self._arg_near, self._arg_far = near, far
        self._device = device
        self.mesh = config_mesh(cfg.mesh_data, cfg.mesh_model)
        self._stopped = False
        self._lock = threading.Lock()
        self.requests = 0
        self.total_render_s = 0.0
        self.reloads = 0
        self.trainer: Trainer | None = None
        self.cfg = None
        self.checkpoint = None
        self.near = self.far = None
        self._install()

    def _install(self) -> None:
        """Resolve the checkpoint from the original request (on rank 0,
        shared) and install it.  Callers hold ``_lock`` (or are the
        constructor)."""
        checkpoint = self._arg_checkpoint

        def newest():
            return (checkpoint if checkpoint.endswith(".npz")
                    else resolve_checkpoint(checkpoint)), None

        found = share_from_main(newest, self.mesh)[0]
        if found is None:
            raise FileNotFoundError(f"no .ckpt.npz under {checkpoint}")
        checkpoint = found
        scene = load_checkpoint_scene(checkpoint) or {}
        near = self._arg_near if self._arg_near is not None else scene.get("near", 2.0)
        far = self._arg_far if self._arg_far is not None else scene.get("far", 6.0)
        self.default_focal = scene.get("focal")
        cfg, notes = resolve_infer_config(self._arg_cfg, checkpoint)
        for note in notes:
            print(f"[nerf-torch] {note}")
        if (
            self.trainer is not None
            and cfg == self.cfg
            and (near, far) == (self.near, self.far)
        ):
            # Same wiring and bounds: load the new weights into the models.
            self.trainer.restore(checkpoint)
        else:
            self.trainer = Trainer(cfg, near, far, device=self._device,
                                   mesh=self.mesh).restore(checkpoint)
        self.checkpoint = checkpoint
        self.cfg = cfg
        self.near, self.far = near, far
        # The artifact cache holds functions of the weights: a file of other
        # weights is ignored with a notice, and the build below overwrites it.
        cache = self._infer_cache
        load_if_fresh(self.trainer, cache)
        pre = (self.trainer.quant_ready, self.trainer.proposal_ready)
        self.use_quant = False
        if self._quant_requested:
            self.use_quant = self._setup_quant(self._quant_gate_db)
        self.use_sampler = "coarse"
        if self._sampler_requested == "proposal" and self.trainer.online_proposal:
            print("[nerf-torch] proposal-trained checkpoint: renders already use "
                  "the in-state proposal nets")
        elif self._sampler_requested == "proposal":
            self.use_sampler = self._setup_proposal(self._sampler_gate_db,
                                                    self._proposal_steps)
        post = (self.trainer.quant_ready, self.trainer.proposal_ready)
        if cache and post != pre and any(post):
            self.trainer.save_inference_artifacts(cache)
            if is_main(self.mesh):
                print(f"[nerf-torch] saved inference artifacts to {cache}")

    def _orbit_rays(self, h: int, w: int, focal: float) -> tuple[torch.Tensor, torch.Tensor]:
        """The rays of an orbit of 8 serving poses at the config's frame
        size, where the int8 tables are calibrated and the proposal net
        distilled."""
        calib = [self.trainer.pose_rays(pose_spherical(theta, -30.0, 4.0), h, w, focal)
                 for theta in range(0, 360, 45)]
        return torch.cat([c[0] for c in calib]), torch.cat([c[1] for c in calib])

    def _setup_quant(self, gate_db: float) -> bool:
        """Calibrate the int8 render on the orbit (unless the cache gave the
        tables) and gate it against the float render of the default pose
        (PSNR); False (serve float) when the gate fails."""
        h, w = self.cfg.height, self.cfg.width
        focal = self.default_focal or 1.2 * max(h, w)
        if not self.trainer.quant_ready:
            self.trainer.quantize_for_inference(*self._orbit_rays(h, w, focal))
        pose = pose_spherical(0.0, -30.0, 4.0)
        ref = self.trainer.render_image(pose, h, w, focal)["rgb"]
        q = self.trainer.render_image(pose, h, w, focal, quant=True)["rgb"]
        ok, self.quant_gate_psnr = accuracy_gate(ref, q, gate_db, "serving int8",
                                                 "serving the float path")
        return ok

    def _setup_proposal(self, gate_db: float, steps: int) -> str:
        """Distill the proposal net on the orbit (unless the cache gave it)
        and gate its render of the default pose against the coarse
        sampler's, at the quant setting already decided; the sampler to
        serve."""
        h, w = self.cfg.height, self.cfg.width
        focal = self.default_focal or 1.2 * max(h, w)
        if not self.trainer.proposal_ready:
            self.trainer.build_proposal_sampler(*self._orbit_rays(h, w, focal), steps=steps)
        pose = pose_spherical(0.0, -30.0, 4.0)
        ref = self.trainer.render_image(pose, h, w, focal, quant=self.use_quant)["rgb"]
        p = self.trainer.render_image(pose, h, w, focal, quant=self.use_quant,
                                      sampler="proposal")["rgb"]
        ok, self.sampler_gate_psnr = accuracy_gate(ref, p, gate_db,
                                                   "serving proposal sampler",
                                                   "serving the coarse sampler")
        return "proposal" if ok else "coarse"

    def reload(self) -> dict:
        """Re-resolve the original checkpoint request and install the
        newest checkpoint (hot reload); the int8 tables and the distilled
        net (as requested) are built, or loaded from the cache, and gated
        again for the new weights."""
        with self._lock:
            previous = self.checkpoint
            self._command("reload")
            self._install()
            self.reloads += 1
            return {
                "previous": previous,
                "checkpoint": self.checkpoint,
                "changed": self.checkpoint != previous,
                "quant": "int8" if self.use_quant else "none",
                "sampler": self.use_sampler,
            }

    def _command(self, name: str, **kw) -> None:
        """Under a mesh, send the followers the command that rank 0 runs
        next (the caller holds ``_lock``)."""
        if self._stopped:
            raise RuntimeError("the render service is stopped")
        if self.mesh is not None:
            broadcast_object((name, kw), self.mesh)

    def _render(self, pose, height: int, width: int, focal: float, chunk: int,
                map_name: str, quant: bool, sampler: str) -> dict:
        return self.trainer.render_image(
            pose, height, width, focal, chunk=chunk, uint8_rgb=(map_name == "rgb"),
            need_depth=(map_name == "depth"), quant=quant, sampler=sampler)

    def _request(self, theta, phi, radius, height, width, chunk, focal, map_name) -> dict:
        """A render request checked and resolved: what every rank renders."""
        if map_name not in ("rgb", "depth"):
            raise ValueError(f"unknown map {map_name!r} (rgb|depth)")
        if min(height, width, chunk) < 1:
            raise ValueError(f"height, width and chunk must be positive, got "
                             f"{height}, {width}, {chunk}")
        if focal is None:
            # The sidecar focal was recorded at the training resolution;
            # scale it so the field of view matches training.
            if self.default_focal is not None:
                focal = self.default_focal * max(height, width) / max(
                    self.cfg.height, self.cfg.width
                )
            else:
                focal = 1.2 * max(height, width)
        if not (math.isfinite(focal) and focal > 0):
            raise ValueError(f"focal must be a positive number, got {focal}")
        return {"pose": pose_spherical(theta, phi, radius), "height": height,
                "width": width, "focal": float(focal), "chunk": chunk,
                "map_name": map_name, "quant": self.use_quant, "sampler": self.use_sampler}

    def render_png(
        self, theta: float, phi: float, radius: float,
        height: int, width: int, chunk: int = 16384,
        focal: float | None = None, map_name: str = "rgb",
    ) -> bytes:
        """One frame as PNG bytes, through the served int8 and sampler
        setting."""
        with self._lock:  # serialize device work (and, under a mesh, commands)
            request = self._request(theta, phi, radius, height, width, chunk, focal,
                                    map_name)
            self._command("render", **request)
            t0 = time.perf_counter()
            out = self._render(**request)
            self.total_render_s += time.perf_counter() - t0
            self.requests += 1
        img = (
            to_uint8(out["rgb"]) if map_name == "rgb"
            else to_uint8(normalize_depth(out["depth"]))
        )
        return encode_png(img)

    def follow(self) -> None:
        """Ranks 1..N-1 of a launch: run each command rank 0 broadcasts,
        until ``stop``.  A command that fails here failed on rank 0 at the
        same point (the same request, files and shared checkpoint path;
        what rank 0 alone builds reaches this rank as its error), and rank
        0 answered it with a 500 and serves on: so does this loop."""
        while True:
            name, kw = broadcast_object(None, self.mesh)
            if name == "stop":
                self._stopped = True
                return
            try:
                if name == "render":
                    self._render(**kw)
                else:
                    self._install()
            except Exception as e:  # rank 0's handler makes this a 500
                print(f"[nerf-torch] {name} failed as on rank 0: {e}", flush=True)

    def stop(self) -> None:
        """Release the followers (under a mesh; rank 0, once)."""
        with self._lock:
            if not self._stopped:
                self._command("stop")
                self._stopped = True

    def stats(self) -> dict:
        return {
            "checkpoint": self.checkpoint,
            "requests": self.requests,
            "mean_render_s": (
                self.total_render_s / self.requests if self.requests else 0.0
            ),
            "quant": "int8" if self.use_quant else "none",
            "sampler": self.use_sampler,
            "reloads": self.reloads,
            "device": str(self.trainer.device),
        }


def _make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send(200, b"ok", "text/plain")
                return
            if url.path == "/stats":
                self._send(200, json.dumps(service.stats()).encode(),
                           "application/json")
                return
            if url.path == "/render":
                q = parse_qs(url.query)

                def f(name, default):
                    return float(q.get(name, [default])[0])

                try:
                    png = service.render_png(
                        theta=f("theta", 0.0),
                        phi=f("phi", -30.0),
                        radius=f("radius", 4.0),
                        height=int(f("height", service.cfg.height)),
                        width=int(f("width", service.cfg.width)),
                        chunk=int(f("chunk", 16384)),
                        focal=float(q["focal"][0]) if "focal" in q else None,
                        map_name=q.get("map", ["rgb"])[0],
                    )
                except Exception as e:  # surface render errors as 500s
                    self._send(500, str(e).encode(), "text/plain")
                    return
                self._send(200, png, "image/png")
                return
            self._send(404, b"not found", "text/plain")

        def do_POST(self):  # noqa: N802 (http.server API)
            if urlparse(self.path).path == "/reload":
                try:
                    result = service.reload()
                except Exception as e:  # surface reload errors as 500s
                    self._send(500, str(e).encode(), "text/plain")
                    return
                self._send(200, json.dumps(result).encode(), "application/json")
                return
            self._send(404, b"not found", "text/plain")

    return Handler


def serve(service: RenderService, port: int, host: str = "127.0.0.1"):
    """Build the HTTP server (caller runs serve_forever / shutdown)."""
    return ThreadingHTTPServer((host, port), _make_handler(service))


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> None:
    """The server's command line.  Under a launch environment rank 0
    serves and the other ranks follow it; a SIGINT or SIGTERM to rank 0
    stops them all."""
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--near", type=float, default=None,
                   help="near bound (default: checkpoint sidecar, else 2.0)")
    p.add_argument("--far", type=float, default=None,
                   help="far bound (default: checkpoint sidecar, else 6.0)")
    p.add_argument("--port", type=int, default=8042)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--device", type=str, default=None,
                   help="cuda | cuda:N | cpu (default: cuda; without a card, "
                        "pass --device cpu)")
    p.add_argument("--quant", type=str, default="none", choices=("none", "int8"),
                   help="int8: serve through the calibrated int8 kernel (K4), "
                        "PSNR-gated against the float render at startup")
    p.add_argument("--quant-gate-db", type=float, default=30.0)
    p.add_argument("--sampler", type=str, default="coarse",
                   choices=("coarse", "proposal"),
                   help="proposal: serve with a proposal net distilled from the fine "
                        "model (no coarse pass), PSNR-gated against the coarse "
                        "sampler at startup; a proposal-trained checkpoint serves "
                        "unchanged")
    p.add_argument("--sampler-gate-db", type=float, default=30.0)
    p.add_argument("--proposal-steps", type=int, default=1500)
    p.add_argument("--infer-cache", type=str, default=None,
                   help="an .infer.npz of int8 tables and the distilled proposal "
                        "net: loaded when it matches the checkpoint's weights "
                        "(sha256), else rebuilt and saved there")
    args = p.parse_args(argv)
    with launched(args.device) as device:
        service = RenderService(
            load_config(args.config), args.checkpoint, args.near, args.far,
            device=device, quant=args.quant == "int8",
            quant_gate_db=args.quant_gate_db, sampler=args.sampler,
            sampler_gate_db=args.sampler_gate_db, proposal_steps=args.proposal_steps,
            infer_cache=args.infer_cache,
        )
        if not is_main(service.mesh):
            print(f"[nerf-torch] rank {service.mesh.rank}/{service.mesh.world} follows "
                  f"rank 0 ({service.trainer.device})", flush=True)
            service.follow()
            return
        server = serve(service, args.port, args.host)
        signal.signal(signal.SIGTERM, _interrupt)
        print(f"[nerf-torch] serving {service.checkpoint} on "
              f"http://{args.host}:{server.server_address[1]} ({service.trainer.device}, "
              f"quant={'int8' if service.use_quant else 'none'}, "
              f"sampler={service.use_sampler})", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
            service.stop()


if __name__ == "__main__":
    main()
