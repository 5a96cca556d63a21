"""Render server for the PyTorch port (counterpart of
``nerf_keras_tpu/serving.py``): stdlib ``http.server`` over a trained
checkpoint, rendering through K1 on the card.

    python -m nerf_keras_tpu_torch.serving --config config/lego_batch_h256_tpu.json \
        --checkpoint models/<run> --device cuda --port 8042

    GET /render?theta=30&phi=-30&radius=4&width=200&height=200  -> PNG
    GET /render?...&map=depth        -> normalized depth map as PNG
    GET /healthz                     -> 200 ok
    GET /stats                       -> JSON
    POST /reload                     -> re-resolve + install the newest
                                        checkpoint

Render requests serialize through a lock onto the one device; handler
threads come from ``ThreadingHTTPServer``.  This slice serves the float
coarse-sampler path; ``--quant int8`` and ``--sampler proposal`` are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from nerf_keras_tpu_torch.engine.trainer import Trainer
from nerf_keras_tpu_torch.ops.rays import pose_spherical
from nerf_keras_tpu_torch.utils.checkpoint import (
    load_checkpoint_scene,
    resolve_checkpoint,
    resolve_infer_config,
)
from nerf_keras_tpu_torch.utils.image import normalize_depth, to_uint8
from nerf_keras_tpu_torch.utils.png import encode_png


class RenderService:
    """Owns the Trainer + checkpoint; thread-safe render calls."""

    def __init__(
        self, cfg, checkpoint: str,
        near: float | None = None, far: float | None = None,
        device: str | None = None,
        quant: bool = False, sampler: str = "coarse",
    ):
        if quant:
            raise NotImplementedError(
                "--quant int8 is not yet ported (the int8 kernel K4 "
                "arrives in a later PR)"
            )
        if sampler != "coarse":
            raise NotImplementedError(
                f"--sampler {sampler} is not yet ported (the proposal "
                "sampler arrives in a later PR)"
            )
        self._arg_checkpoint = checkpoint
        self._arg_cfg = cfg
        self._arg_near, self._arg_far = near, far
        self._device = device
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
        """Resolve the checkpoint from the original request and install
        it.  Callers hold ``_lock`` (or are the constructor)."""
        checkpoint = self._arg_checkpoint
        if not checkpoint.endswith(".npz"):
            found = resolve_checkpoint(checkpoint)
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
            self.trainer = Trainer(cfg, near, far, device=self._device).restore(
                checkpoint
            )
        self.checkpoint = checkpoint
        self.cfg = cfg
        self.near, self.far = near, far

    def reload(self) -> dict:
        """Re-resolve the original checkpoint request and install the
        newest checkpoint (hot reload)."""
        with self._lock:
            previous = self.checkpoint
            self._install()
            self.reloads += 1
            return {
                "previous": previous,
                "checkpoint": self.checkpoint,
                "changed": self.checkpoint != previous,
                "quant": "none",
                "sampler": "coarse",
            }

    def render_png(
        self, theta: float, phi: float, radius: float,
        height: int, width: int, chunk: int = 16384,
        focal: float | None = None, map_name: str = "rgb",
    ) -> bytes:
        if map_name not in ("rgb", "depth"):
            raise ValueError(f"unknown map {map_name!r} (rgb|depth)")
        pose = pose_spherical(theta, phi, radius)
        if focal is None:
            # The sidecar focal was recorded at the training resolution;
            # scale it so the field of view matches training.
            if self.default_focal is not None:
                focal = self.default_focal * max(height, width) / max(
                    self.cfg.height, self.cfg.width
                )
            else:
                focal = 1.2 * max(height, width)
        with self._lock:  # one device: serialize device work
            t0 = time.perf_counter()
            out = self.trainer.render_image(
                pose, height, width, focal, chunk=chunk,
                uint8_rgb=(map_name == "rgb"),
                need_depth=(map_name == "depth"),
            )
            self.total_render_s += time.perf_counter() - t0
            self.requests += 1
        img = (
            to_uint8(out["rgb"]) if map_name == "rgb"
            else to_uint8(normalize_depth(out["depth"]))
        )
        return encode_png(img)

    def stats(self) -> dict:
        return {
            "checkpoint": self.checkpoint,
            "requests": self.requests,
            "mean_render_s": (
                self.total_render_s / self.requests if self.requests else 0.0
            ),
            "quant": "none",
            "sampler": "coarse",
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


def main(argv=None) -> None:
    from nerf_keras_tpu.config import load_config

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
                   help="cuda | cuda:N | cpu (default: cuda when present)")
    p.add_argument("--quant", type=str, default="none", choices=("none", "int8"),
                   help="int8 is not yet ported")
    p.add_argument("--sampler", type=str, default="coarse",
                   choices=("coarse", "proposal"),
                   help="proposal is not yet ported")
    args = p.parse_args(argv)
    service = RenderService(
        load_config(args.config), args.checkpoint, args.near, args.far,
        device=args.device, quant=args.quant == "int8", sampler=args.sampler,
    )
    server = serve(service, args.port, args.host)
    print(f"[nerf-torch] serving {service.checkpoint} on "
          f"http://{args.host}:{args.port} ({service.trainer.device})")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
