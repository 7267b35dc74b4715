"""Serving entry point: an HTTP front over ``serve.PoseTransferServer``.

Counterpart of ``pose_transfer_tpu/cli/serve.py``, with its contract
(standard library only):

  POST /generate   body: .npz with ``image`` (H, W, 3) uint8,
                   ``kp_from``/``kp_to`` (K, 2) float (y, x), -1 = missing
                   → .npz with ``image`` (H, W, 3) uint8 (the render)
  GET  /stats      JSON latency/throughput counters
  GET  /healthz    200 once the model is warm

A request fault (a body that is no .npz, a wrong shape) answers 400, a
request that waits more than 120 s 504, a failed batch 500; any other path
404. Concurrent requests are micro-batched into fixed-shape batches on the
server's one batcher thread, which alone runs the device; the HTTP
handler threads only decode, submit and encode. The weights come from
``--resume 1`` (the latest ``gen_*.pt``, or the JAX package's
``gen_*.msgpack``, of ``<exp_root>/<expID>/models``) or
``--generator_checkpoint``; else the seeded random init. Run:

  python -m pose_transfer_torch.cli.serve --expID <exp> --resume 1 \\
      --dataset fasion --pose_dim 18 [--serve_port 8710] [--max_wait_ms 5] \\
      [--device cpu] [--num_devices k]
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..parallel import mesh
from ..serve import PoseTransferServer
from ..train import checkpoint
from ..train.engine import create_state, resolve_device
from .opts import Opts, config_from_opt, mesh_from_opt


def build_server(opt) -> PoseTransferServer:
    """The uint8-answering server of ``opt``'s generator and weights, on
    ``opt.device``; ``--num_devices k``: one replica per device, each
    micro-batch split over them."""
    config = config_from_opt(opt)
    devices = mesh_from_opt(opt, config)
    if devices is not None:
        # device_count drives the auto warp_windowed rule (per-device batch)
        config = mesh.config_for_mesh(config, devices)
    device = resolve_device(devices[0] if devices else opt.device)
    # the content loss is a training option: serving builds no VGG
    state = create_state(dataclasses.replace(config,
                                             content_loss_layer="none"),
                         seed=opt.seed, device=device)
    if opt.generator_checkpoint:
        checkpoint.load_params(opt.generator_checkpoint, state.gen)
    elif opt.resume:
        state, epoch = checkpoint.resume(state, opt.checkpoints_dir,
                                         require_disc=False, seed=opt.seed)
        print(f"Serving epoch-{epoch} weights")
    return PoseTransferServer(config, state.gen, max_wait_ms=opt.max_wait_ms,
                              output_dtype="uint8", device=device,
                              devices=devices)


class _Handler(BaseHTTPRequestHandler):
    server_version = "pose-transfer-torch/1.0"
    pts: PoseTransferServer = None  # class attribute, set by make_http_server

    def log_message(self, *args):  # quiet
        pass

    def _send(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        elif self.path == "/stats":
            self._send(200, json.dumps(self.pts.stats()).encode(),
                       "application/json")
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        if self.path != "/generate":
            self._send(404, b"not found", "text/plain")
            return
        try:  # request faults (not an npz, wrong shapes) → 400
            n = int(self.headers.get("Content-Length", "0"))
            with np.load(io.BytesIO(self.rfile.read(n))) as z:
                image = z["image"]
                kp_from = z["kp_from"]
                kp_to = z["kp_to"]
            fut = self.pts.submit(image, kp_from, kp_to)
        except Exception as e:
            self._send(400, str(e).encode() or b"bad request", "text/plain")
            return
        try:  # execution faults (a failed batch, a stall) → 5xx
            out = fut.result(timeout=120)
        except TimeoutError:
            self._send(504, b"generation timed out", "text/plain")
            return
        except Exception as e:
            self._send(500, str(e).encode() or b"generation failed",
                       "text/plain")
            return
        buf = io.BytesIO()
        np.savez_compressed(buf, image=out)
        self._send(200, buf.getvalue(), "application/octet-stream")


def make_http_server(pts: PoseTransferServer, host: str = "127.0.0.1",
                     port: int = 8710) -> ThreadingHTTPServer:
    """A ``ThreadingHTTPServer`` answering for ``pts`` (port 0: any free
    port, ``server_address[1]`` says which)."""
    handler = type("Handler", (_Handler,), {"pts": pts})
    return ThreadingHTTPServer((host, port), handler)


def warm_up(pts: PoseTransferServer, pose_dim: int) -> None:
    """One request through the whole path (the kernels build and the
    allocator warms), then the counters zeroed so that it does not enter
    the latency percentiles."""
    h, w = pts.config.image_size
    kp = np.stack([np.linspace(4, h - 4, pose_dim),
                   np.linspace(4, w - 4, pose_dim)], 1).astype(np.float32)
    pts.generate([(np.zeros((h, w, 3), np.uint8), kp, kp)])
    pts.reset_stats()


def main(argv=None):
    opt = Opts().parse(argv)
    pts = build_server(opt)
    warm_up(pts, opt.pose_dim)
    httpd = make_http_server(pts, opt.serve_host, opt.serve_port)
    print(f"Serving on http://{opt.serve_host}:{httpd.server_address[1]} "
          f"(POST /generate, GET /stats)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        threading.Thread(target=httpd.shutdown, daemon=True).start()
        httpd.server_close()
        pts.close()


if __name__ == "__main__":
    main()
