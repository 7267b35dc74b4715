"""Micro-batching inference server.

Counterpart of ``pose_transfer_tpu/serve.py``:

- **Static-shape micro-batching**: requests accumulate into fixed
  ``batch_size`` batches; partial batches are padded by repeating the last
  request, so the generator always sees one shape.
- **Admission window**: the batcher dispatches when a batch fills or
  ``max_wait_ms`` expires.
- **Per-request futures** (``submit``) and a synchronous convenience
  (``generate``); p50/p95 latency and throughput counters (``stats``).
- **Spans** (``utils.spans``, recorded while a profiler records): the
  client's ``serve.submit`` with its ``serve.fit``; each request's
  ``serve.queue_wait`` sample; the batcher's ``serve.batch`` with its
  ``serve.collect``, ``serve.collate``, ``serve.step``, ``serve.fetch``
  and ``serve.deliver``. A request's spans share its ``req``, a per-server
  sequence number; a batch's carry its own ``batch`` number.
- **Data-parallel serving** (``devices``): one generator replica per
  device, each micro-batch split over them, one thread per device
  (``parallel.make_parallel_eval_step``), as the JAX server shards a batch
  over its mesh.

Request contract: a source image (uint8 HWC at the config's image size), its
keypoints and the target keypoints, (K, 2) (y, x) with MISSING_VALUE=-1. The
server runs the host-side estimation (``data.dataset.warp_fit`` for the
deformable generator, ``interpol_chain`` for the stacked one, none for the
U-Net) and the eval step (heatmap/mask rasterization and the generator
forward on the device). The stacked server answers with the last stage.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .data.dataset import collate, interpol_chain, warp_fit
from .train.engine import make_eval_step
from .utils import spans


class PoseTransferServer:
    """Persistent batched pose-transfer generator.

    Args:
      config: ``GANConfig`` (image_size/pose_dim/batch_size/gen_type/...).
      gen: the generator module (``build_models``).
      max_wait_ms: admission window for partial batches.
      queue_depth: max queued requests before ``submit`` blocks.
      output_dtype: 'float32' (generator output in [-1, 1]) or 'uint8'
        (deprocessed on the device before the host copy).
      device: where the generator runs (default ``cuda``).
      devices: serve data-parallel instead: a replica of ``gen`` on each
        (a card may be named twice), ``batch_size`` divided evenly over
        them; build ``config`` with ``parallel.config_for_mesh``.
    """

    def __init__(self, config, gen, *, max_wait_ms: float = 5.0,
                 queue_depth: int = 256, output_dtype: str = "float32",
                 device=None, devices=None):
        if output_dtype not in ("float32", "uint8"):
            raise ValueError(f"unknown output_dtype {output_dtype!r}")
        self._output_dtype = output_dtype
        self._config = config
        self._gen = gen
        if devices is not None:
            from .parallel import make_parallel_eval_step
            self._eval = make_parallel_eval_step(config, gen, devices)
        else:
            self._eval = make_eval_step(config, gen, device)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._latencies: list[float] = []
        self._served = 0
        self._batches = 0
        self._t0 = time.time()
        self._req_ids = itertools.count()
        self._batch_ids = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def config(self):
        return self._config

    @property
    def gen(self) -> torch.nn.Module:
        """The generator the server runs (read only: the batcher thread
        uses it)."""
        return self._gen

    # ------------------------------------------------------------- requests

    def prepare_request(self, image: np.ndarray, kp_from: np.ndarray,
                        kp_to: np.ndarray) -> dict:
        """Host-side sample assembly: the generator type's per-pair fits,
        compact layout. No ``image_to``: the preparer fills the blank target
        on the device."""
        cfg = self._config
        image = np.ascontiguousarray(image, np.uint8)
        if image.shape != (*cfg.image_size, 3):
            raise ValueError(
                f"image must be {(*cfg.image_size, 3)} uint8, "
                f"got {image.shape}")
        kp_from = np.asarray(kp_from, np.float32)
        kp_to = np.asarray(kp_to, np.float32)
        # malformed keypoints must fail HERE: past this point the sample is
        # co-batched, where a bad shape poisons the whole batch's collate
        for name, kp in (("kp_from", kp_from), ("kp_to", kp_to)):
            if kp.shape != (cfg.pose_dim, 2):
                raise ValueError(
                    f"{name} must be {(cfg.pose_dim, 2)}, got {kp.shape}")
        sample = {"image_from": image, "kp_from": kp_from, "kp_to": kp_to}
        if cfg.gen_type == "stacked":
            sample.update(zip(
                ("interpol_kp", "interpol_warps", "interpol_polys",
                 "interpol_kinds"),
                interpol_chain(kp_from, kp_to, cfg.pose_dim, cfg.image_size,
                               cfg.warp_skip, cfg.num_stacks)))
        elif cfg.gen_type == "baseline":
            sample.update(zip(
                ("warps", "mask_polys", "mask_kinds"),
                warp_fit(kp_from, kp_to, cfg.pose_dim, cfg.image_size,
                         cfg.warp_skip)))
        return sample

    def submit(self, image: np.ndarray, kp_from: np.ndarray,
               kp_to: np.ndarray) -> Future:
        """Enqueue one request; resolves to the generated (H, W, 3) image —
        float32 in [-1, 1], or uint8 when ``output_dtype='uint8'``."""
        if self._stop.is_set():
            raise RuntimeError("server is closed")
        req = next(self._req_ids)
        with spans.span("serve.submit", req=req):
            fut: Future = Future()
            with spans.span("serve.fit", req=req):
                sample = self.prepare_request(image, kp_from, kp_to)
            self._q.put((sample, fut, time.perf_counter(), req))
        # close() may have drained the queue between the _stop check and
        # the put — drain again so no QUEUED future is stranded
        if self._stop.is_set():
            self._fail_queued()
        return fut

    def generate(self, requests: list[tuple[np.ndarray, np.ndarray,
                                            np.ndarray]]) -> np.ndarray:
        """Synchronous batch convenience: list of (image, kp_from, kp_to)."""
        futs = [self.submit(*r) for r in requests]
        return np.stack([f.result() for f in futs])

    # ------------------------------------------------------------- batcher

    def _loop(self):
        bs = self._config.batch_size
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            b = next(self._batch_ids)
            with spans.span("serve.batch", batch=b) as sb:
                self._took(first, b)
                items = [first]
                with spans.span("serve.collect", batch=b):
                    deadline = time.perf_counter() + self._max_wait
                    while len(items) < bs:
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        try:
                            items.append(self._q.get(timeout=remaining))
                        except queue.Empty:
                            break
                        self._took(items[-1], b)
                sb.set(rows=len(items), reqs=[it[3] for it in items])
                try:
                    self._run_batch(items, b)
                except Exception as e:  # surface the failure on every future
                    for _, fut, _, _ in items:
                        if not fut.done():
                            fut.set_exception(e)

    @staticmethod
    def _took(item, batch: int) -> None:
        """The batcher took ``item`` for ``batch``: its queue wait."""
        spans.sample("serve.queue_wait", (time.perf_counter() - item[2]) * 1e3,
               req=item[3], batch=batch)

    def _run_batch(self, items, b: int):
        bs = self._config.batch_size
        with spans.span("serve.collate", batch=b):
            samples = [s for s, _, _, _ in items]
            # static-shape pad: repeat the last sample; padded outputs
            # dropped
            samples = samples + [samples[-1]] * (bs - len(samples))
            batch = collate(samples)
        with spans.span("serve.step", batch=b):
            out, _ = self._eval(batch)
        with spans.span("serve.fetch", batch=b):
            if self._config.gen_type == "stacked":
                out = out[-1]       # (S, N, H, W, 3) stages → the last
            out = out[:len(items)]
            if self._output_dtype == "uint8":
                out = ((out.float().clamp(-1.0, 1.0) + 1.0) * 127.5) \
                    .to(torch.uint8)
            else:
                out = out.float()
            out_np = out.cpu().numpy()
        with spans.span("serve.deliver", batch=b):
            done = time.perf_counter()
            with self._lock:
                self._served += len(items)
                self._batches += 1
                for _, _, t_in, _ in items:
                    self._latencies.append(done - t_in)
                del self._latencies[:-1024]  # keep a recent window
            for (_, fut, _, _), img in zip(items, out_np):
                if not fut.done():
                    fut.set_result(img)

    # --------------------------------------------------------------- admin

    def reset_stats(self):
        """Zero the counters (after warm-up, so first-call costs don't
        pollute the latency percentiles)."""
        with self._lock:
            self._latencies.clear()
            self._served = 0
            self._batches = 0
            self._t0 = time.time()

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            served, batches = self._served, self._batches
        pct = lambda p: (lat[min(int(p * len(lat)), len(lat) - 1)]  # noqa
                         if lat else 0.0)
        elapsed = max(time.time() - self._t0, 1e-9)
        return {
            "served": served,
            "batches": batches,
            "mean_batch_fill": served / batches if batches else 0.0,
            "latency_p50_ms": round(pct(0.50) * 1e3, 2),
            "latency_p95_ms": round(pct(0.95) * 1e3, 2),
            "images_per_sec": round(served / elapsed, 2),
        }

    def _fail_queued(self):
        """Fail every queued-but-undispatched request (only safe once
        ``_stop`` is set — the batcher stops dequeuing then)."""
        while True:
            try:
                _, fut, _, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("server closed"))

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._fail_queued()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
