"""What the serving traffic kinds share: the server under test, the
client's instrumentation, and the check of the served images against the
reference."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from . import check
from .reference import fits
from .reference import model as ref

REF_BLOCK = 16          # images per reference forward
ANSWER_WAIT_S = 60.0    # how long past the window an answer may come


def start_server(r, batch: int, max_wait_ms: float):
    """``PoseTransferServer`` over the program's generator (``build_models``)
    holding the benchmark's weights."""
    from pose_transfer_torch.serve import PoseTransferServer
    from pose_transfer_torch.train.engine import build_models
    cfg = r.program_config(batch)
    r.note_implementation(cfg)
    r.mark("imports")
    gen = build_models(cfg, seed=0, device=r.device)
    r.mark("build_models")
    gen.load_state_dict(r.weights("gen"))
    r.mark("weights")
    return PoseTransferServer(cfg, gen, max_wait_ms=max_wait_ms,
                              device=r.device)


class Client:
    """The client's side of the traffic: submits through
    ``PoseTransferServer.submit`` (timed on the host clock), stamps each
    answer's arrival, and keeps the answers of the sampled requests."""

    def __init__(self, srv, keep: set):
        self.srv = srv
        self.keep = keep
        self.kept: dict = {}
        self.done_at: dict = {}
        self.submit_s: list = []
        self._lock = threading.Lock()

    def submit(self, i: int, req):
        t = time.perf_counter()
        with torch.profiler.record_function("bench.client.submit"):
            fut = self.srv.submit(*req)
        self.submit_s.append(time.perf_counter() - t)
        fut.add_done_callback(lambda f, i=i: self._done(i, f))
        return fut

    def _done(self, i, fut):
        """Stamp an answer's arrival; a failed request has none."""
        now = time.perf_counter()
        if fut.exception() is not None:
            return
        with self._lock:
            self.done_at[i] = now
            if i in self.keep:
                self.kept[i] = fut.result()

    def answered(self) -> dict:
        """{request: arrival time of its answer}, a copy."""
        with self._lock:
            return dict(self.done_at)

    def drain(self, futs, deadline: float) -> None:
        """Wait for ``futs`` until ``deadline`` (perf_counter)."""
        with torch.profiler.record_function("bench.client.drain"):
            for fut in futs:
                try:
                    fut.exception(timeout=max(deadline - time.perf_counter(),
                                              0.0))
                except TimeoutError:
                    return


def batch_fill(srv, stats0: dict) -> float:
    """Requests per batch that the server ran since ``stats0``."""
    stats = srv.stats()
    batches = stats["batches"] - stats0["batches"]
    return (stats["served"] - stats0["served"]) / batches if batches else 0.0


def settle() -> None:
    """Before the window: collect once, then move every object that
    set-up left to the collector's permanent generation. A full
    collection walks the program's and its libraries' objects, a tenth of
    a second or more, and one that fell into the window would stall the
    client and the batcher for that long."""
    gc.collect()
    gc.freeze()


def free() -> None:
    """Return the device memory of the program's objects, once the caller
    has dropped them."""
    gc.unfreeze()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_images(r, requests: list, q=ref.ident) -> torch.Tensor:
    """The reference forward of ``requests`` ((image, kp_from, kp_to)
    each) from the benchmark's weights, float32 with TF32 off, in blocks
    of REF_BLOCK, ``q`` on the convolutions' operands → (N, H, W, 3) on
    the device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gw = r.weights("gen")
    outs = []
    for k in range(0, len(requests), REF_BLOCK):
        samples = []
        for image, kp_from, kp_to in requests[k:k + REF_BLOCK]:
            warps, polys, kinds = fits.fit(kp_from, kp_to, r.pose_dim,
                                           r.image_size)
            samples.append({"image_from": image, "kp_from": kp_from,
                            "kp_to": kp_to, "warps": warps,
                            "mask_polys": polys, "mask_kinds": kinds})
        batch = {key: np.stack([s[key] for s in samples])
                 for key in samples[0]}
        with torch.no_grad():
            outs.append(ref.generator(
                gw, ref.prepare(batch, r.image_size, r.device),
                r.image_size, r.pose_dim, q=q, affine_dtype=r.compute_dtype))
    return torch.cat(outs)


def image_check(r, requests: dict, served: dict) -> tuple[float, dict]:
    """The served images of the sampled requests against the reference
    forward → (worst relative gap, info). A sampled request with no
    answer gives +inf."""
    idx = sorted(requests)
    want = reference_images(r, [requests[i] for i in idx])
    gaps = []
    for j, i in enumerate(idx):
        if i not in served:
            gaps.append(float("inf"))
            continue
        got = torch.as_tensor(served[i], device=r.device)[None]
        gaps.append(float(check.image_gaps(got, want[j:j + 1])[0]))
    return max(gaps), {"sampled": len(idx),
                       "median_gap": float(np.median(gaps))}
