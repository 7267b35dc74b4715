"""The port's HTTP serving front (``pose_transfer_torch.cli.serve``) against
the JAX package's (``pose_transfer_tpu.cli.serve``): the round trip of JAX's
``tests/test_serve.py::test_http_roundtrip`` (200, 400, 404, ``/stats``,
``/healthz``), the timeout and failure codes, and ``build_server`` reading a
JAX run's ``models/`` directory with ``--resume 1``.

market size (128×64, pose_dim 18), the check-mode generator, batch 2, f32,
on the CPU. The served images of the two fronts, from the same weights and
requests, agree within one uint8 level: the generators agree within 1e-4
(tests/test_torch_model.py), and a value that close to a rounding boundary
of the uint8 map may land on the next level.
"""

import concurrent.futures as cf
import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pose_transfer_tpu.cli.serve import make_http_server as jmake_http
from pose_transfer_tpu.serve import PoseTransferServer as JServer
from pose_transfer_tpu.train import checkpoint as jcheckpoint
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_torch.cli import serve as cli_serve
from pose_transfer_torch.cli.opts import Opts
from pose_transfer_torch.data.synthetic import random_image, random_skeleton

torch.set_num_threads(2)

SIZE = (128, 64)


def _requests(n, seed):
    rng = np.random.default_rng(seed)
    return [(random_image(rng, SIZE),
             random_skeleton(rng, SIZE, 18).astype(np.float32),
             random_skeleton(rng, SIZE, 18).astype(np.float32))
            for _ in range(n)]


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _post(port, body, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@contextlib.contextmanager
def _serving(httpd):
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)


def _generate(port, reqs):
    """The requests sent concurrently; (status, image) each."""
    def one(r):
        status, body = _post(port, _npz(image=r[0], kp_from=r[1],
                                        kp_to=r[2]))
        with np.load(io.BytesIO(body)) as z:
            return status, z["image"]
    with cf.ThreadPoolExecutor(len(reqs)) as ex:
        return list(ex.map(one, reqs))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A JAX check-mode state saved by JAX as ``<exp>/j/models``."""
    root = tmp_path_factory.mktemp("http")
    cfg = jengine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                            check_mode=True)
    state, gen, _ = jengine.create_state(cfg, seed=6)
    jcheckpoint.save(state, str(root / "exp" / "j" / "models"), 2)
    return {"root": root, "cfg": cfg, "gen": gen,
            "params": state.gen_params}


def _opt(root, *extra):
    return Opts().parse([
        "--expID", "j", "--dataset", "market", "--pose_dim", "18",
        "--batch_size", "2", "--checkMode", "1", "--exp_root",
        str(root / "exp"), "--device", "cpu", "--max_wait_ms", "50",
        *extra])


def test_http_roundtrip_matches_the_jax_front(jax_run):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pts = cli_serve.build_server(_opt(jax_run["root"], "--resume", "1"))
    assert "Serving epoch-2 weights" in buf.getvalue()
    reqs = _requests(3, seed=3)
    with pts, _serving(cli_serve.make_http_server(pts, "127.0.0.1", 0)) \
            as port:
        cli_serve.warm_up(pts, 18)
        assert pts.stats()["served"] == 0
        got = _generate(port, reqs)
        status, body = _get(port, "/stats")
        stats = json.loads(body)
        assert status == 200 and stats["served"] == 3
        assert _get(port, "/healthz") == (200, b"ok")
        assert _get(port, "/nope")[0] == 404
        assert _post(port, b"x", "/nope")[0] == 404
        assert _post(port, b"not-npz")[0] == 400
        img, kp1, kp2 = reqs[0]
        status, body = _post(port, _npz(image=img[:-1], kp_from=kp1,
                                        kp_to=kp2))
        assert status == 400 and b"image must be" in body
        status, body = _post(port, _npz(image=img, kp_from=kp1[:5],
                                        kp_to=kp2))
        assert status == 400 and b"kp_from must be" in body
        assert _post(port, _npz(image=img, kp_from=kp1))[0] == 400
        # the library path of the same server gives the same bytes
        lib = pts.generate(reqs)
    assert all(s == 200 for s, _ in got)
    got = np.stack([im for _, im in got])
    assert got.dtype == np.uint8 and got.shape == (3, *SIZE, 3)
    np.testing.assert_array_equal(got, lib)

    with JServer(jax_run["cfg"], jax_run["gen"], jax_run["params"],
                 max_wait_ms=50.0, output_dtype="uint8") as jsrv, \
            _serving(jmake_http(jsrv, "127.0.0.1", 0)) as port:
        want = np.stack([im for s, im in _generate(port, reqs)
                         if s == 200])
    assert want.shape == got.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 0.01


class _Stub:
    """A server stand-in whose futures time out or fail."""

    def __init__(self, exc):
        self.exc = exc

    def submit(self, *args):
        fut = cf.Future()
        fut.set_exception(self.exc)
        return fut

    def stats(self):
        return {}


@pytest.mark.parametrize("exc,code", [(TimeoutError(), 504),
                                      (RuntimeError("batch failed"), 500)])
def test_http_timeout_and_batch_failure_codes(exc, code):
    img, kp1, kp2 = _requests(1, seed=4)[0]
    with _serving(cli_serve.make_http_server(_Stub(exc), "127.0.0.1",
                                             0)) as port:
        status, body = _post(port, _npz(image=img, kp_from=kp1, kp_to=kp2))
    assert status == code
    if code == 500:
        assert body == b"batch failed"


def test_build_server_flags(jax_run):
    """``--generator_checkpoint`` takes a JAX .msgpack file; no flag
    serves the seeded init; ``--warp_backend exact`` serves; ``--num_devices
    2`` serves the same images from two replicas."""
    root = jax_run["root"]
    path = str(root / "exp" / "j" / "models" / "gen_002.msgpack")
    reqs = _requests(2, seed=5)
    outs = {}
    for name, extra in (("ckpt", ("--generator_checkpoint", path)),
                        ("resume", ("--resume", "1")), ("init", ()),
                        ("exact", ("--resume", "1", "--warp_backend",
                                   "exact")),
                        ("replicas", ("--resume", "1", "--num_devices",
                                      "2"))):
        with contextlib.redirect_stdout(io.StringIO()):
            pts = cli_serve.build_server(_opt(root, *extra))
        with pts:
            outs[name] = pts.generate(reqs)
    np.testing.assert_array_equal(outs["ckpt"], outs["resume"])
    assert not np.array_equal(outs["init"], outs["resume"])
    assert outs["exact"].dtype == np.uint8
    assert outs["exact"].shape == outs["resume"].shape
    # the batch of 2 split over two CPU replicas: the same images
    np.testing.assert_array_equal(outs["replicas"], outs["resume"])
