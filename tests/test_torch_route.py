"""The port's fold backward router ``fold_route`` against the JAX package's.

``fold_route_reference`` (the plain version the wrapper runs on CPU
tensors) against JAX's Pallas ``fold_route`` in interpret mode, bitwise in
f32 and bf16; the wrapper's checks and its grad-mode guard (shared with
``fold_place``). Inputs come from numpy seeds and go to both packages; the
port's int8 argmax goes to JAX as bf16, the TPU kernel's argmax dtype.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_transfer_tpu.ops import warp_fused as jwf
from pose_transfer_torch.ops import warp_fused as twf

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32, np.uint32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, np.uint16, torch.int16)}


def _bits_jax(x, dtype):
    return np.asarray(x).view(_DT[dtype][2])


def _bits_torch(x, dtype):
    return x.view(_DT[dtype][3]).numpy().view(_DT[dtype][2])


def _route_inputs(seed, n=2, h=64, w=64, c=16, parts=(1, 2, 3, 4), sy=32,
                  sx=48):
    """fold_route inputs: negative g beside zero mask values (signed zeros),
    -1 entries (the zero pass), overlapping windows (two parts' windows at
    one start: each routes only its own pixels)."""
    rng = np.random.default_rng(seed)
    p = len(parts)
    g = rng.standard_normal((n, h, w, c)).astype(np.float32)
    idx = rng.choice(np.array((-1, 0) + tuple(parts), np.int8),
                     size=(n, h, w, c))
    mask0 = rng.choice([0.0, 0.5, 1.0], size=(n, h, w)).astype(np.float32)
    mwins = rng.choice([0.0, 0.25, 0.5, 1.0], size=(n, p, sy, sx)) \
        .astype(np.float32)
    offs = np.zeros((n, p, 3), np.int32)
    for i in range(n):
        for j in range(p):
            offs[i, j] = (rng.integers(0, h - sy + 1),
                          16 * rng.integers(0, (w - sx) // 16 + 1), parts[j])
        if p > 1:
            offs[i, 1, :2] = offs[i, 0, :2]
    return g, idx, mask0, mwins, offs


def _route_both(inputs, dtype):
    g, idx, mask0, mwins, offs = inputs
    jd, td = _DT[dtype][0], _DT[dtype][1]
    sy, sx = mwins.shape[2:]
    jw, jb = jwf.fold_route(
        jnp.asarray(g, jd), jnp.asarray(idx.astype(np.float32), jnp.bfloat16),
        jnp.asarray(mask0, jd), jnp.asarray(mwins, jd), jnp.asarray(offs),
        sy, sx, interpret=True)
    tw, tb = twf.fold_route(
        torch.tensor(g).to(td), torch.tensor(idx), torch.tensor(mask0).to(td),
        torch.tensor(mwins).to(td), torch.tensor(offs))
    return jw, jb, tw, tb


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_route_matches_jax_bitwise(dtype):
    inputs = _route_inputs(0)
    jw, jb, tw, tb = _route_both(inputs, dtype)
    assert tw.shape == (2, 4, 32, 48, 16) and tw.dtype == _DT[dtype][1]
    np.testing.assert_array_equal(_bits_torch(tw, dtype), _bits_jax(jw, dtype))
    np.testing.assert_array_equal(_bits_torch(tb, dtype), _bits_jax(jb, dtype))
    # the cases that make bitwise equality mean something occurred
    sign = np.uint32(1 << 31) if dtype == "float32" else np.uint16(1 << 15)
    bits = _bits_torch(tw, dtype)
    assert ((bits == sign)).any()                  # -0: negative g · 0
    assert (bits == 0).any() and (tw != 0).any()   # +0 and routed values


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_route_static_empty_matches_jax(dtype):
    """pose_dim 16: only parts 6-9 are placed."""
    inputs = _route_inputs(1, parts=(6, 7, 8, 9))
    jw, jb, tw, tb = _route_both(inputs, dtype)
    np.testing.assert_array_equal(_bits_torch(tw, dtype), _bits_jax(jw, dtype))
    np.testing.assert_array_equal(_bits_torch(tb, dtype), _bits_jax(jb, dtype))


def test_fold_route_routes_to_the_winner():
    """Every routed window value is g·mask where idx names the part, and
    the body route and the windows together carry each selected pixel
    once."""
    g, idx, mask0, mwins, offs = (torch.tensor(a) for a in _route_inputs(2))
    gwins, gbody = twf.fold_route(g, idx, mask0, mwins, offs)
    for i in range(g.shape[0]):
        for j, (y0, x0, part) in enumerate(offs[i].tolist()):
            win = (slice(y0, y0 + 32), slice(x0, x0 + 48))
            want = torch.where(idx[i][win] == part, g[i][win], 0.0) \
                * mwins[i, j][..., None]
            assert torch.equal(gwins[i, j], want)
    assert torch.equal(gbody, torch.where(idx == 0, g, 0.0) * mask0[..., None])


def test_fold_route_cpu_takes_plain_version():
    """On CPU tensors the wrapper runs the plain version (no launch) and
    rejects inputs it cannot take."""
    g, idx, mask0, mwins, offs = (torch.tensor(a) for a in _route_inputs(3))
    before = dict(twf.LAUNCHES)
    out = twf.fold_route(g, idx, mask0, mwins, offs)
    ref = twf.fold_route_reference(g, idx, mask0, mwins, offs)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert twf.LAUNCHES == before
    with pytest.raises(TypeError):
        twf.fold_route(g, idx.float(), mask0, mwins, offs)
    with pytest.raises(TypeError):
        twf.fold_route(g, idx, mask0.bfloat16(), mwins, offs)
    with pytest.raises(ValueError):
        twf.fold_route(g, idx, mask0, mwins[:, :2], offs)
    with pytest.raises(ValueError):
        twf.fold_route(g, idx[..., :8], mask0, mwins, offs)


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """Neither kernel's output carries a gradient, so both wrappers raise
    on an input that requires grad under grad mode (and run without grad
    mode)."""
    g, idx, mask0, mwins, offs = (torch.tensor(a) for a in _route_inputs(4))
    g.requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        twf.fold_route(g, idx, mask0, mwins, offs)
    with torch.no_grad():
        twf.fold_route(g, idx, mask0, mwins, offs)
    body = g.detach().clone().requires_grad_(True)
    wins = torch.zeros((2, 4, 32, 48, 16))
    zero_nb = torch.zeros((2, 64, 64), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="requires grad"):
        twf.fold_place(body, wins, mwins, zero_nb, offs)
    with torch.no_grad():
        twf.fold_place(body, wins, mwins, zero_nb, offs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_route_kernel_matches_plain(dtype):
    """The CUDA kernel, bitwise against its plain version (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td = _DT[dtype][1]
    args = [torch.tensor(a) for a in _route_inputs(5)]
    args = [a.to(td) if a.is_floating_point() else a for a in args]
    ref = twf.fold_route_reference(*args)
    out = twf.fold_route(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert torch.equal(o.cpu().view(_DT[dtype][3]), r.view(_DT[dtype][3]))
