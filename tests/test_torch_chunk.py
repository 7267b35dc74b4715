"""The fold's memory chunking against the JAX package's.

``PT_WARP_PLACE_CHUNK_MB`` (the kernel-placed fold in batch chunks,
``_place_batch_chunk``) and ``PT_WARP_JOINT_GROUP`` (the windowed warps in
part groups, ``_joint_group``): the chunk size against JAX's on a grid of
shapes, dtypes and caps; the chunked fold, forward and feature gradient,
against the port's one-call fold and JAX's chunked
``warp_fold_matmul(..., "kernel")`` (its Pallas kernels in interpret
mode); the part groups against JAX for both windowed placements. Inputs as
``tests/test_warp_place.py``'s, from numpy seeds, f32 on the CPU.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_transfer_tpu.ops import warp as jwarp
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused as twf

torch.set_num_threads(2)

H, W, C, T = 64, 64, 16, 4
IMG = (H, W)
# f32 on both sides: the two tile the same contractions differently and the
# backward's joint transposed warp sums (part, window row) in another order
# than XLA's, so outputs and gradients agree to ulp-level reassociation:
# the tolerance of tests/test_warp_place.py:56-63 and
# tests/test_torch_fold_xla.py
ATOL = 5e-5


def _inputs(n, seed=0):
    """``n`` samples: two real parts, a sentinel part (empty mask) and
    masks that fit their windows, the first two samples those of
    tests/test_warp_place.py; features and cotangent from ``seed``."""
    rng = np.random.RandomState(seed)
    f = rng.randn(n, H, W, C).astype(np.float32)
    warps = np.tile(np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float32),
                    (n, T, 1))
    warps[:, 1] = [0.9, 0.1, 3.0, -0.15, 1.05, -2.0, 0, 0]
    warps[:, 2] = [1.2, -0.3, -5.0, 0.2, 0.8, 4.0, 0, 0]
    warps[:, 3] = [1, 0, 1000, 0, 1, 1000, 0, 0]   # sentinel
    warps[:, 1, 2] += np.arange(n)                 # each sample its own
    masks = np.zeros((n, T, H, W), np.float32)
    masks[:, 0] = 1.0
    masks[:, 1, 5:30, 8:30] = 1.0
    masks[:, 2, 40:60, 33:60] = 1.0
    g = rng.randn(n, H, W, C).astype(np.float32)
    return f, warps, masks, g


def _jax(f, warps, masks, g, place="kernel"):
    import jax
    out, vjp = jax.vjp(
        lambda x: jwarp.warp_fold_matmul(x, jnp.asarray(warps),
                                         jnp.asarray(masks), IMG, "max",
                                         True, (), place), jnp.asarray(f))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port(f, warps, masks, g, place="kernel"):
    """(out, df, fold_place calls, fold_route calls) of the port's layer."""
    calls = {"place": 0, "route": 0}
    real_place, real_route = twf.fold_place, twf.fold_route

    def place_counted(*a, **k):
        calls["place"] += 1
        return real_place(*a, **k)

    def route_counted(*a, **k):
        calls["route"] += 1
        return real_route(*a, **k)

    ft = torch.tensor(f, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twf, "fold_place", place_counted)
        mp.setattr(twf, "fold_route", route_counted)
        out = twarp.affine_transform_layer(
            ft, torch.tensor(warps), torch.tensor(masks), IMG, "mask", "max",
            windowed=True, place_impl=place)
        out.backward(torch.tensor(g))
    return out.detach().numpy(), ft.grad.numpy(), calls["place"], \
        calls["route"]


# (n, h, w, c, p): this file's shape, the ragged n = 7 of
# tests/test_warp_place.py:165-177, fashion-256's three windowed stages at
# b32 and b64, h36m's 224² stage (4 active parts) at b48
SHAPES = [(2, 64, 64, 16, 3), (7, 64, 64, 16, 3), (32, 256, 256, 64, 9),
          (64, 256, 256, 64, 9), (32, 128, 128, 128, 9), (32, 64, 64, 256, 9),
          (48, 224, 224, 64, 4), (1, 256, 256, 64, 9)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("cap", [None, "1", "2", "-3"])
def test_place_batch_chunk_matches_jax(monkeypatch, cap, itemsize):
    """Letter for letter JAX's, the environment read at each call: unset is
    3072 MB (fashion-256 stage 0 at b64 → 54 + 10), and a cap below 1
    gives 1-sample chunks in both packages."""
    if cap is None:
        monkeypatch.delenv("PT_WARP_PLACE_CHUNK_MB", raising=False)
    else:
        monkeypatch.setenv("PT_WARP_PLACE_CHUNK_MB", cap)
    for shape in SHAPES:
        got = twarp._place_batch_chunk(*shape, itemsize)
        assert got == jwarp._place_batch_chunk(*shape, itemsize), shape
        assert 1 <= got <= shape[0]
    if cap is None and itemsize == 2:
        assert twarp._place_batch_chunk(64, 256, 256, 64, 9, 2) == 54
    if cap == "2" and itemsize == 4:
        # JAX's ragged case: 0.5625 MB a sample, 3 fit in 2 MB
        assert twarp._place_batch_chunk(7, H, W, C, 3, 4) == 3
        assert [s.stop - s.start for s in twarp._batch_chunks(7, 3)] == \
            [3, 3, 1]
    if cap == "-3":
        assert twarp._place_batch_chunk(7, H, W, C, 3, itemsize) == 1


@pytest.mark.parametrize("cap,n,chunks", [("1", 2, 2), ("2", 7, 3)])
def test_chunked_fold_matches_one_call_and_jax(monkeypatch, cap, n, chunks):
    """Forward and feature gradient in chunks (cap 1 MB: 1-sample chunks;
    2 MB: 3 + 3 + a tail of 1) equal the port's one-call fold bit for bit
    (every sample's fold is independent) and JAX's chunked fold within
    ATOL; one fold_place and one fold_route per chunk."""
    f, warps, masks, g = _inputs(n)
    monkeypatch.delenv("PT_WARP_PLACE_CHUNK_MB", raising=False)
    out1, df1, place1, route1 = _port(f, warps, masks, g)
    assert (place1, route1) == (1, 1)
    monkeypatch.setenv("PT_WARP_PLACE_CHUNK_MB", cap)
    out, df, place, route = _port(f, warps, masks, g)
    assert (place, route) == (chunks, chunks)
    np.testing.assert_array_equal(out, out1)
    np.testing.assert_array_equal(df, df1)
    out_j, df_j = _jax(f, warps, masks, g)
    np.testing.assert_allclose(out, out_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(df, df_j, atol=ATOL, rtol=0)


@pytest.mark.parametrize("place", ["xla", "kernel"])
@pytest.mark.parametrize("group", ["2", "1", "-3"])
def test_joint_group_matches_jax(monkeypatch, group, place):
    """``PT_WARP_JOINT_GROUP`` 2 (groups of 2 and 1 of the 3 placed parts),
    1 (each part alone) and -3 (no grouping), forward and gradient, both
    windowed placements, against JAX under the same variable and against
    the port without it; the groups' f32 gradients add in group order."""
    f, warps, masks, g = _inputs(2, seed=1)
    monkeypatch.delenv("PT_WARP_JOINT_GROUP", raising=False)
    out1, df1, _, _ = _port(f, warps, masks, g, place)
    monkeypatch.setenv("PT_WARP_JOINT_GROUP", group)
    assert twarp._joint_group() == jwarp._joint_group() == max(0, int(group))
    out, df, _, _ = _port(f, warps, masks, g, place)
    out_j, df_j = _jax(f, warps, masks, g, place)
    np.testing.assert_allclose(out, out_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(df, df_j, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, out1, atol=ATOL, rtol=0)
    np.testing.assert_allclose(df, df1, atol=ATOL, rtol=0)
    if group == "-3":
        np.testing.assert_array_equal(out, out1)
        np.testing.assert_array_equal(df, df1)


@pytest.mark.parametrize("place", ["xla", "kernel"])
def test_backward_keeps_the_forward_settings(monkeypatch, place):
    """The batch chunk and the part group are the plan's, made with the
    forward: changing both variables between the forward and the backward
    leaves the gradient bit for bit the one under the forward's settings
    throughout, routed in the forward's chunks (2 MB: 3 + 3 + 1)."""
    f, warps, masks, g = _inputs(7, seed=2)
    monkeypatch.setenv("PT_WARP_PLACE_CHUNK_MB", "2")
    monkeypatch.setenv("PT_WARP_JOINT_GROUP", "1")
    _, df1, _, route1 = _port(f, warps, masks, g, place)
    routes = []
    real_route = twf.fold_route
    monkeypatch.setattr(twf, "fold_route",
                        lambda *a: routes.append(1) or real_route(*a))
    ft = torch.tensor(f, requires_grad=True)
    out = twarp.affine_transform_layer(
        ft, torch.tensor(warps), torch.tensor(masks), IMG, "mask", "max",
        windowed=True, place_impl=place)
    monkeypatch.setenv("PT_WARP_PLACE_CHUNK_MB", "1")
    monkeypatch.delenv("PT_WARP_JOINT_GROUP")
    out.backward(torch.tensor(g))
    assert len(routes) == route1 == (3 if place == "kernel" else 0)
    np.testing.assert_array_equal(ft.grad.numpy(), df1)
