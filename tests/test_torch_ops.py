"""The port's batch preparation and norm against the JAX package's:
heatmaps, part-mask rasterization, the prepared batch dict and
``volume_instance_norm``. Inputs come from numpy seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_transfer_tpu.core import pose as jpose
from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.ops.masks import rasterize_part_masks as jmasks
from pose_transfer_tpu.ops.norm import volume_instance_norm as jnorm
from pose_transfer_torch.core import pose as tpose
from pose_transfer_torch.data.device import make_batch_preparer as tprep
from pose_transfer_torch.ops.masks import rasterize_part_masks as tmasks
from pose_transfer_torch.ops.norm import volume_instance_norm as tnorm

torch.set_num_threads(2)

SIZE = (64, 64)
# The image and heatmap channels agree to the last ulp only: XLA rewrites
# x/255 and d²/72 into products by the reciprocal under jit, and exp
# differs by up to one ulp between the two libraries' vector math.
ULP_RTOL, ULP_ATOL = 2e-7, 1.2e-7


def _batch(seed=0, n=3, with_target=True, pose_dim=18):
    b = jsyn.synthetic_compact_batch(np.random.default_rng(seed), n, SIZE,
                                     pose_dim)
    b["kp_from"][0, 3] = -1            # a missing joint: zero channel
    if not with_target:
        del b["image_to"]
    return b


def test_cords_to_map_matches_jax():
    kp = _batch()["kp_from"]
    got = tpose.cords_to_map(torch.tensor(kp), SIZE).numpy()
    ref = np.asarray(jpose.cords_to_map(jnp.asarray(kp), SIZE))
    np.testing.assert_allclose(got, ref, rtol=ULP_RTOL, atol=ULP_ATOL)
    assert (got[0, ..., 3] == 0).all()


def test_image_scaling_and_packing_match_jax():
    b = _batch()
    img = b["image_from"]
    np.testing.assert_array_equal(
        tpose.preprocess_image(torch.tensor(img)).numpy(),
        np.asarray(jpose.preprocess_image(jnp.asarray(img))))
    x = np.linspace(-1, 1, 97, dtype=np.float32)
    np.testing.assert_array_equal(
        tpose.deprocess_image(torch.tensor(x)).numpy(),
        np.asarray(jpose.deprocess_image(jnp.asarray(x))))
    packed = np.random.default_rng(0).random((2, 8, 8, 3 + 2 * 18),
                                             np.float32)
    for use in (True, False):
        got = tpose.get_imgpose(torch.tensor(packed), use, 18)
        ref = jpose.get_imgpose(jnp.asarray(packed), use, 18)
        for a, r in zip(got, ref):
            if r is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_rasterize_part_masks_matches_jax():
    """Every kind (0-3), batched, exact; plus quads with horizontal edges
    and vertices on pixel rows (the strict/half-open edge rules)."""
    b = _batch(n=4)
    polys, kinds = b["mask_polys"].copy(), b["mask_kinds"].copy()
    kinds[0, 3] = 3                                     # an empty part
    polys[1, 2] = [[10, 10], [10, 30], [25, 30], [25, 10]]   # axis box quad
    polys[1, 4] = [[5.5, 3.0], [20.0, 40.25], [33.0, 12.0], [20.0, 2.5]]
    got = tmasks(torch.tensor(polys), torch.tensor(kinds), SIZE).numpy()
    ref = np.stack([np.asarray(jmasks(jnp.asarray(p), jnp.asarray(k), SIZE))
                    for p, k in zip(polys, kinds)])
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(kinds)) == {0, 1, 2, 3}


@pytest.mark.parametrize("with_target", [True, False])
def test_prepared_batch_matches_jax(with_target):
    b = _batch(with_target=with_target)
    got = tprep(image_size=SIZE, pose_dim=18, device="cpu")(b)
    ref = jprep(image_size=SIZE, pose_dim=18)(b)
    assert set(got) == set(ref)
    for k in ("warps", "masks"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    for k in ("input", "target"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=ULP_RTOL, atol=ULP_ATOL, err_msg=k)
    if not with_target:
        assert (got["target"] == -1).all()


def test_prepared_batch_full_warp_skip_has_no_masks():
    b = jsyn.synthetic_compact_batch(np.random.default_rng(1), 2, SIZE, 18,
                                     "full")
    got = tprep(image_size=SIZE, pose_dim=18, device="cpu",
                warp_skip="full", dtype=torch.bfloat16)(b)
    assert got["masks"] is None and got["warps"].shape == (2, 1, 8)
    assert got["input"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (3, 16, 16, 8)])
def test_volume_instance_norm_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) + 0.5).astype(np.float32)
    one, zero = torch.ones(1), torch.zeros(1)
    got = tnorm(torch.tensor(x), one, zero)
    ref = jnorm(jnp.asarray(x), jnp.float32(1.0), jnp.float32(0.0))
    # against the exact stats (float64) the port holds atol 1e-6 (outputs
    # of magnitude ≤ 4: about two f32 ulp)
    x64 = x.astype(np.float64)
    mean = x64.mean(axis=(1, 2, 3), keepdims=True)
    var = (x64 ** 2).mean(axis=(1, 2, 3), keepdims=True) - mean ** 2
    np.testing.assert_allclose(got.numpy(), (x64 - mean) / np.sqrt(var + 1e-3),
                               atol=1e-6, rtol=0)
    # against JAX 3e-6: XLA's CPU reduction sums the C·H·W values in
    # sequence (its f32 mean is off by up to ~4e-7 from float64, torch's
    # pairwise sum by ~1e-8), and that error scales every output
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-6,
                               rtol=0)
    # the scalar affine is applied to the same f32 normalized values
    w, b = torch.tensor([1.7]), torch.tensor([-0.3])
    torch.testing.assert_close(tnorm(torch.tensor(x), w, b), got * w + b,
                               atol=0, rtol=0)
    # the stats cover C·H·W per sample: layout-free
    nchw = tnorm(torch.tensor(x).permute(0, 3, 1, 2), one, zero)
    np.testing.assert_allclose(nchw.permute(0, 2, 3, 1).numpy(), got.numpy(),
                               atol=1e-6, rtol=0)
    bf = tnorm(torch.tensor(x).bfloat16(), one, zero)
    assert bf.dtype == torch.bfloat16
