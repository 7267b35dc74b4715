"""The port's deformable generator and eval step against the JAX package's,
with the weights carried across by ``models.import_flax``.

A narrow 5-stage model at 128² (every width a multiple of 8): the 128² and
64² fold stages take the kernel-placed windowed fold on both sides (JAX's
Pallas kernel in interpret mode, the port's plain placement on the CPU),
the 32² and 16² stages the full scan.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.models import DeformableGenerator as JGen
from pose_transfer_tpu.models.import_torch import import_generator
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import make_eval_step as jmake_eval_step
from pose_transfer_torch.models.import_flax import (
    generator_state_dict_from_flax)
from pose_transfer_torch.models.networks import (
    DeformableGenerator, decoder_filters_for, encoder_filters_for)
from pose_transfer_torch.ops import warp_fused as twf
from pose_transfer_torch.train.engine import GANConfig, make_eval_step

torch.set_num_threads(2)

SIZE = (128, 128)
ENC = (8, 16, 16, 16, 16)
DEC = (16, 16, 16, 16, 3)
# f32: both sides compute the same math; convolution and einsum sums are
# associated differently by XLA and oneDNN, ~1e-6 relative per layer
F32_ATOL = 1e-4


def _jgen(dtype=jnp.float32, windowed=True):
    return JGen(pose_dim=18, image_size=SIZE, nfilters_enc=ENC,
                nfilters_dec=DEC, warp_windowed=windowed, warp_place="kernel",
                dtype=dtype)


def _tgen(params, dtype=torch.float32, windowed=True):
    gen = DeformableGenerator(18, SIZE, ENC, DEC, warp_windowed=windowed,
                              dtype=dtype)
    gen.load_state_dict(generator_state_dict_from_flax(params))
    return gen.eval()


@pytest.fixture(scope="module")
def setup():
    batch = jsyn.synthetic_compact_batch(np.random.default_rng(0), 2, SIZE,
                                         18)
    prep = jprep(image_size=SIZE, pose_dim=18)(batch)
    plain = _jgen(windowed=False)
    params = jax.jit(functools.partial(plain.init, train=False))(
        {"params": jax.random.PRNGKey(0)}, prep["input"], prep["warps"],
        prep["masks"])
    # nonzero norm affines, so the mapping of every leaf is exercised
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * (len(jax.tree_util.keystr(path)) % 5)
        if x.ndim == 0 else x, params)
    params = jax.tree.map(np.asarray, params)
    return batch, prep, params


def _run_jax(gen, params, prep, dtype=jnp.float32):
    fwd = jax.jit(lambda p, i, w, m: gen.apply(p, i, w, m, train=False))
    return np.asarray(fwd(params, prep["input"].astype(dtype),
                          prep["warps"].astype(dtype),
                          prep["masks"].astype(dtype)).astype(jnp.float32))


def _run_torch(gen, prep, dtype=torch.float32):
    def t(k):
        return torch.tensor(np.asarray(prep[k])).to(dtype)
    with torch.inference_mode():
        return gen(t("input"), t("warps"), t("masks")).float().numpy()


def test_param_count_full_width_on_meta():
    """The fashion-256 generator has the reference's 82 080 611 parameters
    (built on the meta device: no weights allocated)."""
    size = (256, 256)
    gen = DeformableGenerator(18, size, encoder_filters_for(size),
                              decoder_filters_for(size), device="meta")
    assert all(p.is_meta for p in gen.parameters())
    assert sum(p.numel() for p in gen.parameters()) == 82_080_611


def test_import_flax_round_trip(setup):
    """flax → import_flax → JAX's own import_torch gives back the params."""
    _, _, params = setup
    back = import_generator(generator_state_dict_from_flax(params),
                            len(ENC), len(DEC))
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(b), a,
                                      err_msg=jax.tree_util.keystr(path))


def test_state_dict_names_are_reference_names(setup):
    """The port's own state_dict loads through JAX's reference-checkpoint
    importer into exactly the flax parameter tree."""
    _, _, params = setup
    gen = DeformableGenerator(18, SIZE, ENC, DEC)
    sd = gen.state_dict()
    assert set(sd) == set(generator_state_dict_from_flax(params))
    imported = import_generator(sd, len(ENC), len(DEC))
    assert jax.tree.structure(imported) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(imported), jax.tree.leaves(params)):
        assert np.shape(a) == np.shape(b)


def test_generator_matches_jax_f32(setup, monkeypatch):
    _, prep, params = setup
    calls = []
    real = twf.fold_place
    monkeypatch.setattr(twf, "fold_place",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    got = _run_torch(_tgen(params), prep)
    ref = _run_jax(_jgen(), params, prep)
    # the kernel-placed fold ran at the 128² and 64² stages only
    assert [s[1] for s in calls] == [128, 64]
    assert np.abs(got - ref).max() <= F32_ATOL
    assert np.abs(got).max() > 0.05            # not a degenerate output


def test_generator_matches_jax_bf16(setup):
    """bf16 compute: the two frameworks round at other places (the conv
    bias add is a separate bf16 op in flax, fused into the f32 epilogue
    in oneDNN), so single-ulp differences (2^-8 relative) enter every
    layer and the decoder carries them; near-ties in the fold's max can
    then pick the other part. Measured mean 1.8e-3, max 0.03 on outputs
    of mean magnitude 0.41; held at mean 5e-3, max 0.08."""
    _, prep, params = setup
    got = _run_torch(_tgen(params, torch.bfloat16), prep, torch.bfloat16)
    ref = _run_jax(_jgen(jnp.bfloat16), params, prep, jnp.bfloat16)
    diff = np.abs(got - ref)
    assert diff.mean() <= 5e-3 and diff.max() <= 0.08, \
        (diff.mean(), diff.max())


def test_eval_step_matches_jax(setup):
    """Compact numpy batch → prepared batch → generator, end to end."""
    batch, _, params = setup
    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                   warp_windowed=True, warp_place="kernel")
    ref, _ = jmake_eval_step(jcfg, _jgen())(params, batch)
    cfg = GANConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                    warp_windowed=True)
    got, prepared = make_eval_step(cfg, _tgen(params), device="cpu")(batch)
    assert got.shape == (2, *SIZE, 3) and got.dtype == torch.float32
    assert prepared["input"].shape == (2, *SIZE, 3 + 2 * 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_ATOL,
                               rtol=0)
