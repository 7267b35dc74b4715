"""The port's ``fold_place_stream`` against the JAX package's.

The plain version (what the wrapper runs on CPU tensors) against JAX's
Pallas ``fold_place_stream`` in interpret mode, bitwise, bf16 and f32, with
and without the argmax, one part per group and a 2+1 split; the streamed
fold over part groups against the port's monolithic ``fold_place``, as
``tests/test_warp_place.py::test_fold_place_stream_matches_monolithic``
holds JAX's; the in-place contract; the grad refusal; and, on the card, the
CUDA kernel against its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pose_transfer_tpu.ops import warp_fused as jwf
from pose_transfer_torch.ops import warp as twarp
from pose_transfer_torch.ops import warp_fused as twf

torch.set_num_threads(2)

_DT = {"float32": (jnp.float32, torch.float32, torch.int32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16, torch.int16)}
N, H, W, C, SY, SX = 2, 64, 64, 16, 32, 48
SPLITS = {"one_part_per_group": (1, 1, 1), "two_plus_one": (2, 1)}


def _stream_inputs(seed):
    """A state with negatives and a mixed argmax, and three parts' windows:
    zeros and fractions in the mask windows, x0 ≡ 0 mod 16, part 2 repeating
    part 1's window (exact ties between parts), and the state equal to part
    1's window on a patch (exact ties with the state)."""
    rng = np.random.default_rng(seed)
    p = 3
    acc = rng.standard_normal((N, H, W, C)).astype(np.float32)
    idx = rng.integers(-1, 4, (N, H, W, C)).astype(np.int8)
    wins = rng.standard_normal((N, p, SY, SX, C)).astype(np.float32)
    mwins = rng.choice([0.0, 0.25, 0.5, 1.0], size=(N, p, SY, SX)) \
        .astype(np.float32)
    offs = np.zeros((N, p, 3), np.int32)
    for i in range(N):
        for j in range(p):
            offs[i, j] = (rng.integers(0, H - SY + 1),
                          16 * rng.integers(0, (W - SX) // 16 + 1), 7 + j)
        offs[i, 1, :2] = offs[i, 0, :2]
        y0, x0 = offs[i, 0, :2]
        acc[i, y0:y0 + 4, x0:x0 + 4] = wins[i, 0, :4, :4]
        mwins[i, 0, :4, :4] = 1.0
    wins[:, 1] = wins[:, 0]
    mwins[:, 1] = mwins[:, 0]
    return acc, idx, wins, mwins, offs


def _groups(split):
    k = 0
    for size in split:
        yield slice(k, k + size)
        k += size


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("with_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_place_stream_matches_jax_bitwise(dtype, with_idx, split):
    jd, td, bits = _DT[dtype]
    acc, idx, wins, mwins, offs = _stream_inputs(0)
    # JAX's argmax is bf16 (exact for these small integers), the port's int8
    ja = jnp.asarray(acc, jd)
    ji = jnp.asarray(idx.astype(np.float32), jnp.bfloat16) if with_idx \
        else None
    ta = torch.tensor(acc).to(td)
    ti = torch.tensor(idx) if with_idx else None
    for s in _groups(SPLITS[split]):
        ja, ji = jwf.fold_place_stream(
            ja, ji, jnp.asarray(wins[:, s], jd), jnp.asarray(mwins[:, s], jd),
            jnp.asarray(offs[:, s]), interpret=True)
        ta, ti = twf.fold_place_stream(
            ta, ti, torch.tensor(wins[:, s]).to(td),
            torch.tensor(mwins[:, s]).to(td), torch.tensor(offs[:, s]))
    np.testing.assert_array_equal(
        ta.view(bits).numpy(),
        torch.tensor(np.asarray(ja.astype(jnp.float32))).to(td).view(bits)
        .numpy())
    if with_idx:
        got = ti.numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ji.astype(jnp.float32)).astype(np.int8))
        # ties went to the earlier part; untouched elements kept their value
        assert (got == 7).any() and not (got == 8).any() and (got == 9).any()
        assert (got == -1).any()
    else:
        assert ti is None and ji is None


@pytest.mark.parametrize("with_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_equals_monolithic_fold_place(dtype, with_idx):
    """Body init, the parts in groups, then the zero pass: the monolithic
    fold_place's result, bit for bit, on a real fold's windows (the port's
    kernel-placed windowed fold at 64², 3 parts)."""
    td = _DT[dtype][1]
    rng = np.random.RandomState(0)
    f = torch.tensor(rng.randn(N, H, W, C).astype(np.float32)).to(td)
    warps = np.tile(np.array([1, 0, 0, 0, 1, 0, 0, 0], np.float32),
                    (N, 4, 1))
    warps[:, 1] = [0.9, 0.1, 3.0, -0.15, 1.05, -2.0, 0, 0]
    warps[:, 2] = [1.2, -0.3, -5.0, 0.2, 0.8, 4.0, 0, 0]
    warps[:, 3] = [1, 0, 1000, 0, 1, 1000, 0, 0]   # sentinel
    masks = np.zeros((N, 4, H, W), np.float32)
    masks[:, 0] = 1.0
    masks[:, 1, 5:30, 8:30] = 1.0
    masks[:, 2, 40:60, 33:60] = 1.0
    warps = torch.tensor(warps).to(td)
    plan = twarp.plan_folds([tuple(f.shape)], warps, torch.tensor(masks), td,
                            windowed=True)[0]
    assert plan.fits and not plan.xla
    s_y, s_x = twarp._kernel_window_sizes(H, W)
    sel, mwins, offs = twarp._place_args(plan.masks_r, plan.windows, H, W, 4,
                                         ())
    y0, x0 = plan.windows
    body = twarp._warp_full(f, warps[:, 0], (H, W)) \
        * plan.masks_r[:, 0][..., None]
    wins = twarp._warp_win(f, warps[:, sel], y0[:, sel], x0[:, sel], s_y, s_x,
                           (H, W)).contiguous()
    zero_nb = (plan.masks_r[:, 1:] == 0).any(dim=1)
    ref, ref_idx = twf.fold_place(body, wins, mwins, zero_nb, offs, with_idx)

    acc = body.clone()
    idx = torch.zeros(acc.shape, dtype=torch.int8) if with_idx else None
    for s in _groups(SPLITS["two_plus_one"]):
        twf.fold_place_stream(acc, idx, wins[:, s], mwins[:, s], offs[:, s])
    take0 = zero_nb[..., None] & (acc < 0)
    acc.masked_fill_(take0, 0)
    bits = _DT[dtype][2]
    assert torch.equal(acc.view(bits), ref.view(bits))
    if with_idx:
        idx.masked_fill_(take0, -1)
        assert torch.equal(idx, ref_idx)
        assert set(idx.unique().tolist()) >= {-1, 0, 1, 2}


def test_stream_updates_in_place_and_refuses_grad():
    acc, idx, wins, mwins, offs = (torch.tensor(a)
                                   for a in _stream_inputs(1))
    before = twf.LAUNCHES["fold_place_stream"]
    acc0, idx0 = acc.clone(), idx.clone()
    out, out_idx = twf.fold_place_stream(acc, idx, wins, mwins, offs)
    assert out is acc and out_idx is idx
    assert not torch.equal(acc, acc0) and not torch.equal(idx, idx0)
    # a CPU tensor takes the plain version: no launch
    assert twf.LAUNCHES["fold_place_stream"] == before
    out, none = twf.fold_place_stream(acc, None, wins, mwins, offs)
    assert out is acc and none is None
    with pytest.raises(RuntimeError, match="requires grad"):
        twf.fold_place_stream(acc.clone().requires_grad_(True), idx, wins,
                              mwins, offs)
    with pytest.raises(RuntimeError, match="requires grad"):
        twf.fold_place_stream(acc, idx, wins.requires_grad_(True), mwins,
                              offs)
    with torch.no_grad():
        twf.fold_place_stream(acc, idx, wins, mwins, offs)
    with pytest.raises(TypeError):
        twf.fold_place_stream(acc, idx.int(), wins.detach(), mwins, offs)
    with pytest.raises(ValueError):
        twf.fold_place_stream(acc, idx, wins.detach(), mwins[:, :2], offs)


@pytest.mark.cuda
@pytest.mark.parametrize("with_idx", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_place_stream_kernel_matches_plain(dtype, with_idx):
    """The CUDA kernel, bitwise against its plain version (on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    td, bits = _DT[dtype][1], _DT[dtype][2]
    acc, idx, wins, mwins, offs = (torch.tensor(a)
                                   for a in _stream_inputs(2))
    acc, wins, mwins = acc.to(td), wins.to(td), mwins.to(td)
    idx = idx if with_idx else None
    ref, ref_idx = acc.clone(), None if idx is None else idx.clone()
    dev = [t.cuda() if t is not None else None
           for t in (acc, idx, wins, mwins, offs)]
    for s in _groups(SPLITS["two_plus_one"]):
        twf.fold_place_stream_reference(ref, ref_idx, wins[:, s],
                                        mwins[:, s], offs[:, s])
        twf.fold_place_stream(dev[0], dev[1], dev[2][:, s].contiguous(),
                              dev[3][:, s].contiguous(),
                              dev[4][:, s].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(dev[0].cpu().view(bits), ref.view(bits))
    if with_idx:
        assert torch.equal(dev[1].cpu(), ref_idx)
