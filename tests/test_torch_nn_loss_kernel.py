"""The content loss's nearest-neighbour kernels (``csrc/nn_loss.cu``:
``nn_loss_fwd``, ``nn_loss_bwd``) behind ``ops.nn_loss.NNLoss``.

CPU: ``NNLoss`` takes the plain code and launches nothing; areas whose
windows leave the padded target are refused on every device.

CUDA (``-m cuda``, skipped without a card): the kernels against the plain
code on the card (``_forward_plain``, ``_backward_plain``), at areas 1, 2,
3, 5 and 7 (the tiled forward at areas 1, 3 and 5 with C % 16 == 0, the
per-pixel one at areas 2 and 7 and at C = 20), odd H and W (pixels at the
pad border in every tile), and non-contiguous maps:
- random maps: the loss within 1e-6 relative (the channels and the mean
  sum in another order); the index equal on at least 99.99 % of the
  pixels, and where it differs, the plain norms of the two shifts within
  4 ulp of each other (a near tie that the summation order decides); the
  prediction's cotangent bit for bit wherever the index agrees;
- a target of repeated pixels and small integer values (every norm exact
  in any order, so the ties are exact): the index equal everywhere, the
  first shift in scan order winning;
- two calls bit for bit equal; one launch of each kernel a forward and
  backward; float32 alone on the card.
This file imports no JAX.
"""

import pytest
import torch

from pose_transfer_torch.ops import nn_loss as NL

torch.set_num_threads(2)


def test_cpu_takes_the_plain_code_and_launches_nothing():
    before = dict(NL.LAUNCHES)
    g = torch.Generator().manual_seed(0)
    p = torch.randn((1, 6, 7, 8), generator=g, requires_grad=True)
    t = torch.randn((1, 6, 7, 8), generator=g)
    loss = NL.nn_loss(p, t, 3, 3)
    loss.backward()
    want, idx = NL._forward_plain(p.detach(), t, 3, 3)
    assert torch.equal(loss.detach(), want)
    d_want, _ = NL._backward_plain(p.detach(), t, idx, torch.ones(()), 3, 3,
                                   False)
    assert torch.equal(p.grad, d_want)
    assert NL.LAUNCHES == before


@pytest.mark.parametrize("nh,nw", [(3, 5), (5, 1), (1, 3), (17, 17)])
def test_areas_outside_the_padded_target_are_refused(nh, nw):
    p = torch.zeros((1, 20, 20, 4))
    with pytest.raises(ValueError, match="area"):
        NL.nn_loss(p, p, nh, nw)


# ---------------------------------------------------------------- CUDA ---

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel(p, t, a):
    """(loss, index, the prediction's cotangent) through ``NNLoss`` on
    the card, and the launches it counted."""
    before = dict(NL.LAUNCHES)
    x = p.detach().clone().requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda s: saved.append(s) or s, lambda s: s):
        loss = NL.nn_loss(x, t, a, a)
    loss.backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in NL.LAUNCHES.items()}
    return loss.detach(), saved[2], x.grad, launched


def _plain(p, t, a):
    loss, idx = NL._forward_plain(p, t, a, a)
    d_pred, _ = NL._backward_plain(p, t, idx, torch.ones((), device=p.device),
                                   a, a, False)
    return loss, idx, d_pred


def _norms(p, t, a):
    """(K, N, H, W) plain norms of every shift."""
    pad = NL._pad_gt(t, a, a)
    h, w = p.shape[1:3]
    return torch.stack([(pad[:, i:i + h, j:j + w] - p).abs().sum(-1)
                        for i, j in NL._shifts(a, a)])


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("shape", [(2, 17, 23, 64), (3, 9, 40, 20)])
def test_cuda_kernels_match_plain(a, shape):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(a * 7 + shape[-1])
    p = torch.randn(shape, generator=g, device=dev)
    t = torch.randn(shape, generator=g, device=dev)
    loss, idx, d_pred, launched = _kernel(p, t, a)
    want, want_idx, want_d = _plain(p, t, a)
    assert launched == {"nn_loss_fwd": 1, "nn_loss_bwd": 1}
    assert idx.dtype == torch.uint8 and idx.shape == shape[:3]
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())
    same = idx == want_idx
    assert same.float().mean().item() >= 0.9999
    if not same.all():
        norms = _norms(p, t, a)
        got_n = norms.gather(0, idx.long()[None])[0][~same]
        want_n = norms.gather(0, want_idx.long()[None])[0][~same]
        assert ((got_n - want_n).abs()
                <= 4 * 2.0 ** -23 * torch.maximum(got_n, want_n)).all()
    assert torch.equal(d_pred[same], want_d[same])


@pytest.mark.cuda
@pytest.mark.parametrize("a", [3, 5])
def test_cuda_exact_ties_route_to_the_first_shift(a):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(a)
    # a target of 2 × 2 blocks of one pixel, values in quarters: every sum
    # of differences is exact, so the tied shifts tie in any order
    base = torch.randint(-8, 8, (2, 9, 12, 32), generator=g, device=dev)
    t = (base.repeat_interleave(2, 1).repeat_interleave(2, 2) / 4.0)
    p = torch.randint(-8, 8, t.shape, generator=g, device=dev) / 4.0
    loss, idx, d_pred, _ = _kernel(p, t, a)
    want, want_idx, want_d = _plain(p, t, a)
    norms = _norms(p, t, a)
    assert ((norms == norms.min(0).values).sum(0) > 1).any()
    assert torch.equal(idx, want_idx)
    assert torch.equal(d_pred, want_d)
    assert abs(loss.item() - want.item()) <= 1e-6 * abs(want.item())


@pytest.mark.cuda
def test_cuda_non_contiguous_maps_and_repeat_calls():
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    # NCHW storage seen as NHWC, as a convolution's output permuted
    p = torch.randn((2, 64, 13, 18), generator=g, device=dev) \
        .permute(0, 2, 3, 1)
    t = torch.randn((2, 64, 13, 18), generator=g, device=dev) \
        .permute(0, 2, 3, 1)
    first = _kernel(p, t, 5)
    second = _kernel(p.contiguous(), t.contiguous(), 5)
    for x, y in zip(first[:3], second[:3]):
        assert torch.equal(x, y)
    want, want_idx, want_d = _plain(p.contiguous(), t.contiguous(), 5)
    same = first[1] == want_idx
    assert same.float().mean().item() >= 0.9999
    assert torch.equal(first[2][same], want_d[same])


@pytest.mark.cuda
def test_cuda_takes_float32_alone():
    dev = _cuda()
    p = torch.zeros((1, 8, 8, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        NL.nn_loss(p, p, 3, 3)
    with pytest.raises(ValueError, match="C % 4"):
        NL.nn_loss(torch.zeros((1, 8, 8, 6), device=dev),
                   torch.zeros((1, 8, 8, 6), device=dev), 3, 3)
