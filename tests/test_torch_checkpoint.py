"""The port's checkpoints: save and resume bit for bit, the half-written
directory, the background writes, and the generator file read by the JAX
package's reference importer.

A check-mode model at 64² (pose_dim 18, batch 2, f32), on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.device import make_batch_preparer as jprep
from pose_transfer_tpu.models.import_torch import import_generator
from pose_transfer_tpu.train import GANConfig as JConfig
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_torch.train import checkpoint
from pose_transfer_torch.train import engine

torch.set_num_threads(2)

SIZE = (64, 64)
N = 2
CFG = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                       check_mode=True)
# f32 on both sides: convolution and einsum sums are associated differently
# by XLA and oneDNN, ~1e-6 relative per layer (tests/test_torch_model.py)
F32_ATOL = 1e-4


def _batches(seed):
    rng = np.random.default_rng(seed)
    fake, real, gen_b = (jsyn.synthetic_compact_batch(rng, N, SIZE, 18)
                         for _ in range(3))
    stack = lambda b: {k: v[None] for k, v in b.items()}   # noqa: E731
    return stack(fake), stack(real), gen_b


def _trained(seed=0, steps=2):
    state = engine.create_state(CFG, seed=seed, device="cpu")
    step = engine.make_train_step(CFG, state)
    for i in range(steps):
        step(*_batches(i))
    return state


def _flat(state):
    """Every tensor and number a resume must restore, in a fixed order."""
    out = [("step", torch.tensor(state.step)),
           ("rng", state.rng.get_state())]
    for name, mod, opt in (("gen", state.gen, state.gen_opt),
                           ("disc", state.disc, state.disc_opt)):
        out += [(f"{name}.{k}", v) for k, v in mod.state_dict().items()]
        sd = opt.state_dict()
        for i, st in sorted(sd["state"].items()):
            out += [(f"{name}.opt.{i}.{k}", torch.as_tensor(v))
                    for k, v in sorted(st.items())]
        out.append((f"{name}.opt.groups", torch.tensor(
            [len(g["params"]) for g in sd["param_groups"]])))
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


@pytest.mark.parametrize("block", [True, False])
def test_save_resume_is_bitwise_and_steps_alike(tmp_path, block):
    """Parameters, both Adam states, the step and the dropout generator
    come back bit for bit; a step from the resumed state (dropout on)
    equals the live state's next step bit for bit."""
    live = _trained()
    checkpoint.save(live, str(tmp_path), 7, block=block)
    checkpoint.wait_for_saves()
    assert sorted(os.listdir(tmp_path)) == ["disc_007.pt", "gen_007.pt"]
    fresh = engine.create_state(CFG, seed=1, device="cpu")
    resumed, epoch = checkpoint.resume(fresh, str(tmp_path))
    assert epoch == 7 and resumed is fresh and resumed.step == 2
    _assert_same(resumed, live)

    batch = _batches(5)
    m_live, out_live = engine.make_train_step(CFG, live)(*batch)
    m_res, out_res = engine.make_train_step(CFG, resumed)(*batch)
    assert torch.equal(out_live, out_res)
    assert all(torch.equal(m_live[k], m_res[k]) for k in m_live)
    _assert_same(resumed, live)


def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The background write holds the state of the save() call, not the
    parameters a later step updated in place."""
    state = _trained(steps=1)
    want = {k: v.clone() for k, v in state.gen.state_dict().items()}
    checkpoint.save(state, str(tmp_path), 1, block=False)
    engine.make_train_step(CFG, state)(*_batches(9))
    checkpoint.wait_for_saves()
    got = torch.load(tmp_path / "gen_001.pt", weights_only=True)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert got["step"] == 1


def test_failed_background_save_is_raised(tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    state = _trained(steps=0)
    checkpoint.save(state, str(tmp_path), 1, block=False)   # fine
    bad = os.path.join(str(blocker), "sub")
    with pytest.raises(OSError):
        checkpoint.save(state, bad, 2, block=False)      # makedirs fails
    checkpoint.wait_for_saves()
    # a write that fails on its thread surfaces at the next save or at the
    # join, whichever comes after it has failed

    def disk_full(*args):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write_atomic", disk_full)
    with pytest.raises(RuntimeError, match="async checkpoint") as err:
        checkpoint.save(state, str(tmp_path), 3, block=False)
        checkpoint.wait_for_saves()
    assert "disk full" in str(err.value.__cause__)
    checkpoint.wait_for_saves()           # nothing left pending
    assert not (tmp_path / "gen_003.pt").exists()


def test_half_written_directory(tmp_path):
    """gen_002 beside disc_001: training resume refuses; inference loads
    the generator of epoch 2 alone; nothing found means epoch 1."""
    a, b = _trained(steps=1), _trained(seed=3, steps=2)
    checkpoint.save(a, str(tmp_path), 1)
    checkpoint.save(b, str(tmp_path), 2)
    os.remove(tmp_path / "disc_002.pt")
    (tmp_path / "gen_009.pt.tmp").write_bytes(b"stale")     # not a ckpt
    with pytest.raises(FileNotFoundError, match="disc_001.pt"):
        checkpoint.resume(engine.create_state(CFG, device="cpu"),
                          str(tmp_path))
    state = engine.create_state(CFG, seed=5, device="cpu")
    disc0 = {k: v.clone() for k, v in state.disc.state_dict().items()}
    state, epoch = checkpoint.resume(state, str(tmp_path),
                                     require_disc=False)
    assert epoch == 2 and state.step == 2
    for k, v in b.gen.state_dict().items():
        assert torch.equal(state.gen.state_dict()[k], v)
    for k, v in disc0.items():
        assert torch.equal(state.disc.state_dict()[k], v)
    empty = engine.create_state(CFG, device="cpu")
    assert checkpoint.resume(empty, str(tmp_path / "none"))[1] == 1
    assert checkpoint.get_model_list(str(tmp_path), "gen").endswith(
        "gen_002.pt")


def test_load_params_reads_one_net(tmp_path):
    src = _trained(seed=2, steps=1)
    checkpoint.save(src, str(tmp_path), 4)
    dst = engine.create_state(CFG, seed=8, device="cpu")
    checkpoint.load_params(str(tmp_path / "disc_004.pt"), dst.disc)
    for k, v in src.disc.state_dict().items():
        assert torch.equal(dst.disc.state_dict()[k], v)
    assert dst.disc_opt.state_dict()["state"] == {}


def test_jax_reference_importer_reads_the_gen_file(tmp_path):
    """``import_torch.import_generator`` on the port's gen_*.pt: the JAX
    check-mode generator then gives the port's output (f32, within
    F32_ATOL)."""
    state = _trained(seed=4, steps=1)
    checkpoint.save(state, str(tmp_path), 1)
    enc, dec = CFG.filters
    params = import_generator(str(tmp_path / "gen_001.pt"), len(enc),
                              len(dec))
    jcfg = JConfig(image_size=SIZE, pose_dim=18, batch_size=N,
                   check_mode=True)
    jgen, _ = jengine.build_models(jcfg)
    batch = jsyn.synthetic_compact_batch(np.random.default_rng(6), N, SIZE,
                                         18)
    prep = jprep(image_size=SIZE, pose_dim=18)(batch)
    want = np.asarray(jax.jit(lambda p: jgen.apply(
        p, prep["input"], prep["warps"], prep["masks"], train=False))(
            jax.tree.map(jnp.asarray, params)))
    got, _ = engine.make_eval_step(CFG, state.gen, device="cpu")(batch)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
