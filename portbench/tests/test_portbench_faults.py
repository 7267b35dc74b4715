"""The output check fails a broken timed path: a run driven on the CPU at
a small size (the look for a card skipped), with the program broken
underneath, comes out not correct; the same run unbroken comes out
correct under the cells' own limits."""

import time

import pytest
import torch

from portbench import run

TRAIN = "fashion256-train-b32"
SERVE = ["fashion256-serve-online-b8", "h36m224-serve-offline-b32"]
SEED = 2**31 + 977


def _correct(spec) -> bool:
    res = run.execute(spec, SEED, 1.0, False, "cpu", time.perf_counter())
    return res["result"]["correct"]


def _unchanged_state(monkeypatch):
    from pose_transfer_torch.train import engine

    class Frozen(torch.optim.Adam):
        def step(self, closure=None):
            return None

    monkeypatch.setattr(engine, "make_optimizer", lambda config, params:
                        Frozen(params, lr=config.learning_rate))


def _half_batch(monkeypatch):
    """Every loss over the first half of the rows, mean over those, the
    forward left whole."""
    from pose_transfer_torch.train import losses
    gen_adv, disc_adv, l1 = (losses.gen_adversarial_loss,
                             losses.disc_adversarial_loss, losses.l1_loss)
    monkeypatch.setattr(losses, "gen_adversarial_loss",
                        lambda d, w, n: gen_adv(d[:n // 2], w, n // 2))
    monkeypatch.setattr(losses, "disc_adversarial_loss",
                        lambda t, f, w, n: disc_adv(t[:n // 2], f[:n // 2],
                                                    w, n // 2))
    monkeypatch.setattr(losses, "l1_loss",
                        lambda p, t: l1(p[:p.shape[0] // 2],
                                        t[:t.shape[0] // 2]))


def _repeated_rows(monkeypatch):
    """The batch's second half replaced by its first where it is
    prepared."""
    from pose_transfer_torch.train import engine
    real = engine.batch_preparer

    def halved(config, device):
        prepare = real(config, device)

        def prep(raw):
            out = prepare(raw)
            for k, v in out.items():
                if isinstance(v, torch.Tensor) and v.shape[0] > 1:
                    h = v.shape[0] // 2
                    out[k] = torch.cat([v[:h], v[:h]])
            return out
        return prep

    monkeypatch.setattr(engine, "batch_preparer", halved)


def _altered_output(monkeypatch):
    from pose_transfer_torch.train import engine
    real = engine.gen_apply

    def altered(gen, batch, config):
        out, stages = real(gen, batch, config)
        return torch.cat([-out[:1], out[1:]]), stages

    monkeypatch.setattr(engine, "gen_apply", altered)


def _gen_lr10(monkeypatch):
    """The generator's Adam (the state's first) at ten times its rate."""
    from pose_transfer_torch.train import engine
    real, made = engine.make_optimizer, []

    def make(config, params):
        opt = real(config, params)
        if not made:
            for group in opt.param_groups:
                group["lr"] *= 10.0
        made.append(opt)
        return opt

    monkeypatch.setattr(engine, "make_optimizer", make)


def _altered_answer(monkeypatch):
    from pose_transfer_torch import serve
    real = serve.make_eval_step

    def make(config, gen, device=None):
        step = real(config, gen, device)

        def altered(batch):
            out, prepared = step(batch)
            return out * 0.8, prepared
        return altered

    monkeypatch.setattr(serve, "make_eval_step", make)


@pytest.mark.parametrize("cell", [TRAIN] + SERVE)
def test_sound_run_is_correct(cell, small):
    assert _correct(small(cell))


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_output, _repeated_rows,
                                   _gen_lr10])
def test_broken_training_is_not_correct(fault, small, monkeypatch):
    fault(monkeypatch)
    assert not _correct(small(TRAIN))


@pytest.mark.parametrize("cell", SERVE)
def test_altered_answers_are_not_correct(cell, small, monkeypatch):
    _altered_answer(monkeypatch)
    assert not _correct(small(cell))
