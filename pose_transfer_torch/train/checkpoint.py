"""Checkpoint save and resume.

Counterpart of ``pose_transfer_tpu/train/checkpoint.py``, with the
semantics kept: per-net files ``gen_{epoch:03d}.pt`` and
``disc_{epoch:03d}.pt`` in a checkpoints directory; the latest found by
file-name sort; resume restarts *at* the checkpoint epoch; a gen file
without its same-epoch disc file raises unless ``require_disc=False``
(the inference entry points load the generator alone).

Format: ``torch.save`` of a flat dict, written to a temporary file and
moved into place with ``os.replace``:

- ``gen_*.pt``: the generator's state_dict under the reference's names
  (so ``pose_transfer_tpu/models/import_torch.py`` reads the file as it
  is), and ``optimizer`` (its Adam state_dict), ``step`` and ``rng`` (the
  dropout generator's ``get_state()``);
- ``disc_*.pt``: the discriminator's state_dict and ``optimizer``.

No parameter name lacks a dot, so the three extra keys cannot collide with
one. ``save(..., block=False)`` copies the state to host memory first, on
the caller's thread (the next step updates the parameters in place), then
writes on a background thread; ``wait_for_saves`` joins the writes and
re-raises a failed one.
"""

from __future__ import annotations

import os
import threading
import time

import torch

_EXTRA_KEYS = ("optimizer", "step", "rng")


def get_model_list(dirname: str, key: str, ext: str = "pt"):
    """Latest checkpoint path for ``key``, by file-name sort, or None.
    Only names ending in ``.{ext}`` count, so a stale temporary file is
    never taken for a checkpoint."""
    if not os.path.exists(dirname):
        return None
    models = [os.path.join(dirname, f) for f in os.listdir(dirname)
              if os.path.isfile(os.path.join(dirname, f))
              and key in f and f.endswith("." + ext)]
    if not models:
        return None
    return sorted(models)[-1]


def parse_epoch(path: str) -> int:
    """Epoch from ``..._{epoch:03d}.<ext>``."""
    stem = os.path.basename(path).rsplit(".", 1)[0]
    return int(stem[-3:])


def _host(obj):
    """``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(v) for v in obj)
    return obj


def _snapshot(state) -> tuple[dict, dict]:
    """(gen blob, disc blob) of a ``TrainState``, in host memory."""
    gen = _host(state.gen.state_dict())
    gen.update(optimizer=_host(state.gen_opt.state_dict()),
               step=int(state.step), rng=state.rng.get_state())
    disc = _host(state.disc.state_dict())
    disc.update(optimizer=_host(state.disc_opt.state_dict()))
    return gen, disc


def _write_atomic(path: str, blob: dict) -> None:
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _write(blobs, save_dir: str, epoch: int) -> None:
    # gen first: a save stopped between the two leaves gen_N beside
    # disc_{N-1}, which resume refuses to pair
    gen, disc = blobs
    _write_atomic(os.path.join(save_dir, f"gen_{epoch:03d}.pt"), gen)
    _write_atomic(os.path.join(save_dir, f"disc_{epoch:03d}.pt"), disc)


_pending_saves: list[threading.Thread] = []


def save(state, save_dir: str, epoch: int, *, block: bool = True) -> None:
    """Write the gen/disc checkpoint pair of ``state`` for ``epoch``.
    ``block=False``: snapshot now, write on a background thread."""
    os.makedirs(save_dir, exist_ok=True)
    blobs = _snapshot(state)
    if block:
        _write(blobs, save_dir, epoch)
        return

    def _job():
        try:
            _write(blobs, save_dir, epoch)
        except BaseException as e:  # surfaced by wait_for_saves
            t.error = e

    t = threading.Thread(target=_job, daemon=True)
    t.error = None
    t.start()
    # tracked before draining: if an earlier save failed, the drain
    # raises, and this one must still be joined by wait_for_saves
    _pending_saves.append(t)
    _drain_finished()


def _drain_finished() -> None:
    """Drop finished saves, re-raising the first failure: a lost
    checkpoint must not pass for a saved one."""
    err = None
    alive = []
    for p in _pending_saves:
        if p.is_alive():
            alive.append(p)
        elif err is None and getattr(p, "error", None) is not None:
            err = p.error
    _pending_saves[:] = alive
    if err is not None:
        raise RuntimeError("async checkpoint save failed") from err


def wait_for_saves(timeout: float | None = None) -> None:
    """Join outstanding asynchronous saves. Raises if one failed, or if
    saves are still running when ``timeout`` (across all joins) expires."""
    deadline = None if timeout is None else time.monotonic() + timeout
    for t in list(_pending_saves):
        t.join(None if deadline is None
               else max(0.0, deadline - time.monotonic()))
    still_alive = [t for t in _pending_saves if t.is_alive()]
    _drain_finished()
    if still_alive:
        raise TimeoutError(
            f"{len(still_alive)} async checkpoint save(s) still running "
            f"after {timeout:.1f}s")


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _params(blob: dict) -> dict:
    return {k: v for k, v in blob.items() if k not in _EXTRA_KEYS}


def resume(state, save_dir: str, require_disc: bool = True):
    """Load the latest gen/disc pair into ``state`` (a ``TrainState``, in
    place). Returns (state, epoch); epoch 1 when nothing is found."""
    gen_path = get_model_list(save_dir, "gen")
    if gen_path is None:
        return state, 1
    gen = _load(gen_path)
    epoch = parse_epoch(gen_path)
    print("Resume gen from epoch %d" % epoch)

    disc_path = get_model_list(save_dir, "disc")
    disc = None
    if disc_path is None or parse_epoch(disc_path) != epoch:
        # gen is written first, so a stopped save leaves gen_N beside
        # disc_{N-1}: pairing those, or starting over, would corrupt the
        # run without a word
        have = os.path.basename(disc_path) if disc_path else "none"
        if require_disc:
            raise FileNotFoundError(
                f"checkpoint dir {save_dir!r} has "
                f"{os.path.basename(gen_path)} but its matching disc "
                f"checkpoint is missing (found: {have}) — refusing to "
                f"silently pair mismatched epochs; restore or remove the "
                f"orphaned file")
        print(f"NOTE: disc checkpoint for epoch {epoch} missing "
              f"(found: {have}); loading generator only")
    else:
        disc = _load(disc_path)
    state.gen.load_state_dict(_params(gen))
    state.gen_opt.load_state_dict(gen["optimizer"])
    state.step = int(gen["step"])
    state.rng.set_state(gen["rng"])
    if disc is not None:
        state.disc.load_state_dict(_params(disc))
        state.disc_opt.load_state_dict(disc["optimizer"])
        print("Resume disc from epoch %d" % parse_epoch(disc_path))
    return state, epoch


def load_params(path: str, template):
    """Load one net's parameters from a checkpoint file (the port's, or a
    reference state_dict) into the module ``template``; the optimizer
    state stored beside them is ignored. Returns ``template``."""
    template.load_state_dict(_params(_load(path)))
    return template
