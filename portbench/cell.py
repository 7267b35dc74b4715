"""What one run of one cell knows (``Run``) and what it found
(``Outcome``), and the pieces every traffic kind shares: the program's
configuration from a configuration file, the seeds, the weights, and the
instrumentation that the benchmark wraps around the program's public
calls."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent

# implementation choices a configuration leaves at the program's defaults
IMPLEMENTATION = ("warp_backend", "warp_place", "warp_windowed")
# ``GANConfig`` fields that a configuration file sets: the model and its
# training recipe (the program's default where the file is silent)
MODEL_KEYS = ("image_size", "pose_dim", "use_input_pose", "warp_skip",
              "warp_agg", "gen_type", "num_stacks", "compute_dtype",
              "training_ratio", "learning_rate", "l1_penalty_weight",
              "gan_penalty_weight", "content_loss_layer",
              "nn_loss_area_size")
# keys of a configuration file that describe it and set nothing (and
# every ``*_parameters`` count)
DESCRIPTIVE = ("name", "source", "published_as", "num_transforms",
               "encoder_filters", "decoder_filters", "adam_betas",
               "published_batch_size", "assumed", "reduced")
# the run's seeds, in the order ``SeedSequence.spawn`` draws them
SEEDS = ("gen_weights", "disc_weights", "dropout", "traffic", "vgg_weights")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    cell: str
    config: dict               # configs/<config>.json
    mix: dict                  # traffic/<traffic>.json
    limits: dict               # workloads/<cell>.json "limits"
    seed: int
    seconds: float
    trace: bool
    device: object             # torch.device
    t_start: float             # perf_counter at the process's start
    notes: dict = dataclasses.field(default_factory=dict)

    def mark(self, phase: str) -> None:
        """Note the seconds since the process started at the end of a
        set-up phase."""
        import time
        self.notes.setdefault("setup_marks", {})[phase] = round(
            time.perf_counter() - self.t_start, 3)

    def seeds(self) -> dict:
        """Independent seeds of the run's weights, dropout draws and
        traffic, all from ``--seed``. A seed added later goes last:
        ``spawn(k)`` begins with ``spawn(k - 1)``, so the others stay."""
        kids = np.random.SeedSequence(self.seed).spawn(len(SEEDS))
        return {n: int(k.generate_state(1, np.uint64)[0] >> 1)
                for n, k in zip(SEEDS, kids)}

    def rng(self) -> np.random.Generator:
        return np.random.default_rng(self.seeds()["traffic"])

    @property
    def image_size(self) -> tuple:
        return tuple(self.config["image_size"])

    @property
    def pose_dim(self) -> int:
        return self.config["pose_dim"]

    @property
    def compute_dtype(self):
        import torch
        return getattr(torch, self.config["compute_dtype"])

    def program_config(self, batch: int):
        """The program's ``GANConfig`` of this configuration at ``batch``:
        the model and its recipe (``MODEL_KEYS``); every implementation
        choice at the program's default. Raises on a key of the file that
        is neither of ``MODEL_KEYS`` nor descriptive, so that none is
        dropped unread."""
        import torch
        from pose_transfer_torch.train.engine import GANConfig
        c = self.config
        unknown = sorted(k for k in c if k not in MODEL_KEYS
                         and k not in DESCRIPTIVE
                         and not k.endswith("_parameters"))
        if unknown:
            raise ValueError(f"configuration {c.get('name')!r}: the "
                             f"benchmark passes no key {unknown} to the "
                             "program")
        kwargs = {k: c[k] for k in MODEL_KEYS if k in c}
        if "image_size" in kwargs:
            kwargs["image_size"] = tuple(kwargs["image_size"])
        if "compute_dtype" in kwargs:
            kwargs["compute_dtype"] = getattr(torch, kwargs["compute_dtype"])
        return GANConfig(batch_size=batch, check_mode=False, **kwargs)

    def weights(self, which: str) -> dict:
        """The benchmark's weights of 'gen', 'disc' or 'vgg' (the content
        loss's VGG19), on the device."""
        from .reference import content, model
        from .weights import make_weights
        spec = {"gen": lambda: model.generator_spec(self.image_size,
                                                    self.pose_dim),
                "disc": lambda: model.discriminator_spec(self.pose_dim),
                "vgg": content.vgg_spec}[which]()
        return make_weights(spec, self.seeds()[f"{which}_weights"],
                            self.device)

    def note_implementation(self, cfg) -> None:
        """Record the implementation choices in effect (none is set by the
        configuration) and the program's fold environment variables."""
        import os

        from pose_transfer_torch.train.engine import auto_windowed
        self.notes["implementation"] = {
            **{k: getattr(cfg, k) for k in IMPLEMENTATION},
            "warp_windowed_resolved": auto_windowed(cfg, self.device),
            "env": {k: v for k, v in os.environ.items()
                    if k.startswith("PT_WARP_")}}


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window: object                   # trace.Window
    memory_peak_bytes: int
    attempted: int
    failed: int
    e2e: dict                        # end-to-end quantities besides setup_s
    checks: list                     # (name, value) compared with limits
    readings: dict                   # what the per-layer readers read
    info: dict = dataclasses.field(default_factory=dict)


# ------------------------------------------------------- instrumentation

def fold_launch_recorder():
    """Wrap ``ops.warp_fused.fold_place`` and ``fold_route`` to record the
    shapes of each call: → (records, undo). A record is (kernel, n, h, w,
    c, p, sy, sx, itemsize, emit_idx)."""
    from pose_transfer_torch.ops import warp_fused
    records = []
    saved = (warp_fused.fold_place, warp_fused.fold_route)

    def place(body, wins, mwins, zero_nb, offs, emit_idx=True):
        n, h, w, c = body.shape
        p, sy, sx = wins.shape[1:4]
        records.append(("fold_place", n, h, w, c, p, sy, sx,
                        body.element_size(), bool(emit_idx)))
        return saved[0](body, wins, mwins, zero_nb, offs, emit_idx)

    def route(g, idx, mask0, mwins, offs):
        n, h, w, c = g.shape
        p, sy, sx = mwins.shape[1:4]
        records.append(("fold_route", n, h, w, c, p, sy, sx,
                        g.element_size(), True))
        return saved[1](g, idx, mask0, mwins, offs)

    warp_fused.fold_place, warp_fused.fold_route = place, route

    def undo():
        warp_fused.fold_place, warp_fused.fold_route = saved

    return records, undo


def launch_counts() -> dict:
    """The program's counters: kernel launches by name
    (``ops.warp_fused.LAUNCHES``) and the fold instances that fell back
    to the full scan (``ops.warp.COUNTS``)."""
    from pose_transfer_torch.ops import warp, warp_fused
    return {**warp_fused.LAUNCHES, **warp.COUNTS}
