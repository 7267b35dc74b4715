"""The port's span recorder (``pose_transfer_torch.utils.spans``) on the
CPU: free and silent with no profiler; under ``torch.profiler`` the spans
of an eval step, a training step (L1 and the content loss) and the
server, with their parents, on
the profiler's clock, on the batcher thread that the profiler itself does
not see; the fold's branch beside ``COUNTS['scan_fallback']``; a full
buffer dropping its oldest records."""

import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pose_transfer_torch.data.synthetic import (random_image, random_skeleton,
                                                synthetic_compact_batch)
from pose_transfer_torch.models import networks, vgg
from pose_transfer_torch.ops import warp
from pose_transfer_torch.serve import PoseTransferServer
from pose_transfer_torch.train import engine
from pose_transfer_torch.utils import spans

torch.set_num_threads(2)

SIZE = (64, 64)
ENC = (8, 16, 16, 16)
DEC = (16, 16, 16, 3)
# the 64² stage takes the windowed fold, so that the plan has a host sync
CFG = engine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                       warp_windowed=True)
FOLDS = {f"fold.fwd.{s}x{s}" for s in (64, 32, 16, 8)}
GEN = {"gen.encoder_app", "gen.encoder_pose", "gen.decoder", "fold.plan",
       "fold.plan_sync"} | FOLDS
# the reference code's full_fasion recipe at a 3 × 3 area
CONTENT = dataclasses.replace(CFG, content_loss_layer="block1_conv2",
                              nn_loss_area_size=3, l1_penalty_weight=1.0)


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


def _gen(seed=0):
    """The narrow generator of the server tests, windowed at 64²."""
    gen = networks.DeformableGenerator(18, SIZE, ENC, DEC,
                                       warp_windowed=True)
    networks.init_weights(gen, torch.Generator().manual_seed(seed))
    return gen.eval()


def _requests(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(random_image(rng, SIZE),
             random_skeleton(rng, SIZE, 18).astype(np.float32),
             random_skeleton(rng, SIZE, 18).astype(np.float32))
            for _ in range(n)]


def _batch(seed=0):
    return synthetic_compact_batch(np.random.default_rng(seed), 2, SIZE, 18)


def _train_step(cfg=CFG):
    disc = networks.Discriminator(cfg.input_nc + 3, check_mode=True)
    networks.init_weights(disc, torch.Generator().manual_seed(1))
    gen = _gen()
    state = engine.TrainState(
        gen=gen, disc=disc,
        gen_opt=engine.make_optimizer(cfg, gen.parameters()),
        disc_opt=engine.make_optimizer(cfg, disc.parameters()),
        rng=torch.Generator().manual_seed(2),
        vgg=None if cfg.content_loss_layer == "none"
        else vgg.random_vgg19_features(0, "cpu"))
    return engine.make_train_step(cfg, state)


def _run_eval():
    engine.make_eval_step(CFG, _gen(), "cpu")(_batch())


def _run_train(cfg=CFG):
    stack = lambda b: {k: v[None] for k, v in b.items()}  # noqa: E731
    _train_step(cfg)(stack(_batch(0)), stack(_batch(1)), _batch(2))


def _run_server():
    with PoseTransferServer(CFG, _gen(), device="cpu") as srv:
        srv.generate(_requests(3))


def _by_name(recs):
    out = collections.defaultdict(list)
    for r in recs:
        out[r.name].append(r)
    return out


def _parent(recs):
    names = {r.id: r.name for r in recs}
    return lambda r: names.get(r.parent)


@pytest.mark.parametrize("work", ["span", "sample", "eval", "train",
                                  "content", "server"])
def test_no_profiler_no_range_no_record(work, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    if work == "span":
        with spans.span("x", a=1) as s:
            s.set(b=2)
    elif work == "sample":
        spans.sample("x", 1.0, a=1)
    else:
        {"eval": _run_eval, "train": _run_train, "server": _run_server,
         "content": lambda: _run_train(CONTENT)}[work]()
    assert spans.records() == [] and spans.dropped() == 0


@pytest.mark.parametrize("work", ["eval", "train"])
def test_step_spans_and_parents(work):
    with profile(activities=[ProfilerActivity.CPU]):
        (_run_eval if work == "eval" else _run_train)()
    recs = spans.records()
    by, parent = _by_name(recs), _parent(recs)
    assert all(r.end_ns >= r.start_ns for r in recs)
    assert all(by["fold.plan_sync"]) and all(
        parent(r) == "fold.plan" for r in by["fold.plan_sync"])
    assert {r.attrs["instances"] for r in by["fold.plan"]} == {4}
    assert {r.attrs["branch"] for r in by["fold.fwd.64x64"]} <= {"place",
                                                                 "xla",
                                                                 "fallback"}
    assert {r.attrs["branch"] for r in by["fold.fwd.8x8"]} == {"scan"}
    if work == "eval":
        assert set(by) == GEN | {"step.prepare"}
        # one forward: every span once, none inside another but the sync
        assert all(len(v) == 1 for v in by.values())
        assert {parent(r) for r in recs if r.name != "fold.plan_sync"} \
            == {None}
        return
    phases = {"train.disc_phase", "train.gen_phase"}
    bwd = {f"fold.bwd.{s}x{s}" for s in (64, 32, 16, 8)}
    assert set(by) == GEN | phases | bwd | {
        "step.prepare", "train.backward", "train.optimizer"}
    # the disc phase: two preparations, a generator forward, its update
    assert [parent(r) for r in by["step.prepare"]] == [
        "train.disc_phase", "train.disc_phase", "train.gen_phase"]
    for name in GEN - {"fold.plan_sync"}:
        assert sorted(parent(r) for r in by[name]) == sorted(phases), name
    for name in ("train.backward", "train.optimizer"):
        assert sorted(parent(r) for r in by[name]) == sorted(phases)
    assert [r.attrs["step"] for r in by["train.gen_phase"]] == [0]
    # the CPU's autograd runs the fold's backward on the calling thread
    for name in bwd:
        (r,) = by[name]
        assert parent(r) == "train.backward"
        assert r.attrs["branch"] == by[name.replace("bwd", "fwd")][
            1].attrs["branch"]


def test_content_loss_spans():
    """A content-loss step: the VGG19 prefix of both images in one
    ``content.features``, the forward in ``content.nn_loss``, both in the
    generator phase; the backward's ``content.nn_loss.bwd`` inside its
    ``train.backward`` (the CPU's autograd runs it on the calling
    thread); each with the area; none in the discriminator phase."""
    with profile(activities=[ProfilerActivity.CPU]):
        _run_train(CONTENT)
    recs = spans.records()
    by, parent = _by_name(recs), _parent(recs)
    content = {"content.features", "content.nn_loss", "content.nn_loss.bwd"}
    assert content <= set(by)
    for name in content:
        (r,) = by[name]
        assert r.attrs == {"area": "3x3"}
        assert r.end_ns >= r.start_ns
    assert parent(by["content.features"][0]) == "train.gen_phase"
    assert parent(by["content.nn_loss"][0]) == "train.gen_phase"
    assert by["content.features"][0].end_ns \
        <= by["content.nn_loss"][0].start_ns
    (bwd,) = by["content.nn_loss.bwd"]
    assert parent(bwd) == "train.backward"
    gen_backward = [r for r in by["train.backward"]
                    if parent(r) == "train.gen_phase"]
    assert [r.id for r in gen_backward] == [bwd.parent]


def test_span_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("warm"):
            pass
        with spans.span("clocked"):
            torch.ones(64, 64).sum()
    (rec,) = [r for r in spans.records() if r.name == "clocked"]
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "clocked"]
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    assert abs(rec.start_ns - start) < 2e6 and abs(rec.end_ns - end) < 2e6


def test_server_spans_on_a_thread_started_before_the_profiler():
    reqs = _requests(3)
    # a long admission window: the first batch fills, the third request
    # waits alone and its batch is padded
    with PoseTransferServer(CFG, _gen(), max_wait_ms=500.0,
                            device="cpu") as srv:
        srv.generate(reqs[:1])                     # warm-up, untraced
        batcher = srv._thread.native_id
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            srv.generate(reqs)
    recs = spans.records()
    by, parent = _by_name(recs), _parent(recs)
    # the profiler saw no range of the batcher; the recorder did
    assert "serve.batch" not in {e.name() for e in
                                 prof.profiler.kineto_results.events()}
    batches = by["serve.batch"]
    assert [b.attrs["rows"] for b in batches] == [2, 1]
    assert {b.thread for b in batches} == {batcher}
    submits = by["serve.submit"]
    reqs_sent = [r.attrs["req"] for r in submits]
    assert len(set(reqs_sent)) == 3
    assert [q for b in batches for q in b.attrs["reqs"]] == reqs_sent
    assert all(len(b.attrs["reqs"]) == b.attrs["rows"] for b in batches)
    assert [parent(r) for r in by["serve.fit"]] == ["serve.submit"] * 3
    assert [r.attrs["req"] for r in by["serve.fit"]] == reqs_sent
    waits = by["serve.queue_wait"]
    assert sorted(w.attrs["req"] for w in waits) == sorted(reqs_sent)
    batch_of = {q: b.attrs["batch"] for b in batches
                for q in b.attrs["reqs"]}
    assert all(w.attrs["batch"] == batch_of[w.attrs["req"]]
               and w.attrs["value"] >= 0 for w in waits)
    for name in ("serve.collect", "serve.collate", "serve.step",
                 "serve.fetch", "serve.deliver"):
        assert [parent(r) for r in by[name]] == ["serve.batch"] * 2, name
        assert [r.attrs["batch"] for r in by[name]] == [
            b.attrs["batch"] for b in batches]
    assert [parent(r) for r in by["step.prepare"]] == ["serve.step"] * 2
    assert {parent(r) for r in by["gen.decoder"]} == {"serve.step"}


@pytest.mark.parametrize("masks, branch, fell_back", [
    ("ones", "fallback", 1),     # every part's support is the whole image
    ("point", "xla", 0),         # a few pixels: every window fits
])
def test_fold_branch_follows_the_fallback_count(masks, branch, fell_back):
    n, t, c = 1, 10, 4
    feats = torch.rand(n, *SIZE, c)
    warps = torch.tensor([1, 0, 0, 0, 1, 0, 0, 0], dtype=torch.float32)
    warps = warps.expand(n, t, 8).contiguous()
    m = torch.ones(n, t, *SIZE)
    if masks == "point":
        m = torch.zeros(n, t, *SIZE)
        m[:, :, 30:34, 30:34] = 1.0
    before = warp.COUNTS["scan_fallback"]
    with profile(activities=[ProfilerActivity.CPU]):
        warp.affine_transform_layer(feats, warps, m, SIZE, windowed=True,
                                    place_impl="xla")
    (rec,) = [r for r in spans.records() if r.name == "fold.fwd.64x64"]
    assert rec.attrs["branch"] == branch
    assert warp.COUNTS["scan_fallback"] - before == fell_back


def test_full_buffer_drops_the_oldest(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", collections.deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(6):
            with spans.span("s", i=i):
                pass
        spans.sample("v", 7.0)
    assert [r.attrs.get("i") for r in spans.records()] == [3, 4, 5, None]
    assert spans.records()[-1].attrs["value"] == 7.0
    assert spans.dropped() == 3


def test_parents_are_per_thread():
    inner = {}

    def other():
        with spans.span("other") as s:
            inner["id"] = s.id

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            th = threading.Thread(target=other)
            th.start()
            th.join(timeout=30)
            with spans.span("child"):
                pass
    assert not th.is_alive()
    by, parent = _by_name(spans.records()), _parent(spans.records())
    assert parent(by["other"][0]) is None
    assert parent(by["child"][0]) == "outer"
