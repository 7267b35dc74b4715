"""The port's command-line entry points on the CPU: the flags against the JAX
package's, the whole flow ``make_synthetic_data → main → main --resume 1
→ test → evaluate`` with ``--device cpu``, the flags whose paths are not
ported, the refusal to run without a card unless asked for the CPU, and a
run on an installation without pandas and PIL.
"""

import contextlib
import io
import json
import os
import shutil
import sys

import pytest
import torch

from pose_transfer_tpu.cli import create_pairs as jcreate_pairs
from pose_transfer_tpu.cli.opts import Opts as JOpts
from pose_transfer_torch.cli import create_pairs, evaluate, main
from pose_transfer_torch.cli import make_synthetic_data, test as infer
from pose_transfer_torch.cli.opts import Opts
from pose_transfer_torch.data.loader import BatchStream
from pose_transfer_torch.train import checkpoint

torch.set_num_threads(2)


def _actions(opts_cls):
    p = opts_cls()
    p.init()
    return {a.dest: (a.option_strings, a.default, a.choices, a.type)
            for a in p.parser._actions if a.dest != "help"}


def test_opts_are_jax_flags_plus_device(tmp_path, monkeypatch):
    """Every JAX flag with its name, default, choices and type; --device
    (default cuda) is the one addition; the derived options agree."""
    mine, ref = _actions(Opts), _actions(JOpts)
    assert set(mine) - set(ref) == {"device"}
    assert mine.pop("device")[1] == "cuda"
    assert mine == ref
    monkeypatch.chdir(tmp_path)
    args = ["--exp_root", str(tmp_path / "exp")]
    got, want = vars(Opts().parse(args)), vars(JOpts().parse(args))
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["image_size"] == (224, 224) and got["pose_dim"] == 16


def _run(fn, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _flags(root, data, exp="t", **over):
    base = {"--expID": exp, "--data_Dir": data, "--dataset": "market",
            "--pose_dim": "18", "--batch_size": "2", "--iters_per_epoch": "2",
            "--number_of_epochs": "2", "--display_ratio": "1",
            "--checkpoint_ratio": "1", "--checkMode": "1",
            "--exp_root": str(root / "exp"), "--device": "cpu"}
    base.update({k: str(v) for k, v in over.items()})
    return [x for kv in base.items() for x in kv]


@pytest.fixture(scope="module")
def market_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = str(root / "data") + "/"
    out = _run(make_synthetic_data.main,
               ["--out", data, "--dataset", "market", "--pose_dim", "18"])
    assert "market dataset written" in out
    return root, data


def test_train_resume_test_evaluate_end_to_end(market_data, monkeypatch):
    """market (128×64) with the check-mode model: JAX's directory layout
    with .pt checkpoints; the resume re-runs epoch 2 after seeking the
    stream by iters × 3 batches; one grid per test batch; JAX's JSON
    keys."""
    root, data = market_data
    exp = root / "exp" / "t"
    out = _run(main.main, _flags(root, data))
    assert out.count("img/s") == 4
    assert sorted(os.listdir(exp / "models")) == [
        "disc_001.pt", "disc_002.pt", "gen_001.pt", "gen_002.pt"]
    grids = sorted(os.listdir(exp / "results" / "train"))
    assert grids == [f"epoch_00{e}_0000{i}.png" for e in (1, 2)
                     for i in (0, 1)]
    assert sorted(os.listdir(exp / "results" / "test")) == grids
    rows = [json.loads(ln) for ln in open(exp / "metrics.jsonl")]
    assert [(r["epoch"], r["it"]) for r in rows] == [(1, 0), (1, 1), (2, 0),
                                                     (2, 1)]
    assert all(r["images_per_sec"] > 0 for r in rows)

    seeks = []
    orig = BatchStream.seek_batches
    monkeypatch.setattr(BatchStream, "seek_batches",
                        lambda self, k: (seeks.append(k), orig(self, k))[1])
    out = _run(main.main, _flags(root, data, **{"--number_of_epochs": 3,
                                                "--resume": 1}))
    assert "Resume gen from epoch 2" in out and "Epoch : 2 " in out
    assert "Epoch : 1 " not in out
    assert seeks == [2 * 3]     # iters × (2·training_ratio + 1)
    assert (exp / "models" / "gen_003.pt").exists()
    state = torch.load(exp / "models" / "gen_003.pt", weights_only=True)
    assert state["step"] == 8      # epoch 2's 4 steps, then 2 × 2 again

    out = _run(infer.main, _flags(root, data, **{"--resume": 1}))
    assert "epoch-3 weights" in out
    # 4 people × 3 images → 24 ordered pairs, batch 2 → 12 grids
    assert sorted(os.listdir(exp / "results" / "generated")) == [
        f"images_batch_{b:05d}.png" for b in range(12)]

    line = _run(evaluate.main, _flags(root, data, **{
        "--resume": 1, "--max_batches": 2})).strip().splitlines()[-1]
    res = json.loads(line)
    assert list(res) == ["metric", "value", "l1", "psnr", "epoch",
                         "num_batches", "feat_l2", "feat_l1", "feat_nn",
                         "feat_layer"]
    assert res["epoch"] == 3 and res["num_batches"] == 2
    assert -1 <= res["value"] <= 1 and res["l1"] > 0


def test_profile_steps_write_a_trace(market_data):
    root, data = market_data
    out = _run(main.main, _flags(root, data, "p", **{
        "--number_of_epochs": 1, "--iters_per_epoch": 3,
        "--profile_steps": 1, "--display_ratio": 5}))
    assert "Wrote profiler trace" in out
    trace = root / "exp" / "p" / "trace" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]


@pytest.mark.parametrize("flag,value,item", [
    ("--warp_backend", "exact", "item 8"),
    ("--gen_type", "stacked", "item 7"),
    ("--gen_type", "unet", "item 7"),
    ("--weight_init", "gaussian", "item 7"),
    ("--content_loss_layer", "block1_conv2", "item 6"),
    ("--num_devices", "2", "item 10"),
])
def test_unported_flags_raise(market_data, flag, value, item):
    root, data = market_data
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §A {item}"):
        _run(main.main, _flags(root, data, "x", **{flag: value}))


@pytest.mark.parametrize("entry", [main, infer, evaluate])
def test_entry_points_need_a_card_unless_cpu(market_data, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    root, data = market_data
    argv = _flags(root, data, "c")
    argv = argv[:argv.index("--device")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(entry.main, argv)


def test_create_pairs_writes_the_jax_files(market_data, tmp_path):
    _, data = market_data
    texts = {}
    for side, fn in (("jax", jcreate_pairs.main), ("port", create_pairs.main)):
        out = str(tmp_path / side) + "/"
        os.makedirs(out)
        for f in os.listdir(data):
            if "annotation" in f:
                shutil.copy(os.path.join(data, f), out)
        _run(fn, ["--data_Dir", out, "--dataset", "market", "--pose_dim",
                  "16", "--write_iterative", "1", "--frame_diff", "1",
                  "--exp_root", str(tmp_path / f"exp_{side}")])
        texts[side] = {f: open(os.path.join(out, f)).read()
                       for f in sorted(os.listdir(out)) if "pairs" in f}
    assert len(texts["port"]) == 6 and texts["port"] == texts["jax"]


def test_h36m_runs_without_pandas_and_pil(tmp_path, monkeypatch):
    """The card's installation has neither: the port writes, reads, trains
    on, renders and scores an h36m PNG dataset (224², pose_dim 16) all the
    same."""
    for name in ("pandas", "PIL", "imageio", "msgpack"):
        monkeypatch.setitem(sys.modules, name, None)
    data = str(tmp_path / "data") + "/"
    _run(make_synthetic_data.main, ["--out", data, "--dataset", "h36m",
                                    "--pose_dim", "16", "--num_people",
                                    "2"])
    flags = _flags(tmp_path, data, **{
        "--dataset": "h36m", "--pose_dim": 16, "--number_of_epochs": 1,
        "--iters_per_epoch": 1})
    _run(main.main, flags)
    checkpoint.wait_for_saves()
    _run(infer.main, flags + ["--resume", "1"])
    res = json.loads(_run(evaluate.main, flags + [
        "--resume", "1", "--feat_layer", "none"]).strip().splitlines()[-1])
    assert res["epoch"] == 1 and res["num_batches"] == 1
    assert "feat_l2" not in res
    exp = tmp_path / "exp" / "t"
    assert (exp / "models" / "gen_001.pt").exists()
    assert os.listdir(exp / "results" / "generated")
