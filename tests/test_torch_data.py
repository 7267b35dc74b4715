"""The port's data pipeline against the JAX package's: annotation and pair
files, the PNG codec, the synthetic dataset writer, the dataset's compact
samples and the loader's index sequence; and the port's imports on an
installation without pandas, PIL, imageio and msgpack.

Every comparison is exact: the files' text, the decoded pixels, the
samples' arrays and the index sequences agree bit for bit.
"""

import io
import os
import subprocess
import sys
import zlib
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
from PIL import Image

from pose_transfer_tpu.data import pairs as jpairs
from pose_transfer_tpu.data import synthetic as jsyn
from pose_transfer_tpu.data.dataset import PoseTransferDataset as JDataset
from pose_transfer_tpu.data.loader import BatchStream as JStream
from pose_transfer_torch.data import annotations as tann
from pose_transfer_torch.data import pairs as tpairs
from pose_transfer_torch.data import synthetic as tsyn
from pose_transfer_torch.data.dataset import PoseTransferDataset
from pose_transfer_torch.data.loader import BatchStream, sample_stream
from pose_transfer_torch.utils import image_io

SIZE = (64, 48)


def _write_both(root, dataset, pose_dim, style="noise", people=3, per=4):
    """The same seed through the JAX writer (JPEG) and the port's (PNG)."""
    jdir, tdir = str(root / "jax") + "/", str(root / "port") + "/"
    kw = dict(dataset=dataset, pose_dim=pose_dim, num_people=people,
              images_per_person=per, img_size=SIZE, seed=3, style=style)
    jsyn.write_synthetic_dataset(jdir, **kw)
    tsyn.write_synthetic_dataset(tdir, **kw)
    return jdir, tdir


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return {pd_: _write_both(root / str(pd_), name, pd_)
            for pd_, name in ((18, "fasion"), (16, "h36m"))}


def _text(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("pose_dim", [18, 16])
def test_writer_files_match_jax_text(datasets, pose_dim):
    """Annotation and pair files: the JAX writer's text, .jpg read .png;
    the same image files, one .png for each .jpg."""
    jdir, tdir = datasets[pose_dim]
    files = sorted(f for f in os.listdir(jdir) if f.endswith(".csv"))
    assert files == sorted(f for f in os.listdir(tdir) if f.endswith(".csv"))
    assert len(files) == 8
    for f in files:
        want = _text(os.path.join(jdir, f)).replace(".jpg", ".png")
        assert _text(os.path.join(tdir, f)) == want, f
    ds = "fasion" if pose_dim == 18 else "h36m"
    for split in ("train", "test"):
        sub = f"{ds}-dataset/{split}"
        jimgs = sorted(os.listdir(os.path.join(jdir, sub)))
        timgs = sorted(os.listdir(os.path.join(tdir, sub)))
        assert timgs == [n.replace(".jpg", ".png") for n in jimgs]


@pytest.mark.parametrize("style", ["noise", "skeleton"])
def test_writer_pixels_are_the_jax_draws(tmp_path, style):
    """Each PNG decodes to the array the JAX functions draw from the same
    seed (the JAX writer then saves it lossily as JPEG)."""
    _, tdir = _write_both(tmp_path, "h36m", 16, style, people=2, per=2)
    rng = np.random.default_rng(3)
    for split in ("train", "test"):
        for p in range(2):
            for i in range(2):
                kp = jsyn.random_skeleton(rng, SIZE, 16)
                want = jsyn.skeleton_image(kp, SIZE, 16) \
                    if style == "skeleton" else jsyn.random_image(rng, SIZE)
                got = image_io.read_image(os.path.join(
                    tdir, f"h36m-dataset/{split}/{split}p{p:03d}_{i:04d}.png"))
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pose_dim", [18, 16])
def test_annotation_reader_matches_pandas(datasets, pose_dim):
    jdir, _ = datasets[pose_dim]
    ds = "fasion" if pose_dim == 18 else "h36m"
    tr = os.path.join(jdir, f"{ds}-annotation-train.csv")
    te = os.path.join(jdir, f"{ds}-annotation-test.csv")
    want = pd.concat([pd.read_csv(p, sep=":") for p in (tr, te)],
                     ignore_index=True).set_index("name")
    got = tann.merge_annotations(tr, te)
    assert list(got) == list(want.index)
    for name, row in want.iterrows():
        assert got[name] == dict(row)
        np.testing.assert_array_equal(tann.load_keypoints(got[name]),
                                      tann.load_keypoints(row))


def _names(n_people=3, frames=25, acts=(2, 14)):
    return [f"S{p}_act_{a:02d}_cam_{c}_{f:04d}.jpg" for p in range(n_people)
            for a in acts for c in (1, 2) for f in range(frames)]


@pytest.mark.parametrize("fn", ["make_pair_nonvid", "make_pairs",
                                "make_pairs_restricted",
                                "make_pairs_iterative"])
def test_pair_builders_match_pandas(fn, tmp_path):
    """Same rows in the same order; the CSV text of to_csv(index=False)."""
    names = _names()
    rng = np.random.default_rng(0)
    names = [names[i] for i in rng.permutation(len(names))]  # interleaved
    want = getattr(jpairs, fn)(pd.DataFrame({"name": names}))
    got = getattr(tpairs, fn)(names)
    assert list(got) == list(want.columns)
    for col in got:
        assert got[col] == list(want[col]), col
    assert tpairs.num_rows(got) == len(want) > 0
    tpairs.write_csv(got, str(tmp_path / "t.csv"))
    want.to_csv(tmp_path / "j.csv", index=False)
    assert _text(tmp_path / "t.csv") == _text(tmp_path / "j.csv")
    assert tpairs.read_csv(str(tmp_path / "t.csv")) == got


@pytest.mark.parametrize("n", [1, 17, 600])
def test_sample_rows_is_dataframe_sample(n):
    table = tpairs.make_pair_nonvid(_names(frames=5))
    want = pd.DataFrame(table).sample(n=n, replace=False, random_state=0)
    got = tpairs.sample_rows(table, n)
    assert got == {k: list(want[k]) for k in want.columns}


@pytest.mark.parametrize("check_mode", [0, 1])
@pytest.mark.parametrize("pose_dim", [18, 16])
def test_write_pair_files_matches_jax(datasets, tmp_path, pose_dim,
                                      check_mode):
    jdir, _ = datasets[pose_dim]
    ds = "fasion" if pose_dim == 18 else "h36m"
    outs = {}
    for side, fn in (("jax", jpairs.write_pair_files),
                     ("port", tpairs.write_pair_files)):
        out = tmp_path / side
        out.mkdir()
        opt = SimpleNamespace(
            pose_dim=pose_dim, images_for_train=7, images_for_test=100,
            checkMode=check_mode, write_iterative=1, frame_diff=1,
            annotations_file_train=os.path.join(
                jdir, f"{ds}-annotation-train.csv"),
            annotations_file_test=os.path.join(
                jdir, f"{ds}-annotation-test.csv"),
            **{f"pairs_file_{s}{x}": str(out / f"{s}{x}.csv")
               for s in ("train", "test")
               for x in ("", "_interpol", "_check", "_iterative")})
        outs[side] = (fn(opt), {f: _text(out / f)
                                for f in sorted(os.listdir(out))})
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1]) == (2 if check_mode else
                                    6 if pose_dim == 16 else 4)


# --------------------------------------------------------------- PNG codec

@pytest.mark.parametrize("shape", [(5, 7, 3), (64, 48, 3), (9, 4)])
def test_png_round_trip_is_exact(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "a.png")
    image_io.write_png(path, img)
    got = image_io.read_image(path)
    want = img if img.ndim == 3 else np.repeat(img[..., None], 3, axis=2)
    np.testing.assert_array_equal(got, want)
    with Image.open(path) as im:          # a valid PNG to another decoder
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), want)


def _filtered_png(img: np.ndarray, kind: int, color: int) -> bytes:
    """A PNG whose every scanline uses filter ``kind`` (the encoder side of
    the five filters, written out per the PNG specification)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, color, 0, 0, 0])
    return (image_io.PNG_SIGNATURE + image_io._chunk(b"IHDR", ihdr)
            + image_io._chunk(b"IDAT", zlib.compress(b"".join(out)))
            + image_io._chunk(b"IEND", b""))


@pytest.mark.parametrize("color,channels", [(2, 3), (6, 4), (0, 1), (4, 2)])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_takes_every_filter(kind, color, channels):
    """Each filter type and colour type, judged by PIL's decoder."""
    img = np.random.default_rng(kind).integers(0, 256, (11, 13, channels),
                                               np.uint8)
    data = _filtered_png(img, kind, color)
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(image_io.decode_png(data), want)


def test_png_reader_reads_pil_files(tmp_path):
    """PIL's adaptive filters, on a smooth image and on noise."""
    rng = np.random.default_rng(1)
    for i, img in enumerate((jsyn.random_image(rng, (40, 56)),
                             rng.integers(0, 256, (40, 56, 3), np.uint8))):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(image_io.read_image(path), img)


def test_png_reader_refuses_what_it_does_not_take(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.read_image(path)
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not an image")
    with pytest.raises(ValueError, match="x.png"):
        image_io.read_image(str(bad))


def test_jpeg_without_pil_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "a.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    assert image_io.read_image(path).shape == (8, 8, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="a.jpg.*PIL"):
        image_io.read_image(path)


# ---------------------------------------------------------------- dataset

def _opt(data_dir, dataset, pose_dim, check_mode=0):
    d = {"gen_type": "baseline", "num_stacks": 4, "pose_dim": pose_dim,
         "image_size": SIZE, "use_input_pose": 1, "warp_skip": "mask",
         "dataset": dataset, "checkMode": check_mode}
    for s in ("train", "test"):
        d[f"images_dir_{s}"] = f"{data_dir}{dataset}-dataset/{s}"
        d[f"annotations_file_{s}"] = f"{data_dir}{dataset}-annotation-{s}.csv"
        for x in ("", "-interpol", "-check"):
            d[f"pairs_file_{s}{x.replace('-', '_')}"] = \
                f"{data_dir}{dataset}-pairs-{s}{x}.csv"
    return d


@pytest.mark.parametrize("check_mode", [0, 1])
@pytest.mark.parametrize("pose_dim", [18, 16])
def test_item_compact_matches_jax(datasets, pose_dim, check_mode):
    """On the JAX writer's dataset (JPEG, decoded through PIL on both
    sides): every sample key for key, exactly; the warp cache returns what
    it stored."""
    jdir, _ = datasets[pose_dim]
    ds = "fasion" if pose_dim == 18 else "h36m"
    opt = _opt(jdir, ds, pose_dim, check_mode)
    for split in ("train", "test"):
        jd, td = JDataset(dict(opt), split), PoseTransferDataset(opt, split)
        assert len(td) == len(jd) > 0
        for i in range(len(td)):
            want, got = jd.item_compact(i), td.item_compact(i)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        again = td.item_compact(0)
        np.testing.assert_array_equal(again["warps"],
                                      jd.item_compact(0)["warps"])


def test_dataset_interpol_fallback_and_missing_images(datasets, tmp_path):
    """Without the -interpol files the plain pair files are read; a missing
    image is black; an undecodable one raises."""
    _, tdir = datasets[16]
    import shutil
    data = str(tmp_path / "d") + "/"
    shutil.copytree(tdir, data)
    for s in ("train", "test"):
        os.remove(f"{data}h36m-pairs-{s}-interpol.csv")
    ds = PoseTransferDataset(_opt(data, "h36m", 16), "train")
    assert ds.pair(0) == {"from": "trainp000_0000.png",
                          "to": "trainp000_0002.png"}
    os.remove(f"{data}h36m-dataset/train/trainp000_0000.png")
    np.testing.assert_array_equal(ds.load_image("trainp000_0000.png"),
                                  np.zeros((*SIZE, 3), np.uint8))
    with open(f"{data}h36m-dataset/train/trainp000_0001.png", "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nbroken")
    with pytest.raises(ValueError, match="trainp000_0001.png"):
        ds.load_image("trainp000_0001.png")


# ----------------------------------------------------------------- loader

@pytest.mark.parametrize("seek", [0, 5])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_stream_draws_the_jax_sequence(seek, shuffle):
    """Index for index, across reshuffles and after seek_batches."""
    data = list(range(11))
    j = JStream(data, 3, shuffle=shuffle, seed=7, num_threads=1)
    t = BatchStream(data, 3, shuffle=shuffle, seed=7, num_threads=1)
    j.seek_batches(seek)
    t.seek_batches(seek)
    for _ in range(12):
        np.testing.assert_array_equal(t.next_indices(), j.next_indices())
    assert t.epochs_completed == j.epochs_completed


def test_prefetcher_on_cpu_keeps_order_and_contents(datasets):
    """One worker: the batches of the plain stream, as CPU tensors."""
    _, tdir = datasets[18]
    ds = PoseTransferDataset(_opt(tdir, "fasion", 18), "train")
    plain = sample_stream(ds, 2, seed=1, prefetch=False, num_threads=2)
    pre = sample_stream(ds, 2, seed=1, device="cpu", num_workers=1,
                        num_threads=2)
    try:
        for _ in range(4):
            want, got = next(plain), next(pre)
            assert list(got) == list(want)
            for k in want:
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        pre.close()
        plain.close()


# ---------------------------------------------------------------- imports

def test_port_imports_no_jax_pandas_pil():
    """Importing every module of the port loads none of JAX, flax, optax,
    pandas, PIL, imageio, msgpack or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pose_transfer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = {'jax', 'flax', 'optax', 'pandas', 'PIL', 'imageio',\n"
        "       'msgpack', 'pose_transfer_tpu'}\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in bad))\n")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
