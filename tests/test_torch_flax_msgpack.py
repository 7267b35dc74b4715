"""The port's reader and writer of flax msgpack files against flax's own:
the files the JAX package's ``checkpoint.save`` writes, every msgpack
width, bfloat16, numpy scalars, chunked leaves and unknown extension types.

Every comparison is exact: the decoded arrays bit for bit (with their
dtypes; bfloat16 comes back as a ``torch.bfloat16`` tensor), the encoded
bytes byte for byte.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from pose_transfer_tpu.train import checkpoint as jcheckpoint
from pose_transfer_tpu.train import engine as jengine
from pose_transfer_torch.models.import_flax import _sorted
from pose_transfer_torch.utils import flax_msgpack

SIZE = (64, 64)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _as_np(x):
    """A decoded leaf as numpy; a bf16 tensor as its 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.bfloat16
        return x.view(torch.int16).numpy(), "bfloat16"
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.int16), "bfloat16"
    return x, x.dtype.name


def _assert_same_tree(got, want):
    """Same paths, types of container, dtypes and bits."""
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        if isinstance(b, (np.ndarray, np.generic, torch.Tensor)) or \
                hasattr(b, "dtype"):
            (xa, da), (xb, db) = _as_np(a), _as_np(b)
            assert da == db and xa.shape == xb.shape, path
            np.testing.assert_array_equal(xa, xb, err_msg=str(path))
            assert isinstance(a, np.generic) == isinstance(b, np.generic) \
                or isinstance(a, torch.Tensor), path
        else:
            assert type(a) is type(b) and a == b, path


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's checkpoint pair of a check-mode state (f32 params
    and Adam moments, int32 step and count, the uint32 rng key)."""
    root = tmp_path_factory.mktemp("jaxckpt")
    cfg = jengine.GANConfig(image_size=SIZE, pose_dim=18, batch_size=2,
                            check_mode=True)
    state, _, _ = jengine.create_state(cfg, seed=0)
    jcheckpoint.save(state, str(root), 3)
    return root


@pytest.mark.parametrize("net", ["gen", "disc"])
def test_decoder_reads_jax_checkpoints(jax_files, net):
    raw = (jax_files / f"{net}_003.msgpack").read_bytes()
    want = serialization.msgpack_restore(raw)
    got = flax_msgpack.restore(raw)
    _assert_same_tree(got, want)
    assert flax_msgpack.load(str(jax_files / f"{net}_003.msgpack")).keys() \
        == want.keys()
    if net == "gen":
        assert got["rng"].dtype == np.uint32 and got["step"].dtype == np.int32
        assert got["opt_state"]["1"] == {}
    # the encoder writes the file back byte for byte, in the file's order
    assert flax_msgpack.serialize(got) == raw


def _widths_tree():
    """Every msgpack width the encoder chooses, and flax's extension
    types."""
    rng = np.random.default_rng(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
            2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
            -2**31 - 1, -2**63]
    bf16 = np.asarray(jnp.asarray(rng.standard_normal((3, 5)),
                                  jnp.bfloat16))
    return {
        "a_ints": ints,
        "b_floats": [0.0, -1.5, 1e300, float("inf")],
        "c_str": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
                  "v" * 65536, "ünï"],
        "d_bytes": [b"", b"a" * 255, b"b" * 256, b"c" * 65536],
        "e_misc": [None, True, False],
        "f_lists": [list(range(15)), list(range(16)), [0] * 65536],
        "g_maps": {f"k{i:02d}": i for i in range(16)},
        "h_small_map": {f"k{i:02d}": i for i in range(15)},
        "i_arrays": {
            "bf16": bf16,
            "f32": rng.standard_normal((2, 3)).astype(np.float32),
            "f64": rng.standard_normal(4),
            "i8": np.arange(-5, 5, dtype=np.int8),
            "i64": np.asarray([-2**40, 2**40], np.int64),
            "u32": np.asarray([0, 2**32 - 1], np.uint32),
            "bool": np.asarray([True, False]),
            "empty": np.zeros((0, 3), np.float32),
            "scalar0d": np.asarray(7, np.int32),
            "big": rng.standard_normal(70000).astype(np.float32),
        },
        "j_npscalars": {"f32": np.float32(1.5), "i32": np.int32(-7),
                        "u8": np.uint8(200), "f64": np.float64(2.25),
                        "bf16": bf16[0, 0]},
    }


def test_encoder_bytes_equal_flax_and_decoder_inverts():
    tree = _sorted(_widths_tree())   # flax's msgpack_serialize sorts keys
    want = serialization.msgpack_serialize(tree)
    got = flax_msgpack.serialize(tree)
    assert got == want
    back = flax_msgpack.restore(got)
    _assert_same_tree(back, serialization.msgpack_restore(want))
    bf = back["i_arrays"]["bf16"]
    assert isinstance(bf, torch.Tensor) and bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(), tree["i_arrays"]["bf16"].astype(np.float32))
    assert isinstance(back["j_npscalars"]["f32"], np.float32)
    assert back["j_npscalars"]["bf16"].dtype == torch.bfloat16
    assert back["j_npscalars"]["bf16"].shape == ()
    # torch tensors encode as their numpy arrays (bf16 as flax writes it)
    as_torch = {"bf16": torch.tensor(tree["i_arrays"]["bf16"]
                                     .astype(np.float32)).bfloat16(),
                "f32": torch.tensor(tree["i_arrays"]["f32"])}
    assert flax_msgpack.serialize(as_torch) == serialization \
        .msgpack_serialize({"f32": tree["i_arrays"]["f32"],
                            "bf16": tree["i_arrays"]["bf16"]})


def test_encoder_keeps_the_given_key_order():
    """flax's msgpack_serialize sorts a dict's keys (JAX's tree_map does);
    ``to_bytes`` and the encoder keep the order given."""
    tree = {"params": {"z": np.ones(2, np.float32), "a": np.zeros(1)},
            "opt": {}}
    assert flax_msgpack.serialize(_sorted(tree)) == \
        serialization.msgpack_serialize(tree)
    assert flax_msgpack.serialize(tree) == serialization.msgpack_serialize(
        tree, in_place=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunked_leaves(monkeypatch, dtype):
    """Leaves above MAX_CHUNK_SIZE bytes (lowered to 64 for this test on
    both sides) are written as flax's chunked maps and joined on reading;
    a chunked leaf inside a list is not."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    big = np.asarray(jnp.asarray(rng.standard_normal((9, 11)) * 9,
                                 getattr(jnp, dtype)))
    tree = {"a": big, "b": {"c": big[:2], "d": np.ones(3, np.float32)},
            "e": [big]}
    raw = serialization.msgpack_serialize(tree)
    assert flax_msgpack.serialize(tree) == raw
    assert b"__msgpack_chunked_array__" in raw
    got = flax_msgpack.restore(raw)
    _assert_same_tree(got, serialization.msgpack_restore(raw))
    a, _ = _as_np(got["a"])
    assert a.shape == (9, 11)


@pytest.mark.parametrize("code", [2, 5, 127])
def test_unknown_ext_codes_raise(code):
    raw = msgpack.packb({"x": msgpack.ExtType(code, b"\x00" * 3)})
    with pytest.raises(ValueError, match=f"ext type {code}"):
        flax_msgpack.restore(raw)


def test_malformed_data_raises():
    raw = serialization.msgpack_serialize({"x": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(raw[:-3])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.restore(raw + b"\x00")
    with pytest.raises(ValueError, match="map key"):
        flax_msgpack.restore(b"\x81\x01\x02")          # {1: 2}
    with pytest.raises(TypeError, match="serialize"):
        flax_msgpack.serialize({"x": object()})
