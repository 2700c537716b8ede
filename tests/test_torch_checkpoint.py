"""The port's checkpoint format against the JAX package's.

The port carries its own msgpack encoder and decoder (the card's machine
has no `msgpack`) and its own walk over the tree (no `jax.tree.map`).
Files must cross both ways: a port-written checkpoint restores through
`repro.checkpoint.restore_checkpoint` to equal arrays and meta, and the
reverse; the payload bytes equal `msgpack.packb(..., use_bin_type=True)`,
both on `OutcomeStore.save`'s payloads and on a mixed tree.
"""
import os

import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.control import OutcomeStore as JaxOutcomeStore
from repro.router.gateway import OutcomeEvent as JaxOutcomeEvent
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.checkpoint import msgpack_ckpt
from repro_torch.control import OutcomeStore
from repro_torch.router.gateway import OutcomeEvent


def _tree(rng):
    """A mixed tree: unsorted keys, nested lists and tuples, 0-d and empty
    arrays, several dtypes."""
    return {
        "zeta": rng.normal(size=(3, 4)).astype(np.float32),
        "alpha": {"w": rng.integers(-5, 5, size=(7,)).astype(np.int64),
                  "mask": rng.random(5) > 0.5,
                  "step": np.int64(12), "lr": np.float64(3e-4)},
        "layers": [rng.normal(size=(2,)).astype(np.float64),
                   (np.zeros((0, 3), np.float32), np.arange(4, dtype=np.int32))],
        "half": rng.normal(size=(2, 2)).astype(np.float16),
    }


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{p}": v for k in sorted(tree) for p, v in _flat(tree[k]).items()}
    if isinstance(tree, (list, tuple)):
        return {f"{i}/{p}": v for i, x in enumerate(tree) for p, v in _flat(x).items()}
    return {"": np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k])


def _payload(path):
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:4] == b"CKPT"
    return msgpack_ckpt._decompress(blob)


META = {"kind": "test", "n": 3, "ratio": 0.25, "ok": True, "none": None, "name": "x" * 40}
CODEC = "zstd" if msgpack_ckpt.zstandard is not None else "zlib"


def test_port_checkpoint_restores_in_jax_and_back(tmp_path):
    tree = _tree(np.random.default_rng(0))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(port_dir, 7, tree, META)
    jax_save(jax_dir, 7, tree, META)
    step, restored, meta = jax_restore(port_dir)
    assert step == 7 and meta == dict(META, codec=CODEC)
    _assert_trees_equal(restored, tree)
    step, restored, meta = restore_checkpoint(jax_dir)
    assert step == 7 and meta == dict(META, codec=CODEC)
    _assert_trees_equal(restored, tree)
    # the same tree gives the same bytes: dict keys sorted, buffers in order
    assert _payload(os.path.join(port_dir, "step_00000007.ckpt")) == _payload(
        os.path.join(jax_dir, "step_00000007.ckpt"))


def test_tensors_are_saved_from_any_device_as_numpy(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 3, generator=g), "b": torch.zeros(3, dtype=torch.int64),
            "grad": torch.ones(2, requires_grad=True) * 2}
    save_checkpoint(str(tmp_path), 0, tree)
    _, restored, _ = jax_restore(str(tmp_path))
    for k, v in tree.items():
        np.testing.assert_array_equal(restored[k], v.detach().numpy())
        assert restored[k].dtype == v.detach().numpy().dtype


def _stores(n_events=40, capacity=30):
    rng = np.random.default_rng(1)
    jax_store, store = JaxOutcomeStore(n_tools=9, capacity=capacity), OutcomeStore(
        n_tools=9, capacity=capacity)
    for i in range(n_events):
        toks = rng.integers(0, 2**40, size=rng.integers(1, 12))
        tool, out, ts = int(rng.integers(9)), int(rng.integers(2)), 1.7e9 + i / 3
        jax_store.append(JaxOutcomeEvent(toks, tool, out, ts))
        store.append(OutcomeEvent(toks, tool, out, ts))
    return jax_store, store


@pytest.mark.parametrize("n_events", [0, 1, 40])
def test_outcome_store_payload_bytes_equal_msgpack(tmp_path, n_events):
    jax_store, store = _stores(n_events)
    a = store.save(str(tmp_path / "port"), step=2)
    b = jax_store.save(str(tmp_path / "jax"), step=2)
    raw_port, raw_jax = _payload(a), _payload(b)
    assert raw_port == raw_jax
    obj = msgpack.unpackb(raw_jax, raw=False)
    assert msgpack_ckpt.packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert msgpack_ckpt.unpackb(raw_jax) == obj
    # and the stores cross: each restores the other's window
    for restore, path, want in ((OutcomeStore.restore, str(tmp_path / "jax"), jax_store),
                                (JaxOutcomeStore.restore, str(tmp_path / "port"), store)):
        got = restore(path)
        assert (got.total_ingested, got.dropped, len(got)) == (
            want.total_ingested, want.dropped, len(want))
        assert got.window_fingerprint() == want.window_fingerprint()
        for x, y in zip(got.snapshot_events(), want.snapshot_events()):
            np.testing.assert_array_equal(x.query_tokens, y.query_tokens)
            assert (x.tool_id, x.outcome, x.timestamp) == (y.tool_id, y.outcome, y.timestamp)


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -2.5, 1e300, "", "a" * 31, "a" * 32, "é" * 200, "b" * 70_000, b"", b"x" * 255,
    b"x" * 256, b"y" * 70_000, [], list(range(15)), list(range(16)), list(range(70_000)),
    {}, {str(i): i for i in range(15)}, {str(i): [i, None] for i in range(16)},
    {"nested": {"deep": [1, 2.5, b"z", None, ("t", True)]}},
])
def test_packb_equals_msgpack_and_unpackb_inverts(value):
    data = msgpack.packb(value, use_bin_type=True)
    assert msgpack_ckpt.packb(value) == data
    assert msgpack_ckpt.unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


def test_codec_errors_are_explicit(tmp_path, monkeypatch):
    with pytest.raises(TypeError):
        msgpack_ckpt.packb({"a": np.int64(1)})  # as msgpack: not a Python int
    with pytest.raises(ValueError):
        msgpack_ckpt.unpackb(msgpack.packb([1, 2, 3])[:-1])
    with pytest.raises(ValueError):
        msgpack_ckpt.unpackb(msgpack.packb(1) + b"\x00")
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path))
    monkeypatch.setattr(msgpack_ckpt, "zstandard", None)  # the card's machine: zlib only
    path = save_checkpoint(str(tmp_path), 3, {"a": np.ones(2)})
    assert latest_step(str(tmp_path)) == 3
    _, restored, meta = restore_checkpoint(str(tmp_path))
    assert meta["codec"] == "zlib" and restored["a"].tolist() == [1.0, 1.0]
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:5] == b"CKPT\x02"
    with open(path, "wb") as f:
        f.write(b"CKPT\x01" + blob[5:])  # claims zstd
    with pytest.raises(RuntimeError, match="zstandard"):
        restore_checkpoint(str(tmp_path))
    with open(path, "wb") as f:
        f.write(b"NOPE" + blob[5:])
    with pytest.raises(ValueError, match="bad magic"):
        restore_checkpoint(str(tmp_path))
