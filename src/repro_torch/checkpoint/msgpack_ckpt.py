"""Msgpack + compressed pytree checkpointing, in the JAX package's format.

Counterpart of `repro/checkpoint/msgpack_ckpt.py`: files written by either
package restore in the other. Layout: a single `.ckpt` file = a 5-byte
codec header (`b"CKPT" + codec id`) followed by the compressed msgpack of
  {"meta": {...}, "step": int, "tree": <nested dicts>, "arrays": [raw buffers]}
Arrays are stored as {"__array__": [dtype, shape, index]} leaves referencing
the buffer list. Step-numbered files + a LATEST pointer give atomic-ish
rotation.

Three dependencies of the reference are replaced:

* `jax.tree.map` by `_to_host`, a walk over dicts (keys sorted, as a JAX
  pytree orders them), lists and tuples (a NamedTuple, such as an
  optimizer state, becomes a list in its field order) that brings every
  leaf to host numpy (`.detach().cpu().numpy()` for tensors);
* numpy's `bfloat16` (from `ml_dtypes`, which the port does not need):
  a bfloat16 tensor is written as its 16-bit patterns under the dtype name
  "bfloat16", as the JAX package writes a bf16 array, and a "bfloat16"
  buffer is read back as a `torch.bfloat16` tensor on the CPU (every other
  leaf comes back as a numpy array);
* the `msgpack` package by `packb` / `unpackb` below, which cover exactly
  the types a checkpoint holds: dict, list, tuple, str, bytes, int, float,
  bool and None, with `use_bin_type=True` semantics (str as the str family,
  bytes as the bin family, floats as float 64, every int in its smallest
  encoding), so the bytes equal `msgpack.packb(obj, use_bin_type=True)`.

Compression codec: `zstandard` when importable, else stdlib `zlib`; the
codec id in the header makes files self-describing.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib
    zstandard = None

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "packb", "unpackb"]

_MARKER = "__array__"
_MAGIC = b"CKPT"
_CODEC_ZSTD = b"\x01"
_CODEC_ZLIB = b"\x02"
_ZSTD_FRAME_MAGIC = b"\x28\xb5\x2f\xfd"  # legacy headerless files


# ------------------------------------------------------------------ msgpack
def _pack_len(out: bytearray, n: int, fix_base: Optional[int], fix_max: int,
              codes: Tuple[Optional[int], int, int]) -> None:
    """A length header: fix form below `fix_max`, else 8/16/32-bit."""
    c8, c16, c32 = codes
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
    elif c8 is not None and n <= 0xFF:
        out += struct.pack(">BB", c8, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", c16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError(f"msgpack length {n} does not fit 32 bits")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2**64 - 1)):
            if n <= top:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(f"int {n} too large for msgpack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                               (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -2**63)):
            if n >= low:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(f"int {n} too small for msgpack")


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """`msgpack.packb(obj, use_bin_type=True)` for the checkpoint's types."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# (format, kind) of each fixed-width header byte
_HEADS = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xCB: (">d", "value"),
    0xCC: (">B", "value"), 0xCD: (">H", "value"), 0xCE: (">I", "value"),
    0xCF: (">Q", "value"), 0xD0: (">b", "value"), 0xD1: (">h", "value"),
    0xD2: (">i", "value"), 0xD3: (">q", "value"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


def _unpack(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None
    elif b in (0xC2, 0xC3):
        return b == 0xC3
    elif b in _HEADS:
        fmt, kind = _HEADS[b]
        n = r.unpack(fmt)
        if kind == "value":
            return n
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    """`msgpack.unpackb(data, raw=False)` for the checkpoint's types."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


# --------------------------------------------------------------- compression
def _compress(payload: bytes) -> bytes:
    if zstandard is not None:
        return _MAGIC + _CODEC_ZSTD + zstandard.ZstdCompressor(level=3).compress(payload)
    return _MAGIC + _CODEC_ZLIB + zlib.compress(payload, 3)


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _MAGIC:
        codec, body = blob[4:5], blob[5:]
        if codec == _CODEC_ZLIB:
            return zlib.decompress(body)
        if codec == _CODEC_ZSTD:
            if zstandard is None:
                raise RuntimeError(
                    "checkpoint was written with zstd but zstandard is not installed"
                )
            return zstandard.ZstdDecompressor().decompress(body, max_output_size=1 << 34)
        raise ValueError(f"unknown checkpoint codec id {codec!r}")
    if blob[:4] == _ZSTD_FRAME_MAGIC:  # legacy headerless zstd checkpoint
        if zstandard is None:
            raise RuntimeError("legacy zstd checkpoint requires the zstandard package")
        return zstandard.ZstdDecompressor().decompress(blob, max_output_size=1 << 34)
    raise ValueError("not a recognized checkpoint file (bad magic)")


# ------------------------------------------------------------------- pytrees
def _to_host(tree: Any) -> Any:
    """`jax.tree.map(np.asarray, tree)`: dicts come back key-sorted."""
    if isinstance(tree, dict):
        return {k: _to_host(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:  # numpy has no bfloat16: keep the tensor
            return tree.detach().cpu()
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _encode(tree: Any, buffers: list) -> Any:
    if isinstance(tree, dict):
        return {k: _encode(v, buffers) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_encode(v, buffers) for v in tree]
    if isinstance(tree, torch.Tensor):  # bfloat16, from _to_host
        buffers.append(tree.contiguous().view(torch.int16).numpy().tobytes())
        return {_MARKER: ["bfloat16", list(tree.shape), len(buffers) - 1]}
    arr = np.asarray(tree)
    buffers.append(arr.tobytes())
    return {_MARKER: [str(arr.dtype), list(arr.shape), len(buffers) - 1]}


def _decode(tree: Any, buffers: list) -> Any:
    if isinstance(tree, dict):
        if _MARKER in tree:
            dtype, shape, idx = tree[_MARKER]
            if dtype == "bfloat16":
                bits = np.frombuffer(buffers[idx], dtype=np.int16).reshape(shape).copy()
                return torch.from_numpy(bits).view(torch.bfloat16)
            return np.frombuffer(buffers[idx], dtype=dtype).reshape(shape).copy()
        return {k: _decode(v, buffers) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_decode(v, buffers) for v in tree]
    return tree


def save_checkpoint(
    directory: str, step: int, tree: Any, meta: Optional[Dict] = None
) -> str:
    os.makedirs(directory, exist_ok=True)
    buffers: list = []
    enc = _encode(_to_host(tree), buffers)
    meta = dict(meta or {})
    meta.setdefault("codec", "zstd" if zstandard is not None else "zlib")
    payload = packb({"meta": meta, "step": step, "tree": enc, "arrays": buffers})
    path = os.path.join(directory, f"step_{step:08d}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_compress(payload))
    os.replace(tmp, path)  # atomic rotate
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    return path


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_checkpoint(
    directory: str, step: Optional[int] = None
) -> Tuple[int, Any, Dict]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}.ckpt")
    with open(path, "rb") as f:
        obj = unpackb(_decompress(f.read()))
    return obj["step"], _decode(obj["tree"], obj["arrays"]), obj["meta"]
