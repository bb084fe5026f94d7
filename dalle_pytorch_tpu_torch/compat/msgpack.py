"""flax's msgpack checkpoint format, from the standard library and numpy.

The JAX package writes its checkpoints with ``flax.serialization``
(``msgpack_serialize`` for parameter trees, ``to_bytes`` for optax
state); neither flax nor the ``msgpack`` package is a dependency of the
port, so this module reads and writes the same bytes itself:

* ``packb(tree)`` is ``flax.serialization.msgpack_serialize(tree)``
  byte for byte: maps with their keys sorted (flax copies the tree with
  ``jax.tree_util.tree_map``, which sorts them), the shortest integer
  forms, str8 and bin types, float64 for Python floats, array leaves as
  msgpack extension 1 holding ``(shape, dtype name, C-order bytes)``,
  numpy scalars as extension 3, and array leaves held in a dict (or at
  the root) above ``MAX_CHUNK_SIZE`` bytes split into flax's
  ``{'__msgpack_chunked_array__': True, 'shape': ..., 'chunks': ...}``
  form. Tuples are refused, as flax's strict packer refuses them.
* ``unpackb(data)`` is ``msgpack_restore``: maps come back as dicts,
  msgpack arrays as lists, chunked leaves reassembled. Array leaves come
  back as numpy arrays, except ``bfloat16`` (no numpy dtype without
  ``ml_dtypes``), which comes back as a CPU ``torch.bfloat16`` tensor.
* ``to_state_dict(tree)`` is flax's ``to_state_dict`` over plain trees:
  lists and tuples become ``{'0': ..., '1': ...}`` maps, which is how
  ``to_bytes`` writes the optimizer state; ``from_state_dict`` reads it
  back into a tree's shape.

Array leaves may be numpy arrays or torch tensors (read on the CPU).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}


class MsgpackError(ValueError):
    """Bytes that are not a msgpack document this codec reads."""


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------

def _leaf_parts(x) -> tuple:
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return tuple(t.shape), _TORCH_NAMES[t.dtype], raw.numpy().tobytes()
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be "
                         "serialized")
    return a.shape, a.dtype.name, a.tobytes("C")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in pieces of MAX_CHUNK_SIZE
    bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(tree):
    """flax's ``_chunk_array_leaves_in_place`` without the in place: only
    leaves held in dicts (or the root) are chunked, as flax does."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                out[k] = _chunk(v)
            elif isinstance(v, dict):
                out[k] = _chunk_leaves(v)
            else:
                out[k] = v
        return out
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _decode_leaf(payload: bytes):
    shape, name, buf = unpackb(payload, raw=True, _chunked=False)
    name = name.decode()
    shape = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif n >= 0:
        for lim, code, fmt in ((0x100, 0xcc, ">BB"), (0x10000, 0xcd, ">BH"),
                               (0x100000000, 0xce, ">BI"),
                               (0x10000000000000000, 0xcf, ">BQ")):
            if n < lim:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack")
    elif n >= -32:
        out.append(struct.pack("b", n))
    else:
        for lim, code, fmt in ((-0x80, 0xd0, ">Bb"), (-0x8000, 0xd1, ">Bh"),
                               (-0x80000000, 0xd2, ">Bi"),
                               (-0x8000000000000000, 0xd3, ">Bq")):
            if n >= lim:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fixmax: int, codes: tuple,
              out: list) -> None:
    """A header: the fix form below ``fixmax``, else 8/16/32-bit lengths
    (``codes`` holds the codes of the widths in use, None for absent)."""
    if fix is not None and n < fixmax:
        out.append(struct.pack("B", fix | n))
        return
    for lim, code, fmt in ((0x100, codes[0], ">BB"),
                           (0x10000, codes[1], ">BH"),
                           (0x100000000, codes[2], ">BI")):
        if code is not None and n < lim:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_bytes(b: bytes, out: list) -> None:
    _pack_len(len(b), None, 0, (0xc4, 0xc5, 0xc6), out)
    out.append(bytes(b))


def _pack_ext(code: int, data: bytes, out: list) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n < 0x100:
        out.append(struct.pack(">BBb", 0xc7, n, code))
    elif n < 0x10000:
        out.append(struct.pack(">BHb", 0xc8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xc9, n, code))
    out.append(data)


def _leaf_bytes(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype, bytes)."""
    shape, name, buf = _leaf_parts(x)
    out: list = []
    _pack_len(3, 0x90, 16, (None, 0xdc, 0xdd), out)
    _pack_len(len(shape), 0x90, 16, (None, 0xdc, 0xdd), out)
    for d in shape:
        _pack_int(int(d), out)
    _pack(name, out, strict=False)
    _pack_bytes(buf, out)
    return b"".join(out)


def _pack(x: Any, out: list, strict: bool = True) -> None:
    if x is None:
        out.append(b"\xc0")
    elif type(x) is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb), out)
        out.append(b)
    elif type(x) in (bytes, bytearray, memoryview):
        _pack_bytes(bytes(x), out)
    elif type(x) is list or (not strict and type(x) is tuple):
        _pack_len(len(x), 0x90, 16, (None, 0xdc, 0xdd), out)
        for v in x:
            _pack(v, out, strict)
    elif type(x) is dict:
        _pack_len(len(x), 0x80, 16, (None, 0xde, 0xdf), out)
        for k, v in x.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif _is_array(x):
        _pack_ext(EXT_NDARRAY, _leaf_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _leaf_bytes(np.asarray(x)), out)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def sorted_tree(tree):
    """The tree as ``jax.tree_util.tree_map`` rebuilds it: every dict's
    keys sorted."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [sorted_tree(v) for v in tree]
    return tree


def packb(tree, *, sort_keys: bool = True) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte: its
    tree copy sorts every dict's keys. ``sort_keys=False`` keeps the
    tree's order, as ``to_bytes`` (``msgpack_serialize(state_dict,
    in_place=True)``) does."""
    out: list = []
    _pack(_chunk_leaves(sorted_tree(tree) if sort_keys else tree), out)
    return b"".join(out)


def to_state_dict(tree):
    """flax's ``to_state_dict`` over dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target, state):
    """flax's ``from_state_dict`` over plain trees: ``state`` (as
    ``to_state_dict`` wrote it) in the shape of ``target``, its lists
    restored; ``ValueError`` where the two trees differ."""
    if isinstance(target, (list, tuple)):
        if not isinstance(state, dict) or len(state) != len(target):
            raise ValueError(f"expected a list of {len(target)}, got "
                             f"{type(state).__name__}")
        return type(target)(from_state_dict(t, state[str(i)])
                            for i, t in enumerate(target))
    if isinstance(target, dict):
        if not isinstance(state, dict) or set(state) != set(map(str,
                                                                target)):
            raise ValueError(
                f"keys {sorted(map(str, target))} expected, got "
                f"{sorted(state) if isinstance(state, dict) else state!r}")
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    return state


# ---------------------------------------------------------------------------
# unpacking
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _decode_leaf(data)
        if code == EXT_NPSCALAR:
            leaf = _decode_leaf(data)
            return leaf[()] if isinstance(leaf, np.ndarray) else leaf
        raise MsgpackError(f"unknown msgpack extension type {code}")

    def read(self):
        c = self.unpack("B")
        if c <= 0x7f:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return self.text(c & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if c in simple:
            return simple[c]
        fixed = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                 0xd2: ">i", 0xd3: ">q"}
        if c in fixed:
            return self.unpack(fixed[c])
        lens = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B",
                0xda: ">H", 0xdb: ">I", 0xdc: ">H", 0xdd: ">I",
                0xde: ">H", 0xdf: ">I", 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            if c <= 0xc6:
                return bytes(self.take(n))
            if c <= 0xc9:
                return self.ext(n)
            if c <= 0xdb:
                return self.text(n)
            if c <= 0xdd:
                return [self.read() for _ in range(n)]
            return self.map(n)
        if 0xd4 <= c <= 0xd8:
            return self.ext(1 << (c - 0xd4))
        raise MsgpackError(f"invalid msgpack type byte 0x{c:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(tree):
    """flax's ``_unchunk_array_leaves_in_place``: dicts only."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) if isinstance(v, dict) else v
                for k, v in tree.items()}
    return tree


def unpackb(data, *, raw: bool = False, _chunked: bool = True):
    """``flax.serialization.msgpack_restore(data)``. Raises
    ``MsgpackError`` on truncated or malformed bytes."""
    reader = _Reader(data, raw)
    try:
        tree = reader.read()
    except (struct.error, UnicodeDecodeError) as e:
        raise MsgpackError(f"malformed msgpack data ({e})") from e
    except ValueError as e:       # a leaf whose bytes do not fit its shape
        if isinstance(e, MsgpackError):
            raise
        raise MsgpackError(f"malformed array leaf ({e})") from e
    if reader.pos != len(reader.buf):
        raise MsgpackError(f"{len(reader.buf) - reader.pos} bytes of extra "
                           "data after the msgpack document")
    return _unchunk_leaves(tree) if _chunked else tree
