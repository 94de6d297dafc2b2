"""NDArray save/load over the reference dmlc binary container.

Counterpart of ``incubator_mxnet_tpu/ndarray/utils.py:158-274``, for dense
arrays. The bytes are the same as the JAX package writes and reads, so a
``.params`` file crosses between the two packages both ways:

    uint64 kMXAPINDArrayListMagic (0x112), uint64 reserved (0)
    uint64 count, then per array:
        uint32 NDARRAY_V2_MAGIC (V3 for 0-dim), int32 storage type (0)
        uint32 ndim + int64 dims, int32 dev_type (cpu = 1) + int32 dev_id
        int32 mshadow type flag, raw C-order data bytes
    uint64 count, then per name: uint64 length + utf-8 bytes

``load`` also reads the V1 (int64 dims, no storage type) and legacy v0
(uint32 dims) entries. Loaded arrays live on the CPU, the context the
container records; callers move them.
"""
from __future__ import annotations

import os
import struct

import numpy as _np
import torch

from ..base import MXNetError
from .ndarray import NDArray

__all__ = ["save", "save_bytes", "load", "load_frombuffer"]

_ND_LIST_MAGIC = 0x112            # kMXAPINDArrayListMagic, c_api.cc
_NDARRAY_V1_MAGIC = 0xF993FAC8    # int64 TShape
_NDARRAY_V2_MAGIC = 0xF993FAC9    # + storage type
_NDARRAY_V3_MAGIC = 0xF993FACA    # np-shape semantics (0-dim allowed)
_V3_NONE_NDIM = 0xFFFFFFFF
_STYPE_DEFAULT = 0
_DEV_CPU = 1

# mshadow type flag <-> torch dtype (mshadow/base.h)
_FLAGS = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.uint8: 3, torch.int32: 4, torch.int8: 5, torch.int64: 6,
          torch.bool: 7, torch.bfloat16: 12}
_DTYPES = {v: k for k, v in _FLAGS.items()}
_NP_DTYPES = {torch.float32: _np.float32, torch.float64: _np.float64,
              torch.float16: _np.float16, torch.uint8: _np.uint8,
              torch.int32: _np.int32, torch.int8: _np.int8,
              torch.int64: _np.int64, torch.bool: _np.bool_}


def _type_flag(dtype):
    if dtype not in _FLAGS:
        raise MXNetError(f"dtype {dtype} has no mshadow type flag")
    return _FLAGS[dtype]


def _raw_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)      # numpy has no bfloat16: move the bits
    return t.numpy().tobytes()


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    if shape:
        out.append(struct.pack(f"<{len(shape)}q", *shape))


def _save_one(out, arr):
    if not isinstance(arr, NDArray):
        raise MXNetError(f"save expects NDArrays, got {type(arr)}")
    shape = arr.shape
    # pre-np TShape cannot express a 0-dim scalar: those go on the V3 wire
    magic = _NDARRAY_V3_MAGIC if len(shape) == 0 else _NDARRAY_V2_MAGIC
    out.append(struct.pack("<Ii", magic, _STYPE_DEFAULT))
    _write_shape(out, shape)
    out.append(struct.pack("<ii", _DEV_CPU, 0))
    out.append(struct.pack("<i", _type_flag(arr._data.dtype)))
    out.append(_raw_bytes(arr._data))


def save_bytes(data):
    """Serialize a list or dict of NDArrays to the dmlc wire."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, (list, tuple)):
        names, arrays = [], list(data)
    elif isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
        if not all(isinstance(k, str) for k in names):
            raise MXNetError("save expects str keys")
    else:
        raise MXNetError(f"cannot save {type(data)}")
    out = [struct.pack("<QQ", _ND_LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        raw = n.encode("utf-8")
        out.append(struct.pack("<Q", len(raw)))
        out.append(raw)
    return b"".join(out)


def save(fname: str, data):
    """Save a list or dict of NDArrays on the dmlc binary wire."""
    payload = save_bytes(data)
    with open(fname, "wb") as f:
        f.write(payload)


class _Reader:
    """Little-endian cursor; every read is bounds-checked so a truncated
    file raises MXNetError."""

    def __init__(self, buf):
        self._buf = memoryview(buf)
        self._pos = 0

    def bytes(self, n):
        if self._pos + n > len(self._buf):
            raise MXNetError(
                f"truncated NDArray container (wanted {n} bytes at offset "
                f"{self._pos}, have {len(self._buf)})")
        out = self._buf[self._pos:self._pos + n]
        self._pos += n
        return out

    def unpack(self, fmt):
        vals = struct.unpack("<" + fmt, self.bytes(struct.calcsize("<" + fmt)))
        return vals[0] if len(vals) == 1 else vals

    def shape(self, legacy_u32=False, ndim=None):
        if ndim is None:
            ndim = self.unpack("I")
        if ndim == _V3_NONE_NDIM:
            return None
        if not ndim:
            return ()
        vals = self.unpack(f"{ndim}{'I' if legacy_u32 else 'q'}")
        return tuple(vals) if isinstance(vals, tuple) else (vals,)

    def tensor(self, shape, flag):
        if flag not in _DTYPES:
            raise MXNetError(f"unknown mshadow type flag {flag}")
        dtype = _DTYPES[flag]
        n = int(_np.prod(shape, dtype=_np.int64)) if shape else 1
        itemsize = torch.empty((), dtype=dtype).element_size()
        raw = bytes(self.bytes(n * itemsize))
        if dtype == torch.bfloat16:
            bits = _np.frombuffer(raw, dtype=_np.int16).copy()
            return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
        host = _np.frombuffer(raw, dtype=_NP_DTYPES[dtype]).copy()
        return torch.from_numpy(host).reshape(shape)


def _empty():
    return NDArray(torch.zeros((0,), dtype=torch.float32))


def _load_one(r: _Reader):
    magic = r.unpack("I")
    if magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        stype = r.unpack("i")
        if stype != _STYPE_DEFAULT:
            raise MXNetError(f"storage type {stype} (sparse) is not ported")
        shape = r.shape()
        if shape is None or (magic == _NDARRAY_V2_MAGIC and shape == ()):
            return _empty()
        r.unpack("ii")  # context: always loaded to the host
        return NDArray(r.tensor(shape, r.unpack("i")))
    # V1 (int64 dims) or legacy v0 (the magic field IS ndim, uint32 dims)
    if magic == _NDARRAY_V1_MAGIC:
        shape = r.shape()
    else:
        shape = r.shape(legacy_u32=True, ndim=magic)
    if shape == ():
        return _empty()
    r.unpack("ii")
    return NDArray(r.tensor(shape, r.unpack("i")))


def load_frombuffer(buf):
    """Load a container from bytes; a dict when it names its arrays."""
    if isinstance(buf, memoryview):
        buf = bytes(buf)
    if not isinstance(buf, (bytes, bytearray)):
        raise MXNetError("load_frombuffer expects bytes")
    r = _Reader(buf)
    header, _reserved = r.unpack("QQ")
    if header != _ND_LIST_MAGIC:
        raise MXNetError(
            f"invalid NDArray container magic {header:#x} "
            f"(expected {_ND_LIST_MAGIC:#x})")
    arrays = [_load_one(r) for _ in range(r.unpack("Q"))]
    names = [bytes(r.bytes(r.unpack("Q"))).decode("utf-8")
             for _ in range(r.unpack("Q"))]
    if not names:
        return arrays
    if len(names) != len(arrays):
        raise MXNetError(
            f"container has {len(arrays)} arrays but {len(names)} names")
    return dict(zip(names, arrays))


def load(fname: str):
    """Load a ``save`` container from a file."""
    if not os.path.exists(fname):
        raise MXNetError(f"no such file: {fname}")
    with open(fname, "rb") as f:
        return load_frombuffer(f.read())
