"""Numpy-only reader for PyTorch ``torch.save`` files (no torch import).

The reference publishes pretrained checkpoints as torch ``.pt`` files
(``torch.save({"model": state_dict, "opt": ..., "lr_scheduler": ...,
"hparams": ...})``, reference ``experiments/exp_config.py:31-38``; restored
by ``load_pretrained``, ``experiments/utils.py:69-79``). This module reads
both torch serialization formats without torch so checkpoints can be ported
into this framework's parameter pytrees (see :mod:`egc_tpu.exp.weight_port`):

- the zip container (torch >= 1.6; the reference pins torch 1.11): a zipfile
  holding ``<name>/data.pkl`` (a pickle whose persistent ids reference
  storages) plus one raw little-endian buffer per storage under
  ``<name>/data/<key>``;
- the legacy container (torch < 1.6): magic/protocol/sysinfo pickles, the
  object pickle (persistent ids carry a root storage key + optional view
  metadata), a list of storage keys, then per key an int64 element count
  followed by the raw buffer.

Unknown globals (optimizer classes, hparam objects, ...) deserialize to
tolerant stubs — callers only consume dicts/lists/scalars/ndarrays.
"""

from __future__ import annotations

import io
import pickle
import struct
import zipfile
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_MAGIC_NUMBER = 0x1950A86A20F9469CFC6C

# torch storage-class name -> numpy dtype (all little-endian on disk).
_STORAGE_DTYPES = {
    "DoubleStorage": np.dtype("<f8"),
    "FloatStorage": np.dtype("<f4"),
    "HalfStorage": np.dtype("<f2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("i1"),
    "ByteStorage": np.dtype("u1"),
    "BoolStorage": np.dtype("?"),
    "ComplexFloatStorage": np.dtype("<c8"),
    "ComplexDoubleStorage": np.dtype("<c16"),
}


def _bfloat16_dtype():
    import ml_dtypes  # ships with jax

    return np.dtype(ml_dtypes.bfloat16)


class _StorageType:
    """Stub for ``torch.FloatStorage``-style globals: carries the dtype."""

    def __init__(self, name: str):
        self.name = name
        if name == "BFloat16Storage":
            self.dtype = _bfloat16_dtype()
        elif name in ("UntypedStorage", "_UntypedStorage"):
            self.dtype = None  # dtype resolved from the consuming tensor
        else:
            self.dtype = _STORAGE_DTYPES.get(name)
            if self.dtype is None:
                raise ValueError(f"unsupported torch storage type {name!r}")


class _Storage:
    """A named storage; ``data`` (raw bytes) may arrive after unpickling
    (legacy format reads buffers after the object pickle)."""

    def __init__(self, key: str, dtype: Optional[np.dtype], numel: int):
        self.key = key
        self.dtype = dtype
        self.numel = numel
        self.data: Optional[bytes] = None
        # legacy view metadata: (view_key, offset_el, view_numel) or None
        self.view_of: Optional["_Storage"] = None
        self.view_offset = 0

    def array(self) -> np.ndarray:
        if self.view_of is not None:
            base = self.view_of.array()
            return base[self.view_offset:self.view_offset + self.numel]
        if self.data is None:
            raise ValueError(f"storage {self.key!r} has no data")
        dtype = self.dtype or np.dtype("u1")
        return np.frombuffer(self.data, dtype=dtype)


class _LazyTensor:
    def __init__(self, storage: _Storage, offset: int, size, stride):
        self.storage = storage
        self.offset = offset
        self.size = tuple(int(s) for s in size)
        self.stride = tuple(int(s) for s in stride) if stride is not None \
            else None

    def materialize(self) -> np.ndarray:
        flat = self.storage.array()
        if self.stride is None:
            n = int(np.prod(self.size)) if self.size else 1
            return flat[self.offset:self.offset + n].reshape(self.size).copy()
        itemsize = flat.dtype.itemsize
        strided = np.lib.stride_tricks.as_strided(
            flat[self.offset:],
            shape=self.size,
            strides=tuple(s * itemsize for s in self.stride),
        )
        return np.array(strided)  # contiguous copy


class _Stub:
    """Tolerant placeholder for unknown pickled globals."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs, self.state = args, kwargs, None

    def __call__(self, *args, **kwargs):
        return _Stub(*args, **kwargs)

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        name = getattr(self, "_stub_name", "Stub")
        return f"<{name}>"


def _make_stub_class(module: str, name: str):
    return type(f"Stub_{name}", (_Stub,),
                {"_stub_name": f"{module}.{name}"})


def _rebuild_tensor_v2(storage, offset, size, stride, requires_grad=False,
                       backward_hooks=None, metadata=None):
    return _LazyTensor(storage, offset, size, stride)


def _rebuild_tensor(storage, offset, size, stride):
    return _LazyTensor(storage, offset, size, stride)


def _rebuild_parameter(tensor, requires_grad=False, hooks=None):
    return tensor


def _rebuild_from_type_v2(func, new_type, args, state):
    obj = func(*args)
    if isinstance(state, dict) and not isinstance(obj, _LazyTensor):
        try:
            obj.__dict__.update(state)
        except AttributeError:
            pass
    return obj


_REBUILDERS = {
    ("torch._utils", "_rebuild_tensor_v2"): _rebuild_tensor_v2,
    ("torch._utils", "_rebuild_tensor"): _rebuild_tensor,
    ("torch._utils", "_rebuild_parameter"): _rebuild_parameter,
    ("torch._tensor", "_rebuild_from_type_v2"): _rebuild_from_type_v2,
}


class _TorchUnpickler(pickle.Unpickler):
    def __init__(self, file, storages: Dict[str, _Storage], *, legacy: bool):
        super().__init__(file, encoding="utf-8")
        self._storages = storages
        self._legacy = legacy

    def find_class(self, module, name):
        key = (module, name)
        if key in _REBUILDERS:
            return _REBUILDERS[key]
        if module == "collections" and name == "OrderedDict":
            return OrderedDict
        if module == "torch" and name == "Size":
            return tuple
        if module in ("torch", "torch.storage") and \
                (name.endswith("Storage") or name == "TypedStorage"):
            if name == "TypedStorage":
                return _make_stub_class(module, name)
            return _StorageType(name)
        if module.startswith(("torch", "numpy")) or "." in module:
            return _make_stub_class(module, name)
        return _make_stub_class(module, name)

    def persistent_load(self, pid):
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")
        storage_type, key, _location, numel = pid[1], pid[2], pid[3], pid[4]
        dtype = getattr(storage_type, "dtype", None)
        if key not in self._storages:
            self._storages[key] = _Storage(key, dtype, int(numel))
        st = self._storages[key]
        if st.dtype is None:
            st.dtype = dtype
        if self._legacy and len(pid) > 5 and pid[5] is not None:
            view_key, view_offset, view_numel = pid[5]
            if view_key not in self._storages:
                view = _Storage(view_key, dtype, int(view_numel))
                view.view_of = st
                view.view_offset = int(view_offset)
                self._storages[view_key] = view
            return self._storages[view_key]
        return st


def _materialize(obj):
    if isinstance(obj, _LazyTensor):
        return obj.materialize()
    if isinstance(obj, OrderedDict):
        return OrderedDict((k, _materialize(v)) for k, v in obj.items())
    if isinstance(obj, dict):
        return {k: _materialize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_materialize(v) for v in obj]
        return type(obj)(out) if isinstance(obj, tuple) else out
    return obj


def _load_zip(path: Path):
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl = [n for n in names if n.endswith("/data.pkl") or n == "data.pkl"]
        if not pkl:
            raise ValueError(f"{path}: no data.pkl in torch zip archive")
        prefix = pkl[0][: -len("data.pkl")]
        storages: Dict[str, _Storage] = {}
        with zf.open(pkl[0]) as f:
            obj = _TorchUnpickler(f, storages, legacy=False).load()
        for key, st in storages.items():
            entry = f"{prefix}data/{key}"
            with zf.open(entry) as f:
                st.data = f.read()
            if st.dtype is None:
                st.dtype = np.dtype("u1")
    return _materialize(obj)


def _load_legacy(f):
    storages: Dict[str, _Storage] = {}

    def read_pickle():
        return _TorchUnpickler(f, storages, legacy=True).load()

    magic = read_pickle()
    if magic != _MAGIC_NUMBER:
        raise ValueError("not a legacy torch file (bad magic)")
    read_pickle()  # protocol version
    read_pickle()  # sys info
    obj = read_pickle()
    keys = read_pickle()
    for key in keys:
        st = storages[key]
        (numel,) = struct.unpack("<q", f.read(8))
        itemsize = (st.dtype or np.dtype("u1")).itemsize
        st.data = f.read(numel * itemsize)
    return _materialize(obj)


def load(path) -> Any:
    """Load a ``torch.save`` file as plain python + numpy (no torch)."""
    path = Path(path)
    if zipfile.is_zipfile(path):
        return _load_zip(path)
    with open(path, "rb") as f:
        return _load_legacy(f)


def load_state_dict(path, key: str = "model") -> "OrderedDict[str, np.ndarray]":
    """Load a checkpoint's model state dict as {name: ndarray}.

    Accepts either a bare ``state_dict`` save or the reference's trial
    payload ``{"model": state_dict, ...}`` (``experiments/exp_config.py:31``);
    ``key`` selects the sub-dict in the latter case.
    """
    obj = load(path)
    if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
        obj = obj[key]
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state-dict-like mapping, "
                         f"got {type(obj).__name__}")
    out = OrderedDict()
    for k, v in obj.items():
        if isinstance(v, np.ndarray):
            out[str(k)] = v
    if not out:
        raise ValueError(f"{path}: no tensors found under key {key!r}")
    return out
