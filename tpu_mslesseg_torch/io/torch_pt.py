"""A reader for PyTorch ``.pt`` checkpoints that pickle whole modules.

The port's own copy of ``tpu_mslesseg/io/torch_pt.py`` (numpy, ``zipfile``
and ``pickle`` only). The reference warm-starts every training run from
COCO-pretrained ``yolo11n-seg.pt``. That file is a torch zip serialization
whose payload pickles a whole ultralytics ``nn.Module`` graph, which
``torch.load(weights_only=True)`` refuses and a full ``torch.load`` could
only rebuild with ultralytics installed. This module parses it with
``zipfile`` and a restricted ``pickle.Unpickler``:

* every foreign class (``ultralytics.nn.tasks.SegmentationModel``,
  ``torch.nn.modules.conv.Conv2d``, ...) becomes a generic *stub* that
  records its attributes: no code named by the file runs;
* tensor rebuild calls (``torch._utils._rebuild_tensor_v2``) are
  intercepted and give numpy arrays straight from the zip's raw storage
  records (``<root>/data/<key>``), with their offset, shape and strides;
  bf16 storages become float32 (exactly);
* ``state_dict(obj)`` walks the stub module tree's
  ``_parameters``/``_buffers``/``_modules`` as ``torch.nn.Module.state_dict``
  does, to ``{dotted_name: ndarray}``.
"""

from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict

import numpy as np

_BF16 = "bfloat16"  # read as uint16 bits, widened to float32

# torch storage class name -> numpy dtype (legacy names persist in the
# persistent_id tuples of torch>=1.6 zip checkpoints, torch 2.x included)
_STORAGE_DTYPES = {
    "DoubleStorage": np.dtype(np.float64),
    "FloatStorage": np.dtype(np.float32),
    "HalfStorage": np.dtype(np.float16),
    "BFloat16Storage": _BF16,
    "LongStorage": np.dtype(np.int64),
    "IntStorage": np.dtype(np.int32),
    "ShortStorage": np.dtype(np.int16),
    "CharStorage": np.dtype(np.int8),
    "ByteStorage": np.dtype(np.uint8),
    "BoolStorage": np.dtype(np.bool_),
}


class _Stub:
    """Generic stand-in for any class named inside the pickle stream.

    Supports all the object-construction paths pickle uses: NEWOBJ
    (``cls.__new__``), REDUCE (``cls(*args)``), and BUILD (state dict /
    (dict, slots) tuple). Attributes land in ``__dict__``.
    """

    _qualname = "stub"

    def __init__(self, *args, **kwargs):
        self._reduce_args = args

    def __setstate__(self, state):
        if isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if d:
                self.__dict__.update(d)
            if slots:
                self.__dict__.update(slots)
        elif isinstance(state, dict):
            self.__dict__.update(state)
        else:  # exotic __setstate__ payloads: keep for inspection
            self.__dict__["_state"] = state

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<stub {self._qualname}>"


class _StorageRef:
    """Lazy handle to one raw storage record inside the zip."""

    __slots__ = ("dtype", "key", "numel", "zf", "prefix", "_cache")

    def __init__(self, dtype, key, numel, zf, prefix):
        self.dtype, self.key, self.numel = dtype, key, numel
        self.zf, self.prefix = zf, prefix
        self._cache = None

    def array(self) -> np.ndarray:
        if self._cache is None:
            raw = self.zf.read(f"{self.prefix}data/{self.key}")
            if self.dtype is _BF16:
                bits = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
                self._cache = bits.view(np.float32)
            else:
                self._cache = np.frombuffer(raw, dtype=self.dtype)
        return self._cache


def _rebuild_tensor_v2(storage, offset, size, stride, requires_grad=False,
                       backward_hooks=None, metadata=None) -> np.ndarray:
    base = storage.array()
    itemsize = base.dtype.itemsize
    if not size:  # 0-d tensor
        return base[offset : offset + 1].reshape(()).copy()
    arr = np.lib.stride_tricks.as_strided(
        base[offset:], shape=tuple(size),
        strides=tuple(s * itemsize for s in stride),
    )
    return arr.copy()


def _rebuild_parameter(data, requires_grad=False, hooks=None):
    return data


def _passthrough_first(*args, **kwargs):
    return args[0] if args else None


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, zf, prefix):
        super().__init__(file)
        self._zf, self._prefix = zf, prefix
        self._stub_cache: Dict[str, type] = {}

    def persistent_load(self, pid):
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unknown persistent id: {pid!r}")
        storage_type, key, _location, numel = pid[1:5]
        name = getattr(storage_type, "_qualname", str(storage_type))
        name = name.rsplit(".", 1)[-1]
        dtype = _STORAGE_DTYPES.get(name)
        if dtype is None:
            raise pickle.UnpicklingError(f"unsupported storage type {name}")
        return _StorageRef(dtype, key, numel, self._zf, self._prefix)

    def find_class(self, module, name):
        if module == "collections" and name == "OrderedDict":
            import collections

            return collections.OrderedDict
        # pure data constructors (no code execution): real nn.Module
        # pickles carry e.g. _non_persistent_buffers_set as a plain set.
        # torch.save uses protocol 2, which writes the py2-compat module
        # name '__builtin__' (the default find_class would remap it; an
        # override must do so itself).
        if module in ("builtins", "__builtin__") and name in (
            "set", "frozenset", "bytearray", "complex",
        ):
            import builtins

            return getattr(builtins, name)
        if module == "torch._utils":
            if name == "_rebuild_tensor_v2":
                return _rebuild_tensor_v2
            if name in ("_rebuild_parameter", "_rebuild_parameter_v2"):
                return _rebuild_parameter
            if name == "_rebuild_tensor":
                return lambda storage, offset, size, stride: (
                    _rebuild_tensor_v2(storage, offset, size, stride)
                )
        if module == "torch.serialization" and name == "_get_layout":
            return _passthrough_first
        qual = f"{module}.{name}"
        stub = self._stub_cache.get(qual)
        if stub is None:
            stub = type(name, (_Stub,), {"_qualname": qual})
            self._stub_cache[qual] = stub
        return stub


def load_pt(path) -> Any:
    """Parse a torch zip-format ``.pt`` file without unpickling its classes.

    Returns the unpickled object tree: real dict/list/OrderedDict
    containers, numpy arrays for tensors, and ``_Stub`` instances for any
    foreign class (e.g. the nn.Module graph of an ultralytics checkpoint).
    """
    zf = zipfile.ZipFile(path)
    names = zf.namelist()
    pkls = [n for n in names if n.endswith("/data.pkl") or n == "data.pkl"]
    if not pkls:
        raise ValueError(
            f"{path}: no data.pkl — not a torch zip checkpoint "
            "(legacy tar-format .pt files are not supported)"
        )
    pkl = pkls[0]
    prefix = pkl[: -len("data.pkl")]
    import io as _io

    return _Unpickler(_io.BytesIO(zf.read(pkl)), zf, prefix).load()


def _is_module_stub(obj) -> bool:
    d = getattr(obj, "__dict__", None)
    return isinstance(d, dict) and "_modules" in d and "_parameters" in d


def state_dict(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """Flatten a stub nn.Module tree (or pass through a tensor dict) into
    ``{dotted_name: ndarray}`` with torch's state_dict naming."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(obj, dict):  # already a state_dict
        for k, v in obj.items():
            if isinstance(v, np.ndarray):
                out[f"{prefix}{k}"] = v
        return out
    if not _is_module_stub(obj):
        raise TypeError(f"not a module stub or state_dict: {type(obj)!r}")
    d = obj.__dict__
    # non-persistent buffers are excluded from torch's state_dict; real
    # nn.Module pickles carry the exclusion set verbatim (a plain set,
    # decoded natively) — honor it exactly like torch does
    non_persistent = d.get("_non_persistent_buffers_set") or ()
    for k, v in (d.get("_parameters") or {}).items():
        if isinstance(v, np.ndarray):
            out[f"{prefix}{k}"] = v
    for k, v in (d.get("_buffers") or {}).items():
        if isinstance(v, np.ndarray) and k not in non_persistent:
            out[f"{prefix}{k}"] = v
    for k, v in (d.get("_modules") or {}).items():
        if v is not None and _is_module_stub(v):
            out.update(state_dict(v, prefix=f"{prefix}{k}."))
    return out


def load_ultralytics_checkpoint(path):
    """Load an ultralytics ``.pt`` checkpoint → (state_dict, train_args).

    Prefers the EMA weights (what ultralytics deploys as ``best.pt``) and
    falls back to the raw model. ``train_args`` is the checkpoint's
    ``train_args`` dict when present (real dict after stub-decoding).
    """
    ckpt = load_pt(path)
    if isinstance(ckpt, dict):
        model = ckpt.get("ema") or ckpt.get("model")
        if model is None:  # plain state_dict file
            return state_dict(ckpt), {}
        args = ckpt.get("train_args")
        args = dict(args) if isinstance(args, dict) else {}
        # SegmentationModel stub: weights live under .model (a Sequential)
        sd = state_dict(model)
        return sd, args
    return state_dict(ckpt), {}
