"""A read-only HDF5 reader for the files h5py writes for Keras, in the
stdlib and numpy: what ``tf_proto.py`` is for GraphDefs, this is for the
Keras ``.h5`` full-model save (the card's machine has no h5py).

It reads the file with one ``readinto`` and hands datasets back as numpy
views of that buffer (``np.frombuffer`` at the dataset's offset), so the
weights of a 400 MB file cost no copy. What it reads is what h5py writes
at its default ("earliest") format bounds:

- superblock version 0 or 1, 8-byte offsets and lengths;
- symbol-table groups: version-1 B-tree group nodes, ``SNOD`` symbol
  nodes and the local heap that holds the link names;
- version-1 object headers and their continuation blocks;
- the dataspace, datatype, data layout (version 3), attribute (versions
  1-3), symbol table and fill value messages; the modification time,
  comment and NIL messages are skipped;
- fixed-point and IEEE (f16, f32, f64) numbers, fixed-length strings, and
  variable-length strings whose bytes live in global heap collections
  (``GCOL``);
- contiguous and compact datasets.

Anything else raises :class:`Hdf5FormatError` naming what it met and
where: chunked or filtered datasets, dense attribute storage (a fractal
heap), version-2 object headers and link-message groups, compound, enum,
reference and array types, shared (committed) datatypes. Reading never
guesses.

Values come back as h5py gives them: numeric arrays (a scalar as a 0-d
array's numpy scalar for attributes), a variable-length string as
``str`` and an array of them as an object array of ``str`` (``bytes``
in a dataset, as h5py reads them), a
fixed-length string as ``numpy.bytes_`` and an array of them as a numpy
``S`` array.

:class:`Hdf5Archive` is the Keras view on top (the JAX package's
``Hdf5Archive``, keras.py:45-104): ``model_config``, ``keras_version``,
``layer_weights`` with its ``fwd/``, ``bwd/`` and ``query/``... basename
rules, and ``close``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x0, 0x1, 0x2, 0x3
_FILL_OLD, _FILL, _LINK, _LAYOUT = 0x4, 0x5, 0x6, 0x8
_GROUP_INFO, _FILTERS, _ATTRIBUTE = 0xA, 0xB, 0xC
_COMMENT, _MTIME_OLD, _CONTINUATION = 0xD, 0xE, 0x10
_SYMBOL_TABLE, _MTIME, _BTREE_K, _ATTR_INFO = 0x11, 0x12, 0x13, 0x15
#: messages that carry nothing this reader needs
_SKIPPED = {_NIL, _FILL_OLD, _FILL, _COMMENT, _MTIME_OLD, _MTIME, _BTREE_K}
#: messages the objects read (or refuse by name themselves)
_READ = {_DATASPACE, _DATATYPE, _LAYOUT, _ATTRIBUTE, _CONTINUATION,
         _SYMBOL_TABLE, _ATTR_INFO, _FILTERS, _LINK, _LINK_INFO,
         _GROUP_INFO}


class Hdf5FormatError(ValueError):
    """A structure of the file this reader does not read (or a damaged
    one), named with where it was met."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Buffer:
    """The file's bytes with little-endian field readers."""

    def __init__(self, data: bytearray):
        self.data = data

    def u(self, off: int, size: int) -> int:
        if off + size > len(self.data):
            raise Hdf5FormatError(f"read past the end of the file at {off}")
        return int.from_bytes(self.data[off:off + size], "little")

    def bytes(self, off: int, size: int) -> bytes:
        if off + size > len(self.data):
            raise Hdf5FormatError(f"read past the end of the file at {off}")
        return bytes(self.data[off:off + size])

    def cstring(self, off: int) -> str:
        end = self.data.index(0, off)
        return self.data[off:end].decode("utf-8")


# ------------------------------------------------------------- datatypes
class Datatype:
    """A parsed datatype message: ``kind`` is ``"int"``, ``"float"``,
    ``"str"`` (fixed length) or ``"vlen_str"``; ``np_dtype`` the element
    dtype (``S<size>`` for fixed strings, ``object`` for vlen ones, whose
    ``size`` is that of their 16-byte heap reference)."""

    def __init__(self, kind: str, size: int, np_dtype: np.dtype):
        self.kind, self.size, self.np_dtype = kind, size, np_dtype

    def __repr__(self):
        return f"Datatype({self.kind}, {self.size})"


def _parse_datatype(buf: _Buffer, off: int, where: str) -> Datatype:
    cv = buf.u(off, 1)
    cls, version = cv & 0x0F, cv >> 4
    bits = buf.u(off + 1, 3)
    size = buf.u(off + 4, 4)
    if version not in (1, 2, 3):
        raise Hdf5FormatError(f"{where}: datatype version {version}")
    order = ">" if bits & 1 else "<"
    if cls == 0:                                   # fixed-point
        if size not in (1, 2, 4, 8):
            raise Hdf5FormatError(f"{where}: {size}-byte integer")
        signed = bool(bits & 0x8)
        dt = np.dtype(f"{order}{'i' if signed else 'u'}{size}")
        return Datatype("int", size, dt)
    if cls == 1:                                   # IEEE float
        if bits & 0x40 or size not in (2, 4, 8):
            raise Hdf5FormatError(f"{where}: {size}-byte float with bit "
                                  f"field {bits:#x} (VAX order?)")
        return Datatype("float", size, np.dtype(f"{order}f{size}"))
    if cls == 3:                                   # fixed-length string
        return Datatype("str", size, np.dtype(f"S{size}"))
    if cls == 9:                                   # variable length
        if bits & 0xF != 1:
            raise Hdf5FormatError(f"{where}: variable-length sequence "
                                  "(only variable-length strings are read)")
        return Datatype("vlen_str", size, np.dtype(object))
    names = {2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
             7: "reference", 8: "enum", 10: "array"}
    raise Hdf5FormatError(f"{where}: {names.get(cls, cls)} datatype")


def _parse_dataspace(buf: _Buffer, off: int, where: str
                     ) -> Optional[Tuple[int, ...]]:
    """The dims (``()`` for a scalar, None for a null dataspace)."""
    version, rank, flags = buf.u(off, 1), buf.u(off + 1, 1), \
        buf.u(off + 2, 1)
    if version == 1:
        p = off + 8
    elif version == 2:
        if buf.u(off + 3, 1) == 2:
            return None
        p = off + 4
    else:
        raise Hdf5FormatError(f"{where}: dataspace version {version}")
    return tuple(buf.u(p + 8 * i, 8) for i in range(rank))


# ------------------------------------------------------------ the objects
class _Object:
    """An object (group or dataset) by its header's messages."""

    def __init__(self, f: "Hdf5File", name: str, addr: int):
        self.file, self.name, self.addr = f, name, addr
        self._msgs = f._messages(addr, name)
        self._attrs = None

    @property
    def attrs(self) -> Dict[str, object]:
        """The attributes by name, decoded as h5py decodes them."""
        if self._attrs is None:
            self._attrs = {}
            for mtype, moff, _size in self._msgs:
                if mtype == _ATTRIBUTE:
                    k, v = self.file._attribute(moff, self.name)
                    self._attrs[k] = v
                elif mtype == _ATTR_INFO:
                    self.file._check_attr_info(moff, self.name)
        return self._attrs


class Dataset(_Object):
    """A contiguous or compact dataset: ``shape``, ``dtype`` and
    :meth:`read` (a numpy view of the file's buffer)."""

    def __init__(self, f, name, addr):
        super().__init__(f, name, addr)
        buf = f._buf
        self._dtype = self._space = self._layout = None
        for mtype, moff, size in self._msgs:
            if mtype == _DATATYPE:
                self._dtype = _parse_datatype(buf, moff, name)
            elif mtype == _DATASPACE:
                self._space = _parse_dataspace(buf, moff, name)
            elif mtype == _LAYOUT:
                self._layout = (moff, size)
            elif mtype == _FILTERS:
                raise Hdf5FormatError(f"{name}: a filtered (compressed) "
                                      "dataset")
        if self._dtype is None or self._layout is None:
            raise Hdf5FormatError(f"{name}: dataset without a datatype or "
                                  "layout message")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._space or ()

    @property
    def dtype(self) -> np.dtype:
        return self._dtype.np_dtype

    def read(self):
        """The data: a numpy view of the file's buffer (strings decoded
        as h5py does)."""
        buf = self.file._buf
        off, _ = self._layout
        version, cls = buf.u(off, 1), buf.u(off + 1, 1)
        if version != 3:
            raise Hdf5FormatError(f"{self.name}: data layout version "
                                  f"{version}")
        shape = self.shape
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * self._dtype.size
        if cls == 0:                                   # compact
            size = buf.u(off + 2, 2)
            data_off = off + 4
        elif cls == 1:                                 # contiguous
            data_off, size = buf.u(off + 2, 8), buf.u(off + 10, 8)
            if data_off == UNDEFINED:
                if nbytes == 0:
                    return np.zeros(shape, self._dtype.np_dtype)
                raise Hdf5FormatError(f"{self.name}: no storage allocated")
        elif cls == 2:
            raise Hdf5FormatError(f"{self.name}: a chunked dataset")
        else:
            raise Hdf5FormatError(f"{self.name}: layout class {cls}")
        if size < nbytes:
            raise Hdf5FormatError(f"{self.name}: {size} bytes of storage "
                                  f"for {nbytes}")
        return self.file._values(self._dtype, data_off, shape, self.name,
                                 text=False)

    def __repr__(self):
        return f"<Dataset {self.name} {self.shape} {self.dtype}>"


class Group(_Object):
    """A symbol-table group: its links by name, resolved lazily."""

    def __init__(self, f, name, addr):
        super().__init__(f, name, addr)
        self._links: Optional[Dict[str, int]] = None
        for mtype, _moff, _size in self._msgs:
            if mtype in (_LINK, _LINK_INFO):
                raise Hdf5FormatError(f"{name}: a link-message group (new "
                                      "style, written past the 'earliest' "
                                      "format bounds)")

    def _table(self) -> Dict[str, int]:
        if self._links is None:
            for mtype, moff, _size in self._msgs:
                if mtype == _SYMBOL_TABLE:
                    buf = self.file._buf
                    self._links = self.file._symbols(
                        buf.u(moff, 8), buf.u(moff + 8, 8), self.name)
                    break
            else:
                raise Hdf5FormatError(f"{self.name}: group without a symbol "
                                      "table message")
        return self._links

    def keys(self) -> List[str]:
        return list(self._table())

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        obj: Union[Group, Dataset] = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(obj, Group) or part not in obj._table():
                raise KeyError(f"{path!r} not in {self.name!r}")
            obj = self.file._open(f"{obj.name.rstrip('/')}/{part}",
                                  obj._table()[part])
        return obj

    def items(self) -> Iterator[Tuple[str, Union["Group", Dataset]]]:
        for k in self.keys():
            yield k, self[k]

    def visititems(self, fn: Callable[[str, object], None],
                   _prefix: str = "") -> None:
        """``fn(relative_path, obj)`` for every object below, depth first
        in name order (as h5py's ``visititems``)."""
        for k, obj in self.items():
            rel = f"{_prefix}{k}"
            fn(rel, obj)
            if isinstance(obj, Group):
                obj.visititems(fn, rel + "/")

    def __repr__(self):
        return f"<Group {self.name} ({len(self.keys())} members)>"


class Hdf5File(Group):
    """An HDF5 file read whole into memory: the root group, with
    ``file[path]`` for the objects below it."""

    def __init__(self, path: Union[str, Path]):
        path = Path(path)
        size = path.stat().st_size
        data = bytearray(size)
        with open(path, "rb") as fh:
            if fh.readinto(data) != size:
                raise Hdf5FormatError(f"{path}: short read")
        self._buf = _Buffer(data)
        self._cache: Dict[int, _Object] = {}
        self._gcol: Dict[int, Dict[int, Tuple[int, int]]] = {}
        root_addr = self._superblock(str(path))
        Group.__init__(self, self, "/", root_addr)
        self._cache[root_addr] = self

    def close(self) -> None:
        """Release the buffer (views taken from it keep it alive)."""
        self._cache.clear()

    # -------------------------------------------------------- structure
    def _superblock(self, where: str) -> int:
        buf = self._buf
        base = None
        for off in (0, 512, 1024, 2048, 4096):
            if buf.bytes(off, 8) == SIGNATURE:
                base = off
                break
        if base is None:
            raise Hdf5FormatError(f"{where}: no HDF5 signature")
        version = buf.u(base + 8, 1)
        if version not in (0, 1):
            raise Hdf5FormatError(f"{where}: superblock version {version} "
                                  "(only 0 and 1, h5py's default bounds, "
                                  "are read)")
        if buf.u(base + 13, 1) != 8 or buf.u(base + 14, 1) != 8:
            raise Hdf5FormatError(f"{where}: offsets/lengths not 8 bytes")
        p = base + 24 + (4 if version == 1 else 0)
        if buf.u(p, 8) != 0:
            raise Hdf5FormatError(f"{where}: a base address of "
                                  f"{buf.u(p, 8)}")
        root_entry = p + 32
        return buf.u(root_entry + 8, 8)

    def _messages(self, addr: int, where: str
                  ) -> List[Tuple[int, int, int]]:
        """``(type, data offset, size)`` of every message of the version-1
        object header at ``addr``, continuation blocks followed."""
        buf = self._buf
        if buf.bytes(addr, 4) == b"OHDR":
            raise Hdf5FormatError(f"{where}: a version-2 object header")
        version = buf.u(addr, 1)
        if version != 1:
            raise Hdf5FormatError(f"{where}: object header version "
                                  f"{version}")
        n_msgs = buf.u(addr + 2, 2)
        blocks = [(addr + 16, buf.u(addr + 8, 4))]
        out: List[Tuple[int, int, int]] = []
        while blocks and len(out) < n_msgs:
            p, length = blocks.pop(0)
            end = p + length
            while p + 8 <= end and len(out) < n_msgs:
                mtype, size = buf.u(p, 2), buf.u(p + 2, 2)
                flags = buf.u(p + 4, 1)
                if flags & 0x02:
                    raise Hdf5FormatError(f"{where}: a shared message "
                                          f"(type {mtype:#x})")
                data = p + 8
                if mtype == _CONTINUATION:
                    blocks.append((buf.u(data, 8), buf.u(data + 8, 8)))
                elif mtype not in _READ and mtype not in _SKIPPED:
                    raise Hdf5FormatError(f"{where}: an object header "
                                          f"message of type {mtype:#x}")
                out.append((mtype, data, size))
                p = data + size
        return out

    def _open(self, name: str, addr: int) -> _Object:
        obj = self._cache.get(addr)
        if obj is None:
            kinds = {m[0] for m in self._messages(addr, name)}
            if _SYMBOL_TABLE in kinds or _LINK_INFO in kinds or \
                    _LINK in kinds:
                obj = Group(self, name, addr)
            elif _LAYOUT in kinds:
                obj = Dataset(self, name, addr)
            else:
                raise Hdf5FormatError(f"{name}: an object that is neither "
                                      "a group nor a dataset")
            self._cache[addr] = obj
        return obj

    def _symbols(self, btree: int, heap: int, where: str) -> Dict[str, int]:
        """The links of a symbol-table group: name -> object header
        address, walking the group B-tree down to its ``SNOD`` nodes."""
        buf = self._buf
        if buf.bytes(heap, 4) != b"HEAP":
            raise Hdf5FormatError(f"{where}: no local heap at {heap}")
        heap_data = buf.u(heap + 24, 8)
        links: Dict[str, int] = {}

        def node(addr: int) -> None:
            sig = buf.bytes(addr, 4)
            if sig == b"TREE":
                if buf.u(addr + 4, 1) != 0:
                    raise Hdf5FormatError(f"{where}: a B-tree node of type "
                                          f"{buf.u(addr + 4, 1)} in a group")
                used = buf.u(addr + 6, 2)
                p = addr + 24 + 8                  # past key 0
                for _ in range(used):
                    node(buf.u(p, 8))
                    p += 16
            elif sig == b"SNOD":
                for i in range(buf.u(addr + 6, 2)):
                    e = addr + 8 + 40 * i
                    name = buf.cstring(heap_data + buf.u(e, 8))
                    links[name] = buf.u(e + 8, 8)
            else:
                raise Hdf5FormatError(f"{where}: {sig!r} where a group "
                                      "B-tree node was due")
        node(btree)
        return dict(sorted(links.items()))

    def _check_attr_info(self, off: int, where: str) -> None:
        flags = self._buf.u(off + 1, 1)
        p = off + 2 + (2 if flags & 1 else 0)
        if self._buf.u(p, 8) != UNDEFINED:
            raise Hdf5FormatError(f"{where}: dense attribute storage (a "
                                  "fractal heap)")

    # ------------------------------------------------------------ values
    def _attribute(self, off: int, where: str) -> Tuple[str, object]:
        buf = self._buf
        version = buf.u(off, 1)
        if version not in (1, 2, 3):
            raise Hdf5FormatError(f"{where}: attribute message version "
                                  f"{version}")
        name_size, type_size, space_size = (buf.u(off + 2, 2),
                                            buf.u(off + 4, 2),
                                            buf.u(off + 6, 2))
        p = off + 8 + (1 if version == 3 else 0)
        pad = _pad8 if version == 1 else (lambda n: n)
        name = buf.bytes(p, name_size).split(b"\0", 1)[0].decode("utf-8")
        p += pad(name_size)
        loc = f"{where} attribute {name!r}"
        dtype = _parse_datatype(buf, p, loc)
        p += pad(type_size)
        shape = _parse_dataspace(buf, p, loc)
        p += pad(space_size)
        if shape is None:
            return name, None
        value = self._values(dtype, p, shape, loc)
        if shape == () and isinstance(value, np.ndarray):
            value = value[()]
        return name, value

    def _values(self, dtype: Datatype, off: int, shape: Tuple[int, ...],
                where: str, text: bool = True):
        """Elements of ``shape`` at ``off``: a numpy view for numbers and
        fixed strings; variable-length strings as ``str`` (``text``, as
        h5py reads attributes) or ``bytes`` (as it reads datasets)."""
        count = int(np.prod(shape)) if shape else 1
        if dtype.kind == "vlen_str":
            buf = self._buf
            out = [self._heap_bytes(buf.u(off + 16 * i + 4, 8),
                                    buf.u(off + 16 * i + 12, 4),
                                    buf.u(off + 16 * i, 4), where)
                   for i in range(count)]
            if text:
                out = [b.decode("utf-8") for b in out]
            if shape == ():
                return out[0]
            arr = np.empty(count, dtype=object)
            arr[:] = out
            return arr.reshape(shape)
        arr = np.frombuffer(self._buf.data, dtype=dtype.np_dtype,
                            count=count, offset=off)
        return arr.reshape(shape)

    def _heap_bytes(self, coll: int, index: int, length: int,
                    where: str) -> bytes:
        if coll == 0 and index == 0:
            return b""
        objs = self._gcol.get(coll)
        if objs is None:
            objs = self._gcol[coll] = self._collection(coll, where)
        if index not in objs:
            raise Hdf5FormatError(f"{where}: global heap object {index} "
                                  f"missing from the collection at {coll}")
        p, size = objs[index]
        return self._buf.bytes(p, min(size, length))

    def _collection(self, addr: int, where: str
                    ) -> Dict[int, Tuple[int, int]]:
        """A global heap collection's objects: index -> (data, size)."""
        buf = self._buf
        if buf.bytes(addr, 4) != b"GCOL":
            raise Hdf5FormatError(f"{where}: no global heap collection at "
                                  f"{addr}")
        end = addr + buf.u(addr + 8, 8)
        p = addr + 16
        objs: Dict[int, Tuple[int, int]] = {}
        while p + 16 <= end:
            index, size = buf.u(p, 2), buf.u(p + 8, 8)
            if index == 0:                          # the free space
                break
            objs[index] = (p + 16, size)
            p += 16 + _pad8(size)
        return objs


# ------------------------------------------------------------ the Keras view
class Hdf5Archive:
    """Read-only view of a Keras ``.h5`` full-model save (ref:
    modelimport.keras.Hdf5Archive), over :class:`Hdf5File`."""

    def __init__(self, path: Union[str, Path]):
        self._f = Hdf5File(path)

    def close(self) -> None:
        self._f.close()

    def _attr(self, name: str, group: str = None):
        g = self._f if group is None else self._f[group]
        v = g.attrs.get(name)
        return v.decode("utf-8") if isinstance(v, bytes) else v

    def model_config(self) -> Dict:
        from deeplearning4j_tpu_torch.modelimport.keras import \
            KerasImportError
        raw = self._attr("model_config")
        if raw is None:
            raise KerasImportError("h5 file has no 'model_config' attribute "
                                   "(weights-only file? full-model save "
                                   "required)")
        return json.loads(raw)

    def keras_version(self) -> str:
        v = self._attr("keras_version")
        if v is None and "model_weights" in self._f:
            v = self._attr("keras_version", "model_weights")
        return v or "unknown"

    def layer_weights(self, layer_name: str) -> Dict[str, np.ndarray]:
        """One layer's weights keyed by basename (kernel, bias, gamma,
        ...): a Bidirectional wrapper's under ``fwd/`` and ``bwd/``, a
        MultiHeadAttention's under its sub-projection (``query/``, ...).
        Each a numpy view of the file's buffer."""
        mw = self._f["model_weights"]
        if layer_name not in mw:
            return {}
        g = mw[layer_name]
        names = g.attrs.get("weight_names", [])
        out = {}
        for n in names:
            key = n.decode("utf-8") if isinstance(n, bytes) else str(n)
            parts = key.split("/")
            base = parts[-1].split(":")[0]
            # Bidirectional wrappers store forward_*/backward_* twin path
            # components whose basenames collide; match components only
            if any(p == "backward" or p.startswith("backward_")
                   for p in parts[:-1]):
                base = "bwd/" + base
            elif any(p == "forward" or p.startswith("forward_")
                     for p in parts[:-1]):
                base = "fwd/" + base
            elif len(parts) >= 2 and parts[-2] in ("query", "key", "value",
                                                   "attention_output"):
                base = f"{parts[-2]}/{base}"
            out[base] = g[key].read()
        return out
