"""Keras ``.h5`` fixtures without h5py or Keras: what ``tf_fixtures.py`` is
for the TF importers, this is for ``modelimport.keras``.

Two pieces:

- :class:`H5Writer`, a minimal HDF5 writer: superblock version 0,
  symbol-table groups (one version-1 B-tree node over ``SNOD`` nodes and
  a local heap each), version-1 object headers, contiguous datasets, and
  numeric, fixed-length string and variable-length string attributes
  (the strings in one global heap collection). It writes only what
  ``modelimport.hdf5`` reads, in the layout h5py gives a Keras save.
- :func:`encoder_h5`, a Keras 3 functional full-model save of a
  BERT-shaped encoder written in stock Keras layers (keras.io's "Text
  classification with Transformer" block, post-LN): token and position
  ``Embedding``s -> ``Add`` -> ``LayerNormalization``, then ``L`` blocks of
  [``MultiHeadAttention(x, x)`` -> ``Add`` -> ``LayerNormalization`` ->
  ``TimeDistributed(Dense(F, gelu))`` -> ``TimeDistributed(Dense(E))`` ->
  ``Add`` -> ``LayerNormalization``], then ``GlobalAveragePooling1D`` ->
  ``Dense(n_classes, softmax)``; eps 1e-12, fp32 weights from
  ``numpy.random.default_rng(seed)``.

They exist because the card's machine has neither Keras nor h5py; a CPU
test holds the files they write against h5py and
``keras.models.load_model``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from deeplearning4j_tpu_torch.modelimport.hdf5 import SIGNATURE, UNDEFINED

#: symbol-table node sizes written into the superblock: a leaf (SNOD)
#: holds up to 2 * LEAF_K links, a B-tree node up to 2 * INTERNAL_K leaves
LEAF_K = 16
INTERNAL_K = 32
_SNOD_SIZE = 8 + 2 * LEAF_K * 40
_TREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
_SUPERBLOCK = 96
_HEAP_FREE_NULL = 1           # the local heap's "no free block"
_DATA_ALIGN = 64


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _float_type(size: int) -> bytes:
    sign, exp_loc, exp_size, mant, bias = {
        2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
        8: (63, 52, 11, 52, 1023)}[size]
    return (bytes([0x11, 0x20, sign, 0]) + struct.pack("<I", size)
            + struct.pack("<HHBBBBI", 0, 8 * size, exp_loc, exp_size, 0,
                          mant, bias))


def _int_type(dt: np.dtype) -> bytes:
    return (bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
            + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))


_VLEN_STR = (bytes([0x19, 0x01, 0x01, 0x00]) + struct.pack("<I", 16)
             + bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8))


def _datatype(dt: np.dtype) -> bytes:
    dt = np.dtype(dt)
    if dt.kind == "f":
        return _float_type(dt.itemsize)
    if dt.kind in "iu":
        return _int_type(dt)
    if dt.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + struct.pack("<I", dt.itemsize)
    raise TypeError(f"no HDF5 datatype for {dt}")


def _dataspace(shape: Tuple[int, ...]) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + b"".join(
        struct.pack("<Q", int(d)) for d in shape)


def _message(mtype: int, data: bytes) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _is_text(v) -> bool:
    return isinstance(v, str) or (
        isinstance(v, (list, tuple, np.ndarray)) and len(v) > 0
        and all(isinstance(s, str) for s in v))


class _Group:
    def __init__(self):
        self.attrs: Dict[str, object] = {}
        self.children: Dict[str, Union["_Group", "_Dataset"]] = {}


class _Dataset:
    def __init__(self, array: np.ndarray):
        self.array = np.ascontiguousarray(array)
        if self.array.dtype.byteorder == ">":
            raise TypeError("big-endian datasets are not written")
        self.attrs: Dict[str, object] = {}


class H5Writer:
    """Build a tree of groups, datasets and attributes, then :meth:`write`
    it as one HDF5 file. Attribute values: ``str`` (a variable-length
    UTF-8 string), a list of ``str`` (an array of them), ``bytes`` or a
    numpy ``S`` array (fixed-length), or a numeric numpy value."""

    def __init__(self):
        self.root = _Group()

    def _walk(self, path: str, create: bool):
        node = self.root
        for part in [p for p in path.split("/") if p]:
            if part not in node.children:
                if not create:
                    raise KeyError(path)
                node.children[part] = _Group()
            node = node.children[part]
        return node

    def group(self, path: str) -> "H5Writer":
        self._walk(path, True)
        return self

    def dataset(self, path: str, array) -> "H5Writer":
        parent, _, name = path.rstrip("/").rpartition("/")
        self._walk(parent, True).children[name] = _Dataset(np.asarray(array))
        return self

    def attr(self, path: str, name: str, value) -> "H5Writer":
        self._walk(path, False).attrs[name] = value
        return self

    # ------------------------------------------------------------ writing
    def write(self, path: Union[str, Path]) -> None:
        nodes: List[Tuple[str, object]] = []

        def collect(name, node):
            nodes.append((name, node))
            if isinstance(node, _Group):
                for k in sorted(node.children, key=str.encode):
                    collect(f"{name.rstrip('/')}/{k}", node.children[k])
        collect("/", self.root)

        # the global heap: every variable-length string, one object each
        strings: List[bytes] = []
        for _, node in nodes:
            for v in node.attrs.values():
                if _is_text(v):
                    vals = [v] if isinstance(v, str) else list(v)
                    strings.extend(s.encode("utf-8") for s in vals)
        if len(strings) >= 1 << 16:
            raise ValueError("more strings than one heap collection holds")
        used = 16 + sum(16 + len(_pad8(s)) for s in strings)
        gcol_size = max(4096, used + 16)
        addr = _SUPERBLOCK
        gcol_addr, addr = addr, addr + gcol_size

        # addresses: each object's header (and a group's heap, B-tree
        # node and SNODs) in walk order, then the datasets' data
        heap_ids = iter(range(1, len(strings) + 1))
        plan = {}
        for name, node in nodes:
            msgs = self._attr_messages(node, gcol_addr, heap_ids)
            entry = {"attrs": msgs}
            if isinstance(node, _Group):
                names = sorted(node.children, key=str.encode)
                heap, offs = [b"\0" * 8], {}
                pos = 8
                for k in names:
                    offs[k] = pos
                    b = _pad8(k.encode("utf-8") + b"\0")
                    heap.append(b)
                    pos += len(b)
                n_snod = max(1, -(-len(names) // (2 * LEAF_K)))
                if n_snod > 2 * INTERNAL_K:
                    raise ValueError(f"{name}: more links than one B-tree "
                                     "node holds")
                header_size = 16 + len(_message(0x11, b"\0" * 16)) + \
                    sum(len(m) for m in msgs)
                entry.update(names=names, offs=offs, heap=b"".join(heap),
                             header=addr)
                addr += header_size
                entry["heap_addr"], addr = addr, addr + 32
                entry["heap_data"], addr = addr, addr + pos
                entry["tree"], addr = addr, addr + _TREE_SIZE
                entry["snods"] = []
                for _ in range(n_snod):
                    entry["snods"].append(addr)
                    addr += _SNOD_SIZE
            else:
                entry["header"] = addr
                addr += len(_object_header(self._dataset_messages(
                    node, 0) + msgs))
            plan[name] = entry
        for name, node in nodes:
            if isinstance(node, _Dataset):
                addr += -addr % _DATA_ALIGN
                plan[name]["data"] = addr
                addr += node.array.nbytes

        out = bytearray(addr)

        def put(at: int, b: bytes) -> None:
            out[at:at + len(b)] = b

        # superblock version 0 and the root's symbol table entry
        root = plan["/"]
        put(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", LEAF_K, INTERNAL_K, 0)
            + struct.pack("<QQQQ", 0, UNDEFINED, addr, UNDEFINED)
            + struct.pack("<QQII", 0, root["header"], 1, 0)
            + struct.pack("<QQ", root["tree"], root["heap_addr"]))
        # the global heap collection, its free space last
        g = bytearray(b"GCOL" + bytes([1, 0, 0, 0])
                      + struct.pack("<Q", gcol_size))
        for i, s in enumerate(strings, 1):
            g += struct.pack("<HHIQ", i, 1, 0, len(s)) + _pad8(s)
        g += struct.pack("<HHIQ", 0, 0, 0, gcol_size - len(g))
        put(gcol_addr, bytes(g))

        for name, node in nodes:
            p = plan[name]
            if isinstance(node, _Dataset):
                put(p["header"], _object_header(
                    self._dataset_messages(node, p["data"]) + p["attrs"]))
                put(p["data"], node.array.tobytes())
                continue
            stab = struct.pack("<QQ", p["tree"], p["heap_addr"])
            put(p["header"], _object_header([_message(0x11, stab)]
                                            + p["attrs"]))
            put(p["heap_addr"], b"HEAP" + bytes(4) + struct.pack(
                "<QQQ", len(p["heap"]), _HEAP_FREE_NULL, p["heap_data"]))
            put(p["heap_data"], p["heap"])
            names = p["names"]
            chunks = [names[i:i + 2 * LEAF_K]
                      for i in range(0, len(names), 2 * LEAF_K)] or [[]]
            tree = bytearray(b"TREE" + bytes([0, 0]) + struct.pack(
                "<HQQ", len(chunks), UNDEFINED, UNDEFINED))
            tree += struct.pack("<Q", 0)
            for chunk, snod in zip(chunks, p["snods"]):
                last = p["offs"][chunk[-1]] if chunk else 0
                tree += struct.pack("<QQ", snod, last)
            put(p["tree"], bytes(tree))
            for chunk, snod in zip(chunks, p["snods"]):
                s = bytearray(b"SNOD" + bytes([1, 0])
                              + struct.pack("<H", len(chunk)))
                for k in chunk:
                    child = plan[f"{name.rstrip('/')}/{k}"]
                    if "tree" in child:
                        s += struct.pack("<QQII", p["offs"][k],
                                         child["header"], 1, 0)
                        s += struct.pack("<QQ", child["tree"],
                                         child["heap_addr"])
                    else:
                        s += struct.pack("<QQII16x", p["offs"][k],
                                         child["header"], 0, 0)
                put(snod, bytes(s))
        Path(path).write_bytes(bytes(out))

    @staticmethod
    def _dataset_messages(node: _Dataset, data_addr: int) -> List[bytes]:
        a = node.array
        return [_message(0x1, _dataspace(a.shape)),
                _message(0x3, _datatype(a.dtype)),
                _message(0x5, bytes([2, 2, 2, 1, 0, 0, 0, 0])),
                _message(0x8, bytes([3, 1]) + struct.pack(
                    "<QQ", data_addr, a.nbytes))]

    @staticmethod
    def _attr_messages(node, gcol_addr: int, heap_ids) -> List[bytes]:
        msgs = []
        for name, v in node.attrs.items():
            if _is_text(v):
                vals = [v] if isinstance(v, str) else list(v)
                shape = () if isinstance(v, str) else (len(vals),)
                dt = _VLEN_STR
                data = b"".join(
                    struct.pack("<IQI", len(s.encode("utf-8")), gcol_addr,
                                next(heap_ids)) for s in vals)
            else:
                a = np.asarray(v)
                if a.dtype == object or a.dtype.kind == "U":
                    raise TypeError(f"attribute {name!r}: {a.dtype}")
                shape, dt, data = a.shape, _datatype(a.dtype), a.tobytes()
            nb = name.encode("utf-8") + b"\0"
            ds = _dataspace(shape)
            body = (struct.pack("<BBHHH", 1, 0, len(nb), len(dt), len(ds))
                    + _pad8(nb) + _pad8(dt) + _pad8(ds) + data)
            msgs.append(_message(0xC, body))
        return msgs


# ------------------------------------------------------------ Keras saves
KERAS_VERSION = "3.13.1"


def keras_h5(path: Union[str, Path], model_config: Dict,
             weights: Dict[str, List[Tuple[str, np.ndarray]]],
             layer_names: List[str]) -> None:
    """A Keras full-model ``.h5`` save as Keras 3's legacy writer lays it
    out: ``model_config`` (JSON), ``keras_version`` and ``backend`` on the
    root; ``model_weights/<layer>`` for every layer, its ``weight_names``
    (paths below the layer's group, in the layer's weight order) and the
    datasets they name."""
    w = H5Writer()
    w.attr("/", "backend", "tensorflow")
    w.attr("/", "keras_version", KERAS_VERSION)
    w.attr("/", "model_config", json.dumps(model_config))
    w.group("model_weights")
    w.attr("model_weights", "backend", "tensorflow")
    w.attr("model_weights", "keras_version", KERAS_VERSION)
    w.attr("model_weights", "layer_names", list(layer_names))
    for layer in list(layer_names) + ["top_level_model_weights"]:
        g = f"model_weights/{layer}"
        w.group(g)
        pairs = weights.get(layer, [])
        for wname, arr in pairs:
            w.dataset(f"{g}/{wname}", np.asarray(arr, np.float32))
        w.attr(g, "weight_names", [n for n, _ in pairs] if pairs
               else np.zeros((0,), np.float64))
    w.write(path)


def _tensor(producer: str, shape) -> Dict:
    return {"class_name": "__keras_tensor__",
            "config": {"shape": list(shape), "dtype": "float32",
                       "keras_history": [producer, 0, 0]}}


def _layer(cls: str, name: str, config: Dict, args=None,
           kwargs=None) -> Dict:
    entry = {"module": "keras.layers", "class_name": cls,
             "config": {"name": name, "trainable": True,
                        "dtype": "float32", **config},
             "registered_name": None, "name": name, "inbound_nodes": []}
    if args is not None:
        entry["inbound_nodes"] = [{"args": args, "kwargs": kwargs or {}}]
    return entry


def encoder_config(V: int, P: int, E: int, H: int, L: int, F: int,
                   n_classes: int, T: int) -> Tuple[Dict, List[str]]:
    """The encoder's Keras 3 functional ``model_config`` (see the module
    docstring) and its layer names in order. Inputs ``tokens`` and
    ``positions`` are int32 ``[None, T]``."""
    seq = [None, T, E]
    layers = []
    for name in ("tokens", "positions"):
        layers.append({"module": "keras.layers", "class_name": "InputLayer",
                       "config": {"batch_shape": [None, T], "dtype": "int32",
                                  "sparse": False, "name": name},
                       "registered_name": None, "name": name,
                       "inbound_nodes": []})
    for name, src, n in (("tok_embed", "tokens", V),
                         ("pos_embed", "positions", P)):
        t = _tensor(src, [None, T])
        t["config"]["dtype"] = "int32"
        layers.append(_layer("Embedding", name,
                             {"input_dim": n, "output_dim": E}, [t]))
    layers.append(_layer("Add", "embed_add", {}, [[
        _tensor("tok_embed", seq), _tensor("pos_embed", seq)]]))

    def ln(name, src):
        layers.append(_layer("LayerNormalization", name,
                             {"axis": [-1], "epsilon": 1e-12},
                             [_tensor(src, seq)]))
    ln("embed_ln", "embed_add")
    x = "embed_ln"
    for i in range(L):
        layers.append(_layer(
            "MultiHeadAttention", f"mha_{i}",
            {"num_heads": H, "key_dim": E // H, "value_dim": E // H,
             "use_bias": True, "attention_axes": [1]},
            [_tensor(x, seq), _tensor(x, seq)]))
        layers.append(_layer("Add", f"attn_add_{i}", {}, [[
            _tensor(x, seq), _tensor(f"mha_{i}", seq)]]))
        ln(f"attn_ln_{i}", f"attn_add_{i}")
        for name, src, units, act, shape in (
                (f"ffn_in_{i}", f"attn_ln_{i}", F, "gelu", seq),
                (f"ffn_out_{i}", f"ffn_in_{i}", E, "linear",
                 [None, T, F])):
            inner = {"module": "keras.layers", "class_name": "Dense",
                     "config": {"name": f"{name}_dense", "trainable": True,
                                "dtype": "float32", "units": units,
                                "activation": act, "use_bias": True},
                     "registered_name": None}
            layers.append(_layer("TimeDistributed", name, {"layer": inner},
                                 [_tensor(src, shape)], {"mask": None}))
        layers.append(_layer("Add", f"ffn_add_{i}", {}, [[
            _tensor(f"attn_ln_{i}", seq), _tensor(f"ffn_out_{i}", seq)]]))
        ln(f"ffn_ln_{i}", f"ffn_add_{i}")
        x = f"ffn_ln_{i}"
    layers.append(_layer("GlobalAveragePooling1D", "pool",
                         {"data_format": "channels_last", "keepdims": False},
                         [_tensor(x, seq)], {"mask": None}))
    layers.append(_layer("Dense", "head",
                         {"units": n_classes, "activation": "softmax",
                          "use_bias": True}, [_tensor("pool", [None, E])]))
    config = {"class_name": "Functional", "config": {
        "name": "encoder", "trainable": True, "layers": layers,
        "input_layers": [["tokens", 0, 0], ["positions", 0, 0]],
        "output_layers": ["head", 0, 0]}}
    return config, [entry["name"] for entry in layers]


def encoder_weights(seed: int, V: int, P: int, E: int, H: int, L: int,
                    F: int, n_classes: int
                    ) -> Dict[str, List[Tuple[str, np.ndarray]]]:
    """The encoder's weights by layer, each a list of ``(path below the
    layer's group, array)`` in Keras's weight order, drawn from
    ``default_rng(seed)``: kernels and embeddings N(0, 0.02^2) (BERT's
    initializer range), biases N(0, 0.02^2), LayerNorm gamma 1 + N(0,
    0.1^2) and beta N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    hd = E // H

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    def ln(name):
        return [(f"{name}/gamma", 1.0 + normal((E,), 0.1)),
                (f"{name}/beta", normal((E,), 0.1))]

    w: Dict[str, List[Tuple[str, np.ndarray]]] = {
        "tok_embed": [("tok_embed/embeddings", normal((V, E), 0.02))],
        "pos_embed": [("pos_embed/embeddings", normal((P, E), 0.02))],
        "embed_ln": ln("embed_ln")}
    for i in range(L):
        m = f"mha_{i}"
        w[m] = []
        for proj in ("query", "key", "value"):
            w[m] += [(f"{m}/{proj}/kernel", normal((E, H, hd), 0.02)),
                     (f"{m}/{proj}/bias", normal((H, hd), 0.02))]
        w[m] += [(f"{m}/attention_output/kernel", normal((H, hd, E), 0.02)),
                 (f"{m}/attention_output/bias", normal((E,), 0.02))]
        w[f"attn_ln_{i}"] = ln(f"attn_ln_{i}")
        for name, n_in, n_out in ((f"ffn_in_{i}", E, F),
                                  (f"ffn_out_{i}", F, E)):
            w[name] = [(f"{name}/{name}_dense/kernel",
                        normal((n_in, n_out), 0.02)),
                       (f"{name}/{name}_dense/bias", normal((n_out,), 0.02))]
        w[f"ffn_ln_{i}"] = ln(f"ffn_ln_{i}")
    w["head"] = [("head/kernel", normal((E, n_classes), 0.02)),
                 ("head/bias", normal((n_classes,), 0.02))]
    return w


def encoder_h5(path: Union[str, Path], seed: int = 0, *, V: int = 30522,
               P: int = 512, E: int = 768, H: int = 12, L: int = 12,
               F: int = 3072, n_classes: int = 2, T: int = None) -> int:
    """Write the encoder as a Keras ``.h5`` full-model save at ``path``
    (BERT-base's widths by default) and return its parameter count. ``T``
    is the sequence length its inputs declare (``P`` unless given)."""
    config, names = encoder_config(V, P, E, H, L, F, n_classes,
                                   P if T is None else T)
    weights = encoder_weights(seed, V, P, E, H, L, F, n_classes)
    keras_h5(path, config, weights, names)
    return sum(a.size for pairs in weights.values() for _, a in pairs)
