"""BERT checkpoint import onto the port's transformer — the port of
``deeplearning4j_tpu/modelimport/bert.py``.

Reference parity: the reference's BERT workload enters by model import
(``nd4j/samediff-import-tensorflow``). Here a BERT checkpoint's weights
map onto ``models/transformer.py`` (``arch="postln_bert"``), whose
``encode``/``forward``/``make_train_step`` then run them, layer norms and
attention through the registry (and so through the CUDA kernels once
``ops.cuda_kernels.install_platform_overrides()`` has run).

Two key conventions are accepted:

- HuggingFace: ``bert.encoder.layer.N...`` keys, Linear weights
  ``[out, in]`` (transposed here to the port's ``[in, out]``);
- google-research TF names: ``bert/encoder/layer_N/.../kernel`` with
  ``[in, out]`` kernels and ``gamma``/``beta`` layer-norm names, as a
  key -> array dict.

Files: torch ``.bin``/``.pt`` (``torch.load(weights_only=True)``) and
``.safetensors``, read by :func:`load_safetensors` from the stdlib and
numpy (the card's machine has no ``safetensors`` package). query/key/value
fuse into the one ``wqkv`` matmul.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.models.transformer import TransformerConfig


class BertImportError(ValueError):
    pass


def _to_np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.numpy()
    return np.asarray(v)


def _strip_prefix(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Drop a leading 'bert.' / 'bert/' and normalize separators to '.'."""
    out = {}
    for k, v in state.items():
        k = k.replace("/", ".")
        if k.startswith("bert."):
            k = k[len("bert."):]
        out[k] = _to_np(v)
    return out


# TF-checkpoint naming -> HF naming (applied after separator normalization)
_TF_RENAMES = [
    (r"^embeddings\.word_embeddings$", "embeddings.word_embeddings.weight"),
    (r"^embeddings\.position_embeddings$",
     "embeddings.position_embeddings.weight"),
    (r"^embeddings\.token_type_embeddings$",
     "embeddings.token_type_embeddings.weight"),
    (r"^embeddings\.LayerNorm\.gamma$", "embeddings.LayerNorm.weight"),
    (r"^embeddings\.LayerNorm\.beta$", "embeddings.LayerNorm.bias"),
    (r"^encoder\.layer_(\d+)\.", r"encoder.layer.\1."),
    (r"attention\.output\.LayerNorm\.gamma$",
     "attention.output.LayerNorm.weight"),
    (r"attention\.output\.LayerNorm\.beta$",
     "attention.output.LayerNorm.bias"),
    (r"output\.LayerNorm\.gamma$", "output.LayerNorm.weight"),
    (r"output\.LayerNorm\.beta$", "output.LayerNorm.bias"),
    (r"\.kernel$", ".weight"),
]


def _normalize_keys(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        for pat, rep in _TF_RENAMES:
            k = re.sub(pat, rep, k)
        out[k] = v
    return out


def bert_config_from_state(state: Dict[str, np.ndarray], **overrides
                           ) -> TransformerConfig:
    """Infer the architecture from the weight shapes: a ``postln_bert``
    config in fp32 with BERT's ``layer_norm_eps=1e-12`` and ``E // 64``
    heads; ``overrides`` (e.g. ``use_flash_attention=True``) pass
    through."""
    V, E = state["embeddings.word_embeddings.weight"].shape
    P = state["embeddings.position_embeddings.weight"].shape[0]
    TV = state["embeddings.token_type_embeddings.weight"].shape[0] \
        if "embeddings.token_type_embeddings.weight" in state else 0
    layer_ids = {int(m.group(1)) for k in state
                 if (m := re.match(r"encoder\.layer\.(\d+)\.", k))}
    if not layer_ids:
        raise BertImportError("no encoder.layer.N.* keys found")
    L = max(layer_ids) + 1
    w1 = state["encoder.layer.0.intermediate.dense.weight"]
    F = w1.shape[0] if w1.shape[1] == E else w1.shape[1]
    kw = dict(vocab_size=V, d_model=E, n_layers=L, d_ff=F, max_len=P,
              causal=False, arch="postln_bert", type_vocab_size=TV,
              dtype=torch.float32, layer_norm_eps=1e-12)
    # n_heads is not derivable from shapes; BERT uses E/64 heads
    kw["n_heads"] = overrides.pop("n_heads", max(E // 64, 1))
    kw.update(overrides)
    return TransformerConfig(**kw)


def _detect_tf_format(raw_state: Dict[str, Any]) -> bool:
    """A checkpoint is TF-convention (google-research BERT) iff its raw
    keys use '/' separators or '.kernel' dense names. Decided ONCE per
    checkpoint, never from shapes: a per-shape guess mis-orients the
    square attention projections. '.gamma'/'.beta' alone do NOT imply TF:
    legacy HF torch checkpoints used 'LayerNorm.gamma' with [out, in]
    Linear weights."""
    return any("/" in k or k.endswith(".kernel") for k in raw_state)


def _linear(state, key, tf_format: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Dense weights -> (W [in, out], b [out]). HF Linear stores
    [out, in] (transposed here); TF kernels are [in, out] (taken as they
    are). The orientation follows the checkpoint's naming convention."""
    w = state[key + ".weight"]
    b = state.get(key + ".bias")
    if not tf_format:
        w = w.T
    if b is not None and b.shape[0] != w.shape[1]:
        raise BertImportError(
            f"{key}: bias length {b.shape[0]} does not match output dim "
            f"{w.shape[1]} (format detection: {'TF' if tf_format else 'HF'})")
    if b is None:
        b = np.zeros(w.shape[1], np.float32)
    return w, b


def bert_params_from_state(state: Dict[str, Any], cfg: TransformerConfig,
                           tf_format: bool = False, device=None) -> Dict:
    """Map a (normalized) BERT state dict onto the port's transformer
    params, as tensors of ``cfg.dtype`` on ``device``."""
    dev = resolve_device(device)
    dt = cfg.dtype

    def t(a):
        # a writable C-order fp32 copy only where the source is not one
        return torch.from_numpy(np.require(a, np.float32, ["C", "W"])).to(
            device=dev, dtype=dt)

    emb = {"tok": t(state["embeddings.word_embeddings.weight"]),
           "pos": t(state["embeddings.position_embeddings.weight"])}
    if cfg.type_vocab_size:
        emb["type"] = t(state["embeddings.token_type_embeddings.weight"])
    params = {
        "embed": emb,
        "emb_norm": {"g": t(state["embeddings.LayerNorm.weight"]),
                     "b": t(state["embeddings.LayerNorm.bias"])},
        "final_norm": {"g": torch.ones(cfg.d_model, dtype=dt, device=dev),
                       "b": torch.zeros(cfg.d_model, dtype=dt, device=dev)},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        wq, bq = _linear(state, p + "attention.self.query", tf_format)
        wk, bk = _linear(state, p + "attention.self.key", tf_format)
        wv, bv = _linear(state, p + "attention.self.value", tf_format)
        wo, bo = _linear(state, p + "attention.output.dense", tf_format)
        w1, b1 = _linear(state, p + "intermediate.dense", tf_format)
        w2, b2 = _linear(state, p + "output.dense", tf_format)
        params["layers"].append({
            "ln1": {"g": t(state[p + "attention.output.LayerNorm.weight"]),
                    "b": t(state[p + "attention.output.LayerNorm.bias"])},
            "wqkv": t(np.concatenate([wq, wk, wv], axis=1)),
            "bqkv": t(np.concatenate([bq, bk, bv])),
            "wo": t(wo),
            "bo": t(bo),
            "ln2": {"g": t(state[p + "output.LayerNorm.weight"]),
                    "b": t(state[p + "output.LayerNorm.bias"])},
            "w1": t(w1),
            "b1": t(b1),
            "w2": t(w2),
            "b2": t(b2),
        })
    return params


#: safetensors dtype names -> numpy (BF16 is read as its bits)
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "BF16": np.uint16}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.safetensors`` file: an 8-byte little-endian header
    length, a JSON header mapping each name to its dtype, shape and
    ``data_offsets`` into the byte buffer that follows. BF16 tensors come
    back as fp32 (exact). The file is read once; each array is a view of
    that buffer."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise BertImportError(f"{path}: not a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise BertImportError(f"{name}: dtype {info['dtype']} does not "
                                  "import")
        a, b = info["data_offsets"]
        arr = np.frombuffer(data[a:b], _ST_DTYPES[info["dtype"]]).reshape(
            info["shape"])
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a checkpoint file into a raw key -> array dict: torch
    ``.bin``/``.pt`` or ``.safetensors``."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return {k: _to_np(v) for k, v in state.items()}


def importBertModelAndWeights(path: str, device=None, **config_overrides
                              ) -> Tuple[TransformerConfig, Dict]:
    """Checkpoint file -> (TransformerConfig, params) on ``device`` (the
    card unless the caller asks for the CPU), ready for
    ``models.transformer.encode`` / ``forward`` / ``make_train_step`` or
    ``TransformerLM(cfg, params=params)``."""
    dev = resolve_device(device)
    raw = load_state_dict(path)
    tf_format = _detect_tf_format(raw)
    state = _normalize_keys(_strip_prefix(raw))
    cfg = bert_config_from_state(state, **config_overrides)
    return cfg, bert_params_from_state(state, cfg, tf_format=tf_format,
                                       device=dev)
