"""Tower checkpoints from disk -> serving-ready towers on the engine's
device, trainable f32 weights, and native towers written back.

Counterpart of `review_recommender_tpu/models/load.py`. Two directory
layouts:

  an HF snapshot (bge-small-en-v1.5, ms-marco-MiniLM-L-6-v2, ...):
    config.json                       BertConfig fields
    model.safetensors | pytorch_model.bin
    vocab.txt                         WordPiece vocabulary
  a native tower (the JAX package's save_native_tower / `rrt train`):
    config.json    {"format": "rrt-native-v1", "kind", "pooling",
                    "tokenizer": {"type": "hash" | "wordpiece", ...},
                    BertConfig fields}
    params.msgpack flax.serialization.to_bytes of the parameter tree
    vocab.txt      for a wordpiece tokenizer only

load_biencoder / load_crossencoder sniff the format marker and dispatch;
load_tower_params reads either layout to the f32 state_dict a trainer
starts from (a serving wrapper holds bf16 weights, and a fine-tune from
those would start from rounded weights); save_native_tower writes what the
JAX save_native_tower writes (config.json with the marker, params.msgpack
through write_flax_msgpack, vocab.txt for WordPiece), so both packages'
loaders serve the port's trained towers.
The readers are the port's own and run wherever the port runs: a
safetensors file is an 8-byte little-endian header length, a JSON header
and raw little-endian buffers (read with numpy.frombuffer); a .bin is read
with torch.load(weights_only=True); params.msgpack goes through a decoder
of the msgpack subset flax writes (maps, arrays, str, bin, ints, floats,
nil/bools, ext 1 = ndarray packed as (shape, dtype name, buffer), ext 3 =
numpy scalar, and flax's chunked form of arrays over 2^30 bytes). The
HF state dict becomes the flax tree (models/convert.py:convert_*), and
the flax tree the port's state_dict (params_from_flax).
write_flax_msgpack writes a tree of dicts with float32 leaves as
flax.serialization.to_bytes does (an array is ext 1 holding (shape, dtype
name, buffer)); arrays stay whole, where flax chunks those over 2^30
bytes, which the towers never reach.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import struct
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from review_recommender_tpu_torch.models.bert import BertConfig
from review_recommender_tpu_torch.models.convert import (
    convert_biencoder,
    convert_crossencoder,
    flax_from_params,
    params_from_flax,
)
from review_recommender_tpu_torch.models.encoder import BiEncoder, CrossEncoder
from review_recommender_tpu_torch.models.tokenizer import HashTokenizer, WordPieceTokenizer

logger = logging.getLogger(__name__)

NATIVE_FORMAT = "rrt-native-v1"

# ------------------------------------------------------------------ readers
_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
    "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) -> the same values in float32."""
    return (raw.astype(np.uint32) << 16).view(np.float32)


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """A safetensors file -> {name: numpy array}; BF16 comes back as f32
    (exact). Raises ValueError on a malformed file."""
    blob = Path(path).read_bytes()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", blob[:8])
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} runs past the file")
    header = json.loads(blob[8 : 8 + n].decode("utf-8"))
    data = memoryview(blob)[8 + n :]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype, shape = info["dtype"], tuple(int(s) for s in info["shape"])
        begin, end = (int(x) for x in info["data_offsets"])
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: {name} has offsets {begin}..{end} outside the data")
        buf = data[begin:end]
        if dtype == "BF16":
            arr = _bf16_to_f32(np.frombuffer(buf, dtype="<u2"))
        elif dtype in _ST_DTYPES:
            arr = np.frombuffer(buf, dtype=np.dtype(_ST_DTYPES[dtype]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: {name} has unsupported dtype {dtype}")
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {arr.size} values for shape {shape}")
        out[name] = arr.reshape(shape)
    return out


class _Msgpack:
    """Decoder of the msgpack subset flax.serialization writes."""

    def __init__(self, blob: bytes):
        self.b = memoryview(blob)
        self.i = 0

    def _take(self, n: int) -> memoryview:
        if self.i + n > len(self.b):
            raise ValueError("msgpack data ends early")
        out = self.b[self.i : self.i + n]
        self.i += n
        return out

    def _uint(self, n: int) -> int:
        return int.from_bytes(self._take(n), "big")

    def _ext(self, code: int, n: int):
        data = bytes(self._take(n))
        if code in (1, 3):  # ndarray, numpy scalar
            shape, dtype, buf = _Msgpack(data).decode()
            if dtype == "bfloat16":
                arr = _bf16_to_f32(np.frombuffer(buf, dtype="<u2"))
            else:
                arr = np.frombuffer(buf, dtype=np.dtype(dtype))
            arr = arr.reshape(tuple(shape))
            return arr[()] if code == 3 else arr
        raise ValueError(f"msgpack ext type {code} is not one flax writes")

    def decode(self):
        t = self._uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.decode() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return bytes(self._take(t & 0x1F)).decode("utf-8")
        if t == 0xC0:
            return None
        if t in (0xC2, 0xC3):
            return t == 0xC3
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._uint(1 << (t - 0xC7))
            return self._ext(struct.unpack("b", self._take(1))[0], n)
        if t == 0xCA:
            return struct.unpack(">f", self._take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self._take(8))[0]
        if 0xCC <= t <= 0xCF:  # uint 8..64
            return self._uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:  # int 8..64
            n = 1 << (t - 0xD0)
            return int.from_bytes(self._take(n), "big", signed=True)
        if 0xD4 <= t <= 0xD8:  # fixext 1..16
            code = struct.unpack("b", self._take(1))[0]
            return self._ext(code, 1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return bytes(self._take(self._uint(1 << (t - 0xD9)))).decode("utf-8")
        if t in (0xDC, 0xDD):  # array 16/32
            return [self.decode() for _ in range(self._uint(2 if t == 0xDC else 4))]
        if t in (0xDE, 0xDF):  # map 16/32
            return self._map(self._uint(2 if t == 0xDE else 4))
        raise ValueError(f"msgpack type byte 0x{t:02x} is not one flax writes")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.decode()
            out[k] = self.decode()
        return out


def _unchunk(tree):
    """flax's chunked form {"__msgpack_chunked_array__": True, "shape":
    {"0": ...}, "chunks": {"0": ...}} -> one array, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(blob: bytes):
    """flax.serialization.to_bytes output -> the tree (dicts of numpy)."""
    dec = _Msgpack(blob)
    tree = dec.decode()
    if dec.i != len(blob):
        raise ValueError(f"msgpack data has {len(blob) - dec.i} trailing bytes")
    return _unchunk(tree)


def write_flax_msgpack(tree) -> bytes:
    """A tree of dicts (str keys) with numpy leaves -> msgpack bytes that
    flax.serialization.msgpack_restore (and read_flax_msgpack) read; every
    array is written as float32."""

    def raw(tag, n, small, codes):
        if n < small:
            return bytes([tag | n])
        for width, code in codes:
            if n < 1 << (8 * width):
                return bytes([code]) + n.to_bytes(width, "big")
        raise ValueError(f"msgpack length {n} too large")

    def pack(x) -> bytes:
        if isinstance(x, dict):
            return raw(0x80, len(x), 16, ((2, 0xDE), (4, 0xDF))) + b"".join(
                pack(k) + pack(v) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return raw(0x90, len(x), 16, ((2, 0xDC), (4, 0xDD))) + b"".join(pack(v) for v in x)
        if isinstance(x, str):
            b = x.encode()
            return raw(0xA0, len(b), 32, ((1, 0xD9), (2, 0xDA), (4, 0xDB))) + b
        if isinstance(x, bytes):
            return raw(0, len(x), 0, ((1, 0xC4), (2, 0xC5), (4, 0xC6))) + x
        if isinstance(x, int) and 0 <= x < 2**32:
            return bytes([x]) if x < 128 else b"\xce" + struct.pack(">I", x)
        if isinstance(x, np.ndarray):
            arr = np.ascontiguousarray(x, dtype=np.float32)
            body = pack([list(arr.shape), "float32", arr.tobytes()])
            return raw(0, len(body), 0, ((1, 0xC7), (2, 0xC8), (4, 0xC9))) + b"\x01" + body
        raise TypeError(f"write_flax_msgpack cannot write {type(x).__name__}")

    return pack(tree)


def _load_state_dict(model_dir: Path) -> Dict[str, object]:
    """model.safetensors (the port's reader) or pytorch_model.bin."""
    st = model_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bin_path = model_dir / "pytorch_model.bin"
    if bin_path.exists():
        return dict(torch.load(bin_path, map_location="cpu", weights_only=True))
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {model_dir}")


# ------------------------------------------------------------ HF snapshots
def _config_from_json(path: Path) -> BertConfig:
    cfg = json.loads(Path(path).read_text())
    return BertConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        max_position=cfg.get("max_position_embeddings", 512),
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        hidden_act=cfg.get("hidden_act", "gelu"),
        pad_token_id=cfg.get("pad_token_id", 0),
    )


def _tokenizer(model_dir: Path) -> WordPieceTokenizer:
    vocab = model_dir / "vocab.txt"
    if not vocab.exists():
        raise FileNotFoundError(f"no vocab.txt in {model_dir}")
    return WordPieceTokenizer.from_vocab_file(vocab)


def load_tower_params(model_dir, kind: str):
    """An HF snapshot or native tower directory -> (BertConfig, f32 CPU
    state_dict, tokenizer, pooling: the native config's, else None)."""
    model_dir = Path(model_dir)
    if kind not in ("biencoder", "crossencoder"):
        raise ValueError(f"kind must be 'biencoder' or 'crossencoder', got {kind!r}")
    if _is_native(model_dir):
        cfg, sd, tokenizer, meta = _load_native(model_dir, kind)
        return cfg, sd, tokenizer, meta.get("pooling", "cls")
    cfg = _config_from_json(model_dir / "config.json")
    convert = convert_biencoder if kind == "biencoder" else convert_crossencoder
    params = convert(_load_state_dict(model_dir), cfg)
    return cfg, params_from_flax(params, cfg, kind), _tokenizer(model_dir), None


def load_biencoder(model_dir, pooling: str = "cls", **kw) -> BiEncoder:
    """HF BertModel snapshot or native tower directory -> BiEncoder; kw go
    to BiEncoder (device, dtype, max_len, attn_impl). A native tower pools
    as its config says; `pooling` is an HF snapshot's."""
    cfg, sd, tokenizer, native_pooling = load_tower_params(model_dir, "biencoder")
    tower = BiEncoder(cfg, sd, tokenizer, pooling=native_pooling or pooling, **kw)
    logger.info("loaded bi-encoder from %s (%dL, H=%d)", model_dir, cfg.num_layers,
                cfg.hidden_size)
    return tower


def load_crossencoder(model_dir, **kw) -> CrossEncoder:
    """HF BertForSequenceClassification snapshot or native tower directory
    -> CrossEncoder."""
    cfg, sd, tokenizer, _pooling = load_tower_params(model_dir, "crossencoder")
    tower = CrossEncoder(cfg, sd, tokenizer, **kw)
    logger.info("loaded cross-encoder from %s (%dL)", model_dir, cfg.num_layers)
    return tower


# ------------------------------------------------------------ native towers
def _is_native(model_dir: Path) -> bool:
    cfg_path = model_dir / "config.json"
    if not cfg_path.exists():
        return False
    try:
        return json.loads(cfg_path.read_text()).get("format") == NATIVE_FORMAT
    except (json.JSONDecodeError, OSError):
        return False


def _tokenizer_spec(tokenizer) -> dict:
    if isinstance(tokenizer, HashTokenizer):
        return {"type": "hash", "vocab_size": tokenizer.vocab_size,
                "lowercase": tokenizer.lowercase}
    if isinstance(tokenizer, WordPieceTokenizer):
        return {"type": "wordpiece", "lowercase": tokenizer.lowercase}
    raise TypeError(f"unsupported tokenizer: {type(tokenizer).__name__}")


def save_native_tower(out_dir, kind: str, cfg: BertConfig, params, tokenizer,
                      pooling: str = "cls") -> Path:
    """A trained tower (a trainer's state_dict) -> a native tower directory
    that load_biencoder / load_crossencoder here and in the JAX package
    serve. params.msgpack is written to a .tmp file and renamed."""
    if kind not in ("biencoder", "crossencoder"):
        raise ValueError(f"kind must be 'biencoder' or 'crossencoder', got {kind!r}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = _tokenizer_spec(tokenizer)
    if spec["type"] == "wordpiece":
        by_id = sorted(tokenizer.vocab.items(), key=lambda kv: kv[1])
        if [i for _, i in by_id] != list(range(len(by_id))):
            raise ValueError("wordpiece vocab ids must be dense 0..V-1")
        (out_dir / "vocab.txt").write_text("\n".join(t for t, _ in by_id) + "\n",
                                           encoding="utf-8")
    meta = {"format": NATIVE_FORMAT, "kind": kind, "pooling": pooling,
            "tokenizer": spec, **dataclasses.asdict(cfg)}
    (out_dir / "config.json").write_text(json.dumps(meta, indent=2))
    tmp = out_dir / "params.msgpack.tmp"
    tmp.write_bytes(write_flax_msgpack(flax_from_params(params, cfg, kind)))
    tmp.replace(out_dir / "params.msgpack")
    logger.info("saved native %s tower to %s", kind, out_dir)
    return out_dir


def _tokenizer_from_spec(spec: dict, model_dir: Path):
    if spec["type"] == "hash":
        return HashTokenizer(vocab_size=int(spec["vocab_size"]),
                             lowercase=bool(spec.get("lowercase", True)))
    if spec["type"] == "wordpiece":
        return WordPieceTokenizer.from_vocab_file(model_dir / "vocab.txt",
                                                  lowercase=bool(spec.get("lowercase", True)))
    raise ValueError(f"unknown tokenizer type: {spec['type']}")


def _load_native(model_dir: Path, expect_kind: str):
    meta = json.loads((model_dir / "config.json").read_text())
    if meta.get("kind") != expect_kind:
        raise ValueError(f"{model_dir} holds a {meta.get('kind')!r} tower, "
                         f"expected {expect_kind!r}")
    fields = {f.name for f in dataclasses.fields(BertConfig)}
    cfg = BertConfig(**{k: v for k, v in meta.items() if k in fields})
    params = read_flax_msgpack((model_dir / "params.msgpack").read_bytes())
    tokenizer = _tokenizer_from_spec(meta["tokenizer"], model_dir)
    return cfg, params_from_flax(params, cfg, expect_kind), tokenizer, meta


