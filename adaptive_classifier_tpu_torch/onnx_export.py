"""ONNX export of the encoder: ``model.onnx`` and ``model_quantized.onnx``.

Counterpart of ``adaptive_classifier_tpu/onnx_export.py``, numpy only:

- a minimal **protobuf writer** for the ONNX ``ModelProto`` wire format
  (only the dozen message types the encoder graph uses);
- a **graph builder** that emits the classic-BERT-family encoder (BERT,
  DistilBERT, RoBERTa, ELECTRA with absolute position embeddings) from the
  stacked-layer float32 tree (``Encoder.float_tree``) as an opset-17 graph
  with dynamic batch and sequence axes: ``last_hidden_state`` and a fused
  ``sentence_embedding`` (pool + L2-normalize, as ``embed_texts_device``);
- a weight-only **int8 variant** (``model_quantized.onnx``): every MatMul
  weight an int8 initializer with a per-tensor scale behind
  ``DequantizeLinear``;
- a **protobuf reader and numpy interpreter** (``OnnxLiteModel``) for the
  op set emitted, so the artifact can be run without ONNX Runtime.  It
  reads the file through a ``memoryview``: an initializer's bytes are
  sliced, not copied field by field, so a full-width model (~160 MB of
  float32) parses in well under a second.

The builder's code, producer string and graph name are the JAX package's,
so the same weights give the same file byte for byte.  The families with
rotary or relative positions (ModernBERT, MPNet, DeBERTa) raise
``ValueError``: an artifact that dropped their position handling would
be worse than none.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

import numpy as np

# ---------------------------------------------------------------------------
# protobuf wire-format writer (the subset ONNX needs)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    if n < 0:                      # proto int64: two's complement, 10 bytes
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _f_string(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _packed_int64(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _f_bytes(field, payload)


#: TensorProto.DataType values (onnx.proto)
_DT_FLOAT, _DT_INT8, _DT_INT32, _DT_INT64 = 1, 3, 6, 7

_NP_TO_DT = {
    np.dtype(np.float32): _DT_FLOAT,
    np.dtype(np.int8): _DT_INT8,
    np.dtype(np.int32): _DT_INT32,
    np.dtype(np.int64): _DT_INT64,
}
_DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    # NOT ascontiguousarray: it promotes 0-d scalars to 1-d, which changes
    # Gather semantics (a [] index drops the axis; a [1] index keeps it).
    # tobytes() below already produces a C-order copy for any layout.
    arr = np.asarray(arr)
    dt = _NP_TO_DT[arr.dtype]
    out = b"".join(_f_varint(1, int(d)) for d in arr.shape)   # dims
    out += _f_varint(2, dt)                                    # data_type
    out += _f_string(8, name)                                  # name
    out += _f_bytes(9, arr.tobytes())                          # raw_data (LE)
    return out


#: AttributeProto.AttributeType values
_AT_FLOAT, _AT_INT, _AT_STRING, _AT_INTS = 1, 2, 3, 7


def _attribute(name: str, value: Any) -> bytes:
    out = _f_string(1, name)
    if isinstance(value, bool):
        raise TypeError("use int attrs for ONNX bools")
    if isinstance(value, float):
        out += _f_float(2, value) + _f_varint(20, _AT_FLOAT)
    elif isinstance(value, int):
        out += _f_varint(3, value) + _f_varint(20, _AT_INT)
    elif isinstance(value, str):
        out += _f_bytes(4, value.encode()) + _f_varint(20, _AT_STRING)
    elif isinstance(value, (list, tuple)) and all(isinstance(v, int) for v in value):
        out += _packed_int64(8, value) + _f_varint(20, _AT_INTS)
    else:
        raise TypeError(f"unsupported attribute {name}={value!r}")
    return out


def _node_proto(op: str, inputs: Sequence[str], outputs: Sequence[str],
                name: str, attrs: Dict[str, Any]) -> bytes:
    out = b"".join(_f_string(1, i) for i in inputs)
    out += b"".join(_f_string(2, o) for o in outputs)
    out += _f_string(3, name)
    out += _f_string(4, op)
    out += b"".join(_f_bytes(5, _attribute(k, v)) for k, v in attrs.items())
    return out


def _value_info(name: str, elem_type: int,
                dims: Sequence[Union[int, str]]) -> bytes:
    shape = b""
    for d in dims:
        if isinstance(d, str):
            dim = _f_string(3, d)          # dim_param
        else:
            dim = _f_varint(1, d)          # dim_value
        shape += _f_bytes(1, dim)
    tensor_type = _f_varint(1, elem_type) + _f_bytes(2, shape)
    type_proto = _f_bytes(1, tensor_type)
    return _f_string(1, name) + _f_bytes(2, type_proto)


class GraphBuilder:
    """Accumulates nodes/initializers and serializes one ModelProto."""

    OPSET = 17

    def __init__(self, name: str):
        self.name = name
        self._nodes: List[bytes] = []
        self._initializers: List[bytes] = []
        self._inputs: List[bytes] = []
        self._outputs: List[bytes] = []
        self._counter = 0

    def fresh(self, hint: str) -> str:
        self._counter += 1
        return f"{hint}_{self._counter}"

    def init_tensor(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self._initializers.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op: str, inputs: Sequence[str], n_out: int = 1,
             **attrs: Any) -> Union[str, List[str]]:
        name = self.fresh(op.lower())
        outputs = [f"{name}_out{i}" if n_out > 1 else f"{name}_out"
                   for i in range(n_out)]
        self._nodes.append(_node_proto(op, inputs, outputs, name, attrs))
        return outputs if n_out > 1 else outputs[0]

    def graph_input(self, name: str, elem_type: int,
                    dims: Sequence[Union[int, str]]) -> str:
        self._inputs.append(_value_info(name, elem_type, dims))
        return name

    def graph_output(self, value: str, name: str, elem_type: int,
                     dims: Sequence[Union[int, str]]) -> None:
        # Identity gives the output its public name
        self._nodes.append(_node_proto("Identity", [value], [name],
                                       self.fresh("identity"), {}))
        self._outputs.append(_value_info(name, elem_type, dims))

    def serialize(self, producer: str = "adaptive-classifier-tpu") -> bytes:
        graph = b"".join(_f_bytes(1, n) for n in self._nodes)
        graph += _f_string(2, self.name)
        graph += b"".join(_f_bytes(5, t) for t in self._initializers)
        graph += b"".join(_f_bytes(11, i) for i in self._inputs)
        graph += b"".join(_f_bytes(12, o) for o in self._outputs)
        opset = _f_string(1, "") + _f_varint(2, self.OPSET)
        model = _f_varint(1, 8)                      # ir_version 8
        model += _f_string(2, producer)
        model += _f_string(3, "1.0")
        model += _f_bytes(7, graph)
        model += _f_bytes(8, opset)
        return model


# ---------------------------------------------------------------------------
# encoder graph emission
# ---------------------------------------------------------------------------

_EXPORTABLE_ARCHS = ("bert", "distilbert", "roberta", "electra")


def _np32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


class _WeightEmitter:
    """Emits MatMul weights either as float32 initializers or as int8 +
    per-tensor scale behind DequantizeLinear (the quantized artifact)."""

    def __init__(self, g: GraphBuilder, quantize: bool):
        self.g = g
        self.quantize = quantize

    def matmul_weight(self, hint: str, w: np.ndarray) -> str:
        w = _np32(w)
        if not self.quantize:
            return self.g.init_tensor(hint, w)
        scale = float(np.max(np.abs(w)) / 127.0) or 1.0
        wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        wq_name = self.g.init_tensor(hint + "_int8", wq)
        s_name = self.g.init_tensor(hint + "_scale", np.float32(scale))
        z_name = self.g.init_tensor(hint + "_zp", np.int8(0))
        return self.g.node("DequantizeLinear", [wq_name, s_name, z_name])


def _linear(g: GraphBuilder, we: _WeightEmitter, x: str, w: np.ndarray,
            b: np.ndarray, hint: str) -> str:
    wn = we.matmul_weight(hint + "_w", w)
    bn = g.init_tensor(hint + "_b", _np32(b))
    return g.node("Add", [g.node("MatMul", [x, wn]), bn])


def _layernorm(g: GraphBuilder, x: str, scale: np.ndarray, bias: np.ndarray,
               eps: float, hint: str) -> str:
    s = g.init_tensor(hint + "_ln_s", _np32(scale))
    b = g.init_tensor(hint + "_ln_b", _np32(bias))
    return g.node("LayerNormalization", [x, s, b], axis=-1, epsilon=float(eps))


def _gelu_erf(g: GraphBuilder, x: str) -> str:
    """Exact GELU (erf form), as the encoder forward computes it."""
    sqrt2 = g.init_tensor("sqrt2", np.float32(np.sqrt(2.0)))
    one = g.init_tensor("one", np.float32(1.0))
    half = g.init_tensor("half", np.float32(0.5))
    erf = g.node("Erf", [g.node("Div", [x, sqrt2])])
    return g.node("Mul", [g.node("Mul", [x, g.node("Add", [erf, one])]), half])


def build_encoder_graph(params: Dict[str, Any], cfg,
                        quantize: bool = False) -> bytes:
    """Emit the encoder forward as an ONNX ModelProto (bytes).

    ``params`` is the stacked-layer float32 tree (``Encoder.float_tree``,
    ``models.encoder.init_params``) and ``cfg`` its ``EncoderConfig``; the
    graph computes ``encoder_forward`` in float32 with plain attention,
    then the ``embed_texts_device`` pool and normalization.
    """
    if cfg.arch not in _EXPORTABLE_ARCHS:
        raise ValueError(
            f"ONNX export supports the classic-BERT families "
            f"{_EXPORTABLE_ARCHS}; arch '{cfg.arch}' has position handling "
            f"(rotary/relative) this exporter does not emit")
    host = lambda t: np.asarray(t)
    emb = {k: host(v) for k, v in params["embeddings"].items()}
    layers = {k: host(v) for k, v in params["layers"].items()}
    D, H, L = cfg.hidden_size, cfg.num_heads, cfg.num_layers
    Dh = cfg.head_dim

    g = GraphBuilder("adaptive_classifier_tpu_encoder")
    we = _WeightEmitter(g, quantize)
    ids = g.graph_input("input_ids", _DT_INT64, ["batch", "sequence"])
    mask = g.graph_input("attention_mask", _DT_INT64, ["batch", "sequence"])

    # --- embeddings ---------------------------------------------------
    word = g.init_tensor("word_emb", _np32(emb["word"]))
    h = g.node("Gather", [word, ids], axis=0)                  # [B,S,E]
    pos_table = g.init_tensor("pos_emb", _np32(emb["position"]))
    if cfg.arch == "roberta":
        # pad positions get padding_idx; real tokens cumsum(mask)+pad
        pad = g.init_tensor("pad_id", np.int64(cfg.pad_token_id))
        axis1 = g.init_tensor("axis1", np.int64(1))
        csum = g.node("CumSum", [mask, axis1])
        pos_ids = g.node("Add", [g.node("Mul", [csum, mask]), pad])
        h = g.node("Add", [h, g.node("Gather", [pos_table, pos_ids], axis=0)])
    else:
        shape = g.node("Shape", [ids])                          # [2]
        one_i = g.init_tensor("idx1", np.asarray([1], np.int64))
        seq_len = g.node("Gather", [shape, one_i], axis=0)      # [1]
        zero_i = g.init_tensor("start0", np.asarray([0], np.int64))
        axes0 = g.init_tensor("axes0", np.asarray([0], np.int64))
        pos_slice = g.node("Slice", [pos_table, zero_i, seq_len, axes0])
        h = g.node("Add", [h, pos_slice])                       # bcast [S,E]
    if cfg.type_vocab_size > 0:
        tt = g.init_tensor("token_type0", _np32(emb["token_type"][0]))
        h = g.node("Add", [h, tt])
    h = _layernorm(g, h, emb["ln_scale"], emb["ln_bias"],
                   cfg.layer_norm_eps, "emb")
    if "proj_w" in emb:        # ELECTRA embeddings_project
        h = _linear(g, we, h, emb["proj_w"], emb["proj_b"], "emb_proj")

    # --- additive attention mask [B,1,1,S] ----------------------------
    mf = g.node("Cast", [mask], to=_DT_FLOAT)
    ax12 = g.init_tensor("axes12", np.asarray([1, 2], np.int64))
    mf = g.node("Unsqueeze", [mf, ax12])
    one_f = g.init_tensor("one_f", np.float32(1.0))
    big = g.init_tensor("mask_big", np.float32(1e9))
    # (mask-1)*1e9 → 0 at real tokens, -1e9 at pad keys
    amask = g.node("Mul", [g.node("Sub", [mf, one_f]), big])

    split_heads = g.init_tensor("split_heads", np.asarray([0, 0, H, Dh], np.int64))
    merge_heads = g.init_tensor("merge_heads", np.asarray([0, 0, D], np.int64))
    inv_scale = g.init_tensor("attn_scale", np.float32(1.0 / np.sqrt(Dh)))

    # --- transformer layers -------------------------------------------
    for i in range(L):
        lp = {k: v[i] for k, v in layers.items()}

        def heads(x: str) -> str:
            r = g.node("Reshape", [x, split_heads])
            return g.node("Transpose", [r], perm=[0, 2, 1, 3])  # [B,H,S,Dh]

        q = heads(_linear(g, we, h, lp["q_w"], lp["q_b"], f"l{i}_q"))
        k = heads(_linear(g, we, h, lp["k_w"], lp["k_b"], f"l{i}_k"))
        v = heads(_linear(g, we, h, lp["v_w"], lp["v_b"], f"l{i}_v"))
        kt = g.node("Transpose", [k], perm=[0, 1, 3, 2])        # [B,H,Dh,S]
        scores = g.node("Mul", [g.node("MatMul", [q, kt]), inv_scale])
        probs = g.node("Softmax", [g.node("Add", [scores, amask])], axis=-1)
        ctx = g.node("MatMul", [probs, v])                      # [B,H,S,Dh]
        ctx = g.node("Transpose", [ctx], perm=[0, 2, 1, 3])
        ctx = g.node("Reshape", [ctx, merge_heads])             # [B,S,D]
        attn = _linear(g, we, ctx, lp["o_w"], lp["o_b"], f"l{i}_o")
        h = _layernorm(g, g.node("Add", [attn, h]),
                       lp["attn_ln_scale"], lp["attn_ln_bias"],
                       cfg.layer_norm_eps, f"l{i}_attn")
        ff = _gelu_erf(g, _linear(g, we, h, lp["ffn_in_w"], lp["ffn_in_b"],
                                  f"l{i}_ffn_in"))
        ff = _linear(g, we, ff, lp["ffn_out_w"], lp["ffn_out_b"],
                     f"l{i}_ffn_out")
        h = _layernorm(g, g.node("Add", [ff, h]),
                       lp["ffn_ln_scale"], lp["ffn_ln_bias"],
                       cfg.layer_norm_eps, f"l{i}_ffn")

    g.graph_output(h, "last_hidden_state", _DT_FLOAT,
                   ["batch", "sequence", D])

    # --- pool + L2 normalize (embed_texts_device epilogue) -------------
    if cfg.pooling == "mean":
        m3 = g.node("Unsqueeze", [g.node("Cast", [mask], to=_DT_FLOAT),
                                  g.init_tensor("axes2", np.asarray([2], np.int64))])
        # ReduceSum takes axes as an INPUT since opset 13
        ax1 = g.init_tensor("sum_axes1", np.asarray([1], np.int64))
        summed = g.node("ReduceSum", [g.node("Mul", [h, m3]), ax1], keepdims=0)
        counts = g.node("ReduceSum", [m3, ax1], keepdims=0)        # [B,1]
        counts = g.node("Max", [counts, g.init_tensor("min1", np.float32(1.0))])
        pooled = g.node("Div", [summed, counts])
    else:
        cls0 = g.init_tensor("cls_idx", np.int64(0))
        pooled = g.node("Gather", [h, cls0], axis=1)               # [B,D]
    norm = g.node("ReduceL2", [pooled], axes=[-1], keepdims=1)
    norm = g.node("Max", [norm, g.init_tensor("norm_eps", np.float32(1e-12))])
    sent = g.node("Div", [pooled, norm])
    g.graph_output(sent, "sentence_embedding", _DT_FLOAT, ["batch", D])

    return g.serialize()


def export_encoder_onnx(encoder, save_directory: Union[str, Path],
                        quantize: bool = False) -> Path:
    """Write ``model.onnx`` (and ``model_quantized.onnx`` when asked) for an
    ``Encoder``, from its float32 weights (``Encoder.float_tree``).

    An encoder that runs the int8 forward holds only its runtime int8
    state on the device and raises, as the JAX package's does: export it
    from an encoder loaded with ``quantization=None``."""
    if getattr(encoder, "quantization", None) == "int8":
        raise ValueError(
            "encoder holds only runtime-int8 weights; re-load with "
            "quantization=None to export float ONNX")
    save_directory = Path(save_directory)
    save_directory.mkdir(parents=True, exist_ok=True)
    tree = encoder.float_tree()
    (save_directory / "model.onnx").write_bytes(
        build_encoder_graph(tree, encoder.config, quantize=False))
    if quantize:
        (save_directory / "model_quantized.onnx").write_bytes(
            build_encoder_graph(tree, encoder.config, quantize=True))
    return save_directory


# ---------------------------------------------------------------------------
# protobuf reader + numpy interpreter (offline verification / fallback)
# ---------------------------------------------------------------------------

def _parse_proto(data: memoryview) -> Dict[int, list]:
    """Generic protobuf parse → {field: [raw values]} (varint ints,
    memoryview slices of ``data`` for length-delimited fields, float for
    32-bit)."""
    fields: Dict[int, list] = {}
    i, n = 0, len(data)
    while i < n:
        key = 0
        shift = 0
        while True:
            b = data[i]; i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            val = 0
            shift = 0
            while True:
                b = data[i]; i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            if val >= 1 << 63:
                val -= 1 << 64
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]; i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = data[i:i + ln]; i += ln
        elif wire == 5:
            val = struct.unpack("<f", data[i:i + 4])[0]; i += 4
        elif wire == 1:
            val = struct.unpack("<d", data[i:i + 8])[0]; i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def _parse_packed_int64(raw) -> List[int]:
    if isinstance(raw, int):
        return [raw]
    out = []
    i = 0
    while i < len(raw):
        val = 0
        shift = 0
        while True:
            b = raw[i]; i += 1
            val |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        if val >= 1 << 63:
            val -= 1 << 64
        out.append(val)
    return out


def _text(raw: memoryview) -> str:
    return bytes(raw).decode("utf-8")


def _parse_tensor(data: memoryview) -> (str, np.ndarray):
    f = _parse_proto(data)
    dims = [d for d in f.get(1, [])]
    dt = f[2][0]
    name = _text(f[8][0])
    arr = np.frombuffer(f[9][0], dtype=_DT_TO_NP[dt]).reshape(dims)
    return name, arr


def _parse_attr(data: memoryview) -> (str, Any):
    f = _parse_proto(data)
    name = _text(f[1][0])
    atype = f.get(20, [0])[0]
    if atype == _AT_FLOAT:
        return name, f[2][0]
    if atype == _AT_INT:
        return name, f[3][0]
    if atype == _AT_STRING:
        return name, _text(f[4][0])
    if atype == _AT_INTS:
        out = []
        for raw in f.get(8, []):
            out.extend(_parse_packed_int64(raw))
        return name, out
    raise ValueError(f"unsupported attribute type {atype}")


class OnnxLiteModel:
    """Parse and run the op subset this module emits, in numpy.

    Not a general ONNX runtime: it runs the serialized artifact
    independently of the builder that wrote it (and serves as a consumer
    of these exports with no dependency).  Initializers are read-only
    views of the file's bytes."""

    def __init__(self, path: Union[str, Path]):
        model = _parse_proto(memoryview(Path(path).read_bytes()))
        graph = _parse_proto(model[7][0])
        self.opset = _parse_proto(model[8][0]).get(2, [0])[0]
        self.initializers: Dict[str, np.ndarray] = {}
        for raw in graph.get(5, []):
            name, arr = _parse_tensor(raw)
            self.initializers[name] = arr
        self.nodes = []
        for raw in graph.get(1, []):
            f = _parse_proto(raw)
            self.nodes.append({
                "op": _text(f[4][0]),
                "inputs": [_text(x) for x in f.get(1, [])],
                "outputs": [_text(x) for x in f.get(2, [])],
                "attrs": dict(_parse_attr(a) for a in f.get(5, [])),
            })
        self.input_names = [
            _text(_parse_proto(raw)[1][0]) for raw in graph.get(11, [])]
        self.output_names = [
            _text(_parse_proto(raw)[1][0]) for raw in graph.get(12, [])]

    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        env: Dict[str, np.ndarray] = dict(self.initializers)
        env.update({k: np.asarray(v) for k, v in feeds.items()})
        for node in self.nodes:
            op, attrs = node["op"], node["attrs"]
            x = [env[i] for i in node["inputs"]]
            if op == "Identity":
                out = x[0]
            elif op == "MatMul":
                out = x[0].astype(np.float32) @ x[1].astype(np.float32)
            elif op == "Add":
                out = x[0] + x[1]
            elif op == "Sub":
                out = x[0] - x[1]
            elif op == "Mul":
                out = x[0] * x[1]
            elif op == "Div":
                out = x[0] / x[1]
            elif op == "Max":
                out = np.maximum(x[0], x[1])
            elif op == "Erf":
                try:
                    from scipy.special import erf as _erf
                except ImportError:            # exact, slower fallback
                    import math
                    _erf = np.vectorize(math.erf)
                out = _erf(x[0]).astype(np.float32)
            elif op == "Gather":
                out = np.take(x[0], x[1].astype(np.int64),
                              axis=attrs.get("axis", 0))
            elif op == "Shape":
                out = np.asarray(x[0].shape, np.int64)
            elif op == "Slice":
                data, starts, ends = x[0], x[1], x[2]
                axes = x[3] if len(x) > 3 else np.arange(len(starts))
                sl = [slice(None)] * data.ndim
                for s, e, a in zip(starts, ends, axes):
                    sl[int(a)] = slice(int(s), int(e))
                out = data[tuple(sl)]
            elif op == "Unsqueeze":
                out = x[0]
                for a in sorted(int(v) for v in x[1]):
                    out = np.expand_dims(out, a)
            elif op == "Cast":
                out = x[0].astype(_DT_TO_NP[attrs["to"]])
            elif op == "CumSum":
                out = np.cumsum(x[0], axis=int(x[1]))
            elif op == "Reshape":
                shape = [int(v) for v in x[1]]
                shape = [x[0].shape[i] if v == 0 else v
                         for i, v in enumerate(shape)]
                out = x[0].reshape(shape)
            elif op == "Transpose":
                out = np.transpose(x[0], attrs["perm"])
            elif op == "Softmax":
                ax = attrs.get("axis", -1)
                e = np.exp(x[0] - np.max(x[0], axis=ax, keepdims=True))
                out = e / np.sum(e, axis=ax, keepdims=True)
            elif op == "LayerNormalization":
                ax = attrs.get("axis", -1)
                eps = attrs.get("epsilon", 1e-5)
                mean = np.mean(x[0], axis=ax, keepdims=True)
                var = np.mean((x[0] - mean) ** 2, axis=ax, keepdims=True)
                out = (x[0] - mean) / np.sqrt(var + eps) * x[1] + x[2]
            elif op == "ReduceSum":
                axes = tuple(int(v) for v in x[1]) if len(x) > 1 \
                    else tuple(attrs["axes"])
                out = np.sum(x[0], axis=axes,
                             keepdims=bool(attrs.get("keepdims", 1)))
            elif op == "ReduceL2":
                out = np.sqrt(np.sum(x[0] ** 2, axis=tuple(attrs["axes"]),
                                     keepdims=bool(attrs.get("keepdims", 1))))
            elif op == "DequantizeLinear":
                out = (x[0].astype(np.float32) - x[2].astype(np.float32)) * x[1]
            else:
                raise NotImplementedError(f"op {op}")
            outs = node["outputs"]
            if len(outs) == 1:
                env[outs[0]] = np.asarray(out)
            else:
                for o, v in zip(outs, out):
                    env[o] = np.asarray(v)
        return {name: env[name] for name in self.output_names}
