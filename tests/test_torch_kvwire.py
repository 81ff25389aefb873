"""The port's KV wire format (deeplearning4j_tpu_torch/serving/kvwire.py)
on the CPU.

The wire-level contracts of tests/test_serving_kvwire.py, held on the
port's copy: bit-exact round trips of float and int8 handoffs (rows,
scales, a chain's token ids), the 16-byte header, typed failures (crc,
truncated, magic, version, type), control frames, the base64 text
transport, the socket transport and `WireServer`. Beside them:

- the port's frames are byte-identical to JAX's for the same float32,
  bfloat16, int8 and float8_e4m3fn handoff, and each framework decodes
  the other's frames to the same bytes (the port carries bfloat16 and
  e4m3 as raw words, with no numpy extension type);
- `requantize_handoff` equals the port's quantize-on-write
  (`quant.kv.quantize_rows`), zero rows get scale 1.0, same-mode
  handoffs pass through and a quantized source cannot change mode;
- a handoff's bytes are `quant.kv.handoff_bytes` of its rows.
"""
import dataclasses
import socket
import struct
import zlib

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401

from deeplearning4j_tpu.serving import engine as jeng  # noqa: E402
from deeplearning4j_tpu.serving import kvwire as jwire  # noqa: E402

from deeplearning4j_tpu_torch.models import transformer as ttf  # noqa
from deeplearning4j_tpu_torch.quant.kv import (handoff_bytes,  # noqa: E402
                                               quantize_rows)
from deeplearning4j_tpu_torch.serving import kvwire  # noqa: E402
from deeplearning4j_tpu_torch.serving.engine import KVHandoff  # noqa
from deeplearning4j_tpu_torch.serving.kvwire import (  # noqa: E402
    WireError, WireServer, decode_control, decode_handoff, encode_control,
    encode_handoff, frame_from_text, frame_to_text, recv_frame,
    requantize_handoff, send_frame, wire_call)

L, D = 2, 32
CFG = ttf.TransformerConfig(vocab_size=32, d_model=D, n_heads=4,
                            n_layers=L, max_len=64)


def _mk_kv(kv_mode=None, pos=12, seed=0, source="slot", with_tokens=False,
           dtype=torch.float32):
    """A synthetic committed-KV handoff, float or quantized."""
    g = torch.Generator().manual_seed(seed)
    shape = (L, pos, D)
    k = torch.randn(shape, generator=g).to(dtype)
    v = torch.randn(shape, generator=g).to(dtype)
    ks = vs = None
    if kv_mode is not None:
        ks = torch.rand((L, pos, 1), generator=g) * 0.09 + 0.01
        vs = torch.rand((L, pos, 1), generator=g) * 0.09 + 0.01
        if kv_mode == "int8":
            k = torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8)
            v = torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8)
        else:
            k = (k * 8).to(torch.float8_e4m3fn)
            v = (v * 8).to(torch.float8_e4m3fn)
    tokens = np.arange(pos, dtype=np.int32) if with_tokens else None
    return KVHandoff(pos=pos, tok=7, k=k, v=v, k_scale=ks, v_scale=vs,
                     kv_mode=kv_mode, n_layers=L, d_model=D, source=source,
                     tokens=tokens, weights_step=3)


def _np(t):
    """A port tensor as the array JAX's handoff holds (ml_dtypes for the
    types numpy lacks)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


def _jax_kv(kv):
    return jeng.KVHandoff(
        pos=kv.pos, tok=kv.tok, k=_np(kv.k), v=_np(kv.v),
        k_scale=_np(kv.k_scale), v_scale=_np(kv.v_scale),
        kv_mode=kv.kv_mode, n_layers=kv.n_layers, d_model=kv.d_model,
        source=kv.source, tokens=kv.tokens, weights_step=kv.weights_step)


def _same_bytes(a, b):
    """A port tensor and an array (either framework's) hold the same
    bytes, shape and dtype name."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, torch.Tensor):
        a = _np(a)
    if isinstance(b, torch.Tensor):
        b = _np(b)
    return (a.shape == b.shape and str(a.dtype) == str(b.dtype)
            and a.tobytes() == b.tobytes())


# -- codec: bit-exact round trips ---------------------------------------------

def test_float_roundtrip_bit_exact():
    kv = _mk_kv()
    out = decode_handoff(encode_handoff(kv))
    assert torch.equal(out.k, kv.k) and torch.equal(out.v, kv.v)
    assert out.k.dtype == torch.float32
    assert (out.pos, out.tok, out.kv_mode) == (kv.pos, kv.tok, None)
    assert out.k_scale is None and out.v_scale is None
    assert (out.n_layers, out.d_model) == (L, D)
    assert out.source == "slot" and out.tokens is None
    assert out.weights_step == 3


def test_int8_cache_roundtrip_bit_exact():
    kv = _mk_kv("int8", source="cache", with_tokens=True)
    out = decode_handoff(encode_handoff(kv))
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(out, name), getattr(kv, name)), name
    np.testing.assert_array_equal(out.tokens, kv.tokens)
    assert out.tokens.dtype == np.int32
    assert out.k.dtype == torch.int8 and out.k_scale.dtype == torch.float32
    assert out.kv_mode == "int8" and out.source == "cache"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn],
                         ids=["bf16", "e4m3"])
def test_half_and_byte_words_roundtrip_bit_exact(dtype):
    kv = (_mk_kv(dtype=dtype) if dtype == torch.bfloat16
          else _mk_kv("fp8"))
    out = decode_handoff(encode_handoff(kv))
    assert out.k.dtype == kv.k.dtype
    assert torch.equal(out.k.view(torch.uint8), kv.k.view(torch.uint8))
    assert torch.equal(out.v.view(torch.uint8), kv.v.view(torch.uint8))


def test_frame_header_layout():
    frame = encode_handoff(_mk_kv())
    assert len(frame) >= kvwire.HEADER_SIZE == 16
    magic, ver, ftype, rsvd, plen, crc = struct.unpack_from("<4sHBBII",
                                                            frame)
    assert magic == b"KVWR" and ver == kvwire.WIRE_VERSION
    assert ftype == kvwire.FRAME_HANDOFF and rsvd == 0
    assert plen == len(frame) - kvwire.HEADER_SIZE
    assert crc == zlib.crc32(frame[kvwire.HEADER_SIZE:]) & 0xFFFFFFFF


# -- the same frames as JAX's -------------------------------------------------

@pytest.mark.parametrize("case", ["f32", "bf16", "int8", "e4m3",
                                  "int8-cache"])
def test_frames_byte_identical_to_jax(case):
    kv = {"f32": lambda: _mk_kv(seed=1),
          "bf16": lambda: _mk_kv(seed=2, dtype=torch.bfloat16),
          "int8": lambda: _mk_kv("int8", seed=3),
          "e4m3": lambda: _mk_kv("fp8", seed=4),
          "int8-cache": lambda: _mk_kv("int8", seed=5, source="cache",
                                       with_tokens=True)}[case]()
    jkv = _jax_kv(kv)
    frame = encode_handoff(kv)
    assert frame == jwire.encode_handoff(jkv)
    # JAX decodes the port's frame, the port decodes JAX's, to the bytes
    back_j = jwire.decode_handoff(frame)
    back_t = decode_handoff(jwire.encode_handoff(jkv))
    for name in ("k", "v", "k_scale", "v_scale", "tokens"):
        assert _same_bytes(getattr(back_j, name), getattr(kv, name)), name
        assert _same_bytes(getattr(back_t, name), getattr(kv, name)), name
    for f in ("pos", "tok", "kv_mode", "n_layers", "d_model", "source",
              "weights_step"):
        assert getattr(back_j, f) == getattr(back_t, f) == getattr(kv, f)


# -- codec: every failure is typed --------------------------------------------

@pytest.mark.parametrize("flip", [16, -1, 200],
                         ids=["first-payload", "last-payload", "mid"])
def test_crc_corruption_detected(flip):
    frame = bytearray(encode_handoff(_mk_kv("int8")))
    frame[flip] ^= 0xFF
    with pytest.raises(WireError) as ei:
        decode_handoff(bytes(frame))
    assert ei.value.kind == "crc"


def test_truncation_detected():
    frame = encode_handoff(_mk_kv())
    for cut in (0, 4, kvwire.HEADER_SIZE - 1, kvwire.HEADER_SIZE + 8,
                len(frame) - 1):
        with pytest.raises(WireError) as ei:
            decode_handoff(frame[:cut])
        assert ei.value.kind == "truncated", f"cut={cut}"


def test_bad_magic_detected():
    frame = bytearray(encode_handoff(_mk_kv()))
    frame[:4] = b"NOPE"
    with pytest.raises(WireError) as ei:
        decode_handoff(bytes(frame))
    assert ei.value.kind == "magic"


def test_version_skew_refused():
    frame = bytearray(encode_handoff(_mk_kv()))
    struct.pack_into("<H", frame, 4, kvwire.WIRE_VERSION + 1)
    with pytest.raises(WireError) as ei:
        decode_handoff(bytes(frame))
    assert ei.value.kind == "version"


def test_frame_type_mismatch_detected():
    with pytest.raises(WireError) as ei:
        decode_handoff(encode_control({"spec_off": True}))
    assert ei.value.kind == "type"
    with pytest.raises(WireError) as ei:
        decode_control(encode_handoff(_mk_kv()))
    assert ei.value.kind == "type"


def test_malformed_payload_is_typed():
    """A frame whose CRC holds but whose manifest lies: an unknown dtype,
    an array past the payload, trailing bytes, no K/V rows."""
    good = kvwire.decode_frame(encode_handoff(_mk_kv(pos=2)))[2]
    (hlen,) = struct.unpack_from("<I", good)
    head = bytes(good[4:4 + hlen])
    body = bytes(good[4 + hlen:])

    def frame(h, b):
        return kvwire.encode_frame(kvwire.FRAME_HANDOFF,
                                   struct.pack("<I", len(h)) + h + b)

    cases = {"error": [frame(head.replace(b'"float32"', b'"float99"', 1),
                             body),
                       frame(head.replace(b'"k"', b'"q"').replace(
                           b'"v"', b'"w"'), body)],
             "truncated": [frame(head, body[:-4]), frame(head, body + b"x")]}
    for kind, frames in cases.items():
        for f in frames:
            with pytest.raises(WireError) as ei:
                decode_handoff(f)
            assert ei.value.kind == kind


def test_control_roundtrip():
    p = {"spec_off": True, "chunk_shrink": False, "decode_chunk": 3}
    assert decode_control(encode_control(p)) == p
    assert encode_control(p) == jwire.encode_control(p)


def test_text_transport_roundtrip():
    frame = encode_handoff(_mk_kv("int8"))
    text = frame_to_text(frame)
    assert isinstance(text, str) and "\n" not in text
    assert frame_from_text(text) == frame
    with pytest.raises(WireError) as ei:
        frame_from_text("!!not base64!!")
    assert ei.value.kind == "truncated"


# -- quantize-on-adopt --------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_requantize_matches_the_ports_quantize_on_write(dtype):
    kv = _mk_kv(seed=5, dtype=dtype)
    q = requantize_handoff(kv, "int8")
    assert q.kv_mode == "int8" and q.k.dtype == torch.int8
    assert q.k_scale.shape == (L, kv.pos, 1)
    assert q.k_scale.dtype == torch.float32
    for src, vals, sc in ((kv.k, q.k, q.k_scale), (kv.v, q.v, q.v_scale)):
        want, wscale = quantize_rows(src, "int8")
        assert torch.equal(vals, want)
        assert torch.equal(sc[..., 0], wscale)
    assert kv.kv_mode is None and kv.k.dtype == dtype   # untouched
    # the engine's own write of these rows: _store's quantize_rows
    from deeplearning4j_tpu_torch.parallel.serving import _store
    ck = torch.zeros((L, 1, kv.pos, D), dtype=torch.int8)
    cv = torch.zeros_like(ck)
    ksc = torch.ones((L, 1, kv.pos, 1))
    vsc = torch.ones_like(ksc)
    rows = torch.arange(kv.pos)
    for layer in range(L):
        _store((ck, cv, ksc, vsc), layer,
               (torch.zeros(kv.pos, dtype=torch.long), rows),
               kv.k[layer], kv.v[layer])
    assert torch.equal(ck[:, 0], q.k) and torch.equal(ksc[:, 0], q.k_scale)
    assert torch.equal(cv[:, 0], q.v) and torch.equal(vsc[:, 0], q.v_scale)


def test_requantize_zero_rows_and_passthrough():
    kv = _mk_kv()
    z = kv.k.clone()
    z[0, 0, :] = 0.0
    q = requantize_handoff(dataclasses.replace(kv, k=z), "int8")
    assert q.k_scale[0, 0, 0] == 1.0 and not torch.any(q.k[0, 0])
    assert requantize_handoff(kv, None) is kv
    q8 = _mk_kv("int8")
    assert requantize_handoff(q8, "int8") is q8
    alien = dataclasses.replace(q8, kv_mode="fp8")
    with pytest.raises(WireError) as ei:
        requantize_handoff(alien, "int8")
    assert ei.value.kind == "error"


@pytest.mark.parametrize("mode,dtype", [(None, torch.float32),
                                        (None, torch.bfloat16),
                                        ("int8", torch.int8)],
                         ids=["f32", "bf16", "int8"])
def test_handoff_nbytes_is_the_analytic_bytes(mode, dtype):
    kv = _mk_kv(mode, dtype=dtype) if mode is None else _mk_kv(mode)
    cfg = dataclasses.replace(CFG, dtype="bfloat16") \
        if dtype == torch.bfloat16 else CFG
    assert kv.nbytes == handoff_bytes(cfg, kv.pos, kv_mode=mode)
    frame = encode_handoff(kv)
    assert kv.nbytes < len(frame) < kv.nbytes + 1024


# -- socket transport ---------------------------------------------------------

def test_socket_send_recv_roundtrip():
    frame = encode_handoff(_mk_kv("int8", with_tokens=True))
    a, b = socket.socketpair()
    try:
        send_frame(a, frame)
        assert recv_frame(b) == frame
    finally:
        a.close()
        b.close()


def test_wire_server_roundtrip():
    def handler(frame):
        kv = decode_handoff(frame)
        return encode_control({"pos": int(kv.pos), "tok": int(kv.tok)})
    srv = WireServer(handler)
    try:
        resp = wire_call(srv.address, encode_handoff(_mk_kv()))
        assert decode_control(resp) == {"pos": 12, "tok": 7}
    finally:
        srv.stop()


def test_wire_server_handler_failure_is_typed_at_dialer():
    calls = []

    def handler(frame):
        calls.append(frame)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return encode_control({"ok": True})
    srv = WireServer(handler)
    try:
        with pytest.raises(WireError) as ei:
            wire_call(srv.address, encode_control({}))
        assert ei.value.kind == "truncated"
        resp = wire_call(srv.address, encode_control({}))
        assert decode_control(resp) == {"ok": True}
    finally:
        srv.stop()
