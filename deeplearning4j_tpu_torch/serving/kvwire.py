"""KV wire transport: one versioned frame format for every process
boundary a `serving.engine.KVHandoff` crosses.

Port of deeplearning4j_tpu/serving/kvwire.py with the same frames, byte
for byte: a frame the reference encodes decodes here and the other way
round, so an engine of either framework adopts the other's export.

Frame layout (all integers little-endian)::

    offset  size  field
    0       4     magic  b"KVWR"
    4       2     version (WIRE_VERSION)
    6       1     frame type (1 = HANDOFF, 2 = CONTROL)
    7       1     reserved (0)
    8       4     payload length
    12      4     CRC32 of the payload
    16      ...   payload

HANDOFF payload: a u32-length-prefixed JSON header (``pos``, ``tok``,
``kv_mode``, ``n_layers``, ``d_model``, ``source``, ``weights_step``,
and an ``arrays`` manifest of ``[name, dtype, shape]``) followed by the
arrays' raw C-order bytes in manifest order: K/V rows, per-row scales
(which travel with their rows) and a cache-source chain's token ids.
CONTROL payload: bare JSON.

The handoff's rows are torch host tensors, so no numpy extension type is
needed for the dtypes numpy lacks: bfloat16 and float8_e4m3fn travel as
their raw 2-byte and 1-byte words under the reference's dtype names, as
`util.checkpointing` stores them.

Failure contract: every decode problem raises a typed `WireError`
(``kind`` in magic | version | crc | truncated | type | error); a caller
degrades to re-prefill. A frame of a newer version is refused, never
guessed at.

Quantize-on-adopt: `requantize_handoff` turns a float handoff into a
quantized one with the port's own quantize-on-write
(`quant.kv.quantize_rows`), so a quantized engine adopts the rows its own
prefill would have written from those values.

Transports: `frame_to_text` / `frame_from_text` (base64 for a JSON-lines
pipe; the CRC still checks the decoded bytes), `send_frame` /
`recv_frame` over a plain socket, and `WireServer` / `wire_call`, one
frame in and one out per connection.
"""
from __future__ import annotations

import base64
import json
import socket
import socketserver
import struct
import threading
import zlib
from dataclasses import replace
from typing import Callable, Tuple

import numpy as np
import torch

MAGIC = b"KVWR"
WIRE_VERSION = 1

FRAME_HANDOFF = 1
FRAME_CONTROL = 2

#: magic, version, frame type, reserved, payload length, payload CRC32
_HEADER = struct.Struct("<4sHBBII")
HEADER_SIZE = _HEADER.size

#: refuse absurd payload lengths BEFORE allocating for them — a
#: corrupted length field must not turn into an allocation bomb
MAX_PAYLOAD = 1 << 31

# manifest dtype name -> (torch dtype, same-width integer word); the
# names are numpy's, and the reference's for the two numpy lacks
_DTYPES = {"float32": (torch.float32, torch.int32),
           "float16": (torch.float16, torch.int16),
           "bfloat16": (torch.bfloat16, torch.int16),
           "int64": (torch.int64, torch.int64),
           "int32": (torch.int32, torch.int32),
           "int8": (torch.int8, torch.int8),
           "uint8": (torch.uint8, torch.uint8)}
if hasattr(torch, "float8_e4m3fn"):
    _DTYPES["float8_e4m3fn"] = (torch.float8_e4m3fn, torch.uint8)
_NAMES = {t: n for n, (t, _) in _DTYPES.items()}


class WireError(RuntimeError):
    """Typed frame decode failure. ``kind`` names the check that
    failed: ``magic`` | ``version`` | ``crc`` | ``truncated`` |
    ``type`` | ``error``. Every caller degrades to re-prefill."""

    def __init__(self, kind: str, msg: str):
        super().__init__(msg)
        self.kind = kind


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def encode_frame(ftype: int, payload: bytes) -> bytes:
    """One length-framed, CRC32-checked frame around ``payload``."""
    payload = bytes(payload)
    if len(payload) > MAX_PAYLOAD:
        raise ValueError(f"payload too large ({len(payload)} bytes)")
    hdr = _HEADER.pack(MAGIC, WIRE_VERSION, int(ftype), 0,
                       len(payload), zlib.crc32(payload) & 0xFFFFFFFF)
    return hdr + payload


def decode_frame(frame: bytes) -> Tuple[int, int, memoryview]:
    """Validate one frame; returns ``(version, ftype, payload)``.
    Raises `WireError` — never returns partially-checked bytes."""
    buf = memoryview(bytes(frame))
    if len(buf) < HEADER_SIZE:
        raise WireError("truncated",
                        f"frame shorter than its header "
                        f"({len(buf)} < {HEADER_SIZE} bytes)")
    magic, version, ftype, _res, plen, crc = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise WireError("magic", f"bad frame magic {bytes(magic)!r}")
    if version > WIRE_VERSION:
        # forward skew is REFUSED, not guessed at: a decoder must
        # never interpret bytes whose layout it does not know
        raise WireError("version",
                        f"frame version {version} is newer than this "
                        f"decoder ({WIRE_VERSION})")
    if plen > MAX_PAYLOAD or len(buf) != HEADER_SIZE + plen:
        raise WireError("truncated",
                        f"frame length mismatch (declared {plen} "
                        f"payload bytes, got {len(buf) - HEADER_SIZE})")
    payload = buf[HEADER_SIZE:]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireError("crc", "frame payload failed its CRC32 check")
    return version, ftype, payload


# ---------------------------------------------------------------------------
# handoff frames
# ---------------------------------------------------------------------------

def _array_bytes(a) -> Tuple[str, list, bytes]:
    """(manifest dtype name, shape, raw C-order bytes) of a host tensor
    or a numpy array (a chain's token ids)."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
        return str(a.dtype), list(a.shape), a.tobytes()
    t = a.detach().to("cpu").contiguous()
    name = _NAMES.get(t.dtype)
    if name is None:
        raise ValueError(f"no wire dtype for {t.dtype}")
    return (name, list(t.shape),
            t.view(_DTYPES[name][1]).numpy().tobytes())


def _array_from(buf, name: str, shape) -> torch.Tensor:
    """A host tensor of manifest dtype ``name`` (a `_DTYPES` key) and
    ``shape`` over a copy of ``buf``."""
    dt, word = _DTYPES[name]
    t = torch.frombuffer(bytearray(buf), dtype=word) if len(buf) \
        else torch.empty((0,), dtype=word)
    return t.view(dt).reshape([int(s) for s in shape])


def encode_handoff(kv) -> bytes:
    """Encode one `KVHandoff` (slot or cache source, float or
    quantized) into a HANDOFF frame, byte-identical to the reference's
    for the same handoff. Arrays are raw C-order bytes: bit-preserving,
    so decode -> adopt is as token-exact as an in-process handoff."""
    arrays = []
    blobs = []
    for name in ("k", "v", "k_scale", "v_scale", "tokens"):
        a = getattr(kv, name, None)
        if a is None:
            continue
        dt, shape, blob = _array_bytes(a)
        arrays.append([name, dt, shape])
        blobs.append(blob)
    head = json.dumps({
        "pos": int(kv.pos), "tok": int(kv.tok),
        "kv_mode": kv.kv_mode,
        "n_layers": int(kv.n_layers), "d_model": int(kv.d_model),
        "source": getattr(kv, "source", "slot"),
        "weights_step": (int(kv.weights_step)
                         if kv.weights_step is not None else None),
        "arrays": arrays,
    }).encode()
    payload = b"".join([struct.pack("<I", len(head)), head, *blobs])
    return encode_frame(FRAME_HANDOFF, payload)


def decode_handoff(frame: bytes):
    """Decode a HANDOFF frame back into a `KVHandoff` (K/V rows and
    scales as host tensors, token ids as an int32 array). Raises
    `WireError` on any framing, CRC, version or shape problem: the
    caller degrades to re-prefill, never adopts suspect rows."""
    from deeplearning4j_tpu_torch.serving.engine import KVHandoff
    _, ftype, payload = decode_frame(frame)
    if ftype != FRAME_HANDOFF:
        raise WireError("type",
                        f"expected a HANDOFF frame, got type {ftype}")
    try:
        (hlen,) = struct.unpack_from("<I", payload)
        head = json.loads(bytes(payload[4:4 + hlen]).decode())
        off = 4 + hlen
        out = {}
        for name, dtype_name, shape in head["arrays"]:
            if dtype_name not in _DTYPES:
                raise WireError("error",
                                f"unknown array dtype {dtype_name!r}")
            item = torch.empty((), dtype=_DTYPES[dtype_name][0]) \
                .element_size()
            n = int(np.prod(shape, dtype=np.int64)) * item
            if off + n > len(payload):
                raise WireError("truncated",
                                f"array {name!r} overruns the payload")
            out[name] = _array_from(payload[off:off + n], dtype_name,
                                    shape)
            off += n
        if off != len(payload):
            raise WireError("truncated",
                            f"{len(payload) - off} trailing payload "
                            "bytes after the declared arrays")
        if "k" not in out or "v" not in out:
            raise WireError("error", "handoff frame is missing its "
                                     "K/V row arrays")
        tokens = out.get("tokens")
        return KVHandoff(
            pos=int(head["pos"]), tok=int(head["tok"]),
            k=out["k"], v=out["v"],
            k_scale=out.get("k_scale"), v_scale=out.get("v_scale"),
            kv_mode=head.get("kv_mode"),
            n_layers=int(head.get("n_layers", 0)),
            d_model=int(head.get("d_model", 0)),
            source=head.get("source", "slot"),
            tokens=(tokens.numpy().astype(np.int32)
                    if tokens is not None else None),
            weights_step=head.get("weights_step"))
    except WireError:
        raise
    except Exception as e:
        raise WireError("error",
                        f"malformed handoff payload: {e}") from e


# ---------------------------------------------------------------------------
# control frames (the qos actuation satellite)
# ---------------------------------------------------------------------------

def encode_control(payload: dict) -> bytes:
    """One CONTROL frame around a small JSON payload — the worker
    pipe's qos_control actuation reuses the kvwire header instead of
    inventing a second envelope."""
    return encode_frame(FRAME_CONTROL, json.dumps(payload).encode())


def decode_control(frame: bytes) -> dict:
    _, ftype, payload = decode_frame(frame)
    if ftype != FRAME_CONTROL:
        raise WireError("type",
                        f"expected a CONTROL frame, got type {ftype}")
    try:
        out = json.loads(bytes(payload).decode())
    except Exception as e:
        raise WireError("error",
                        f"malformed control payload: {e}") from e
    if not isinstance(out, dict):
        raise WireError("error", "control payload must be an object")
    return out


# ---------------------------------------------------------------------------
# quantize-on-adopt
# ---------------------------------------------------------------------------

def requantize_handoff(kv, kv_mode: str):
    """Quantize-on-adopt: a FLOAT handoff converted to a ``kv_mode``
    (resolved as the engine resolves it) one, each row quantized here by
    `quant.kv.quantize_rows`, the port's quantize-on-write, with its
    scale [L, pos, 1] beside it. A handoff already of that mode passes
    through; a quantized handoff of another mode cannot be converted
    (its precision is gone) and raises `WireError` so the caller
    degrades to re-prefill."""
    from deeplearning4j_tpu_torch.quant.core import resolve_mode
    from deeplearning4j_tpu_torch.quant.kv import quantize_rows
    mode = resolve_mode(kv_mode)
    if kv.kv_mode == mode:
        return kv
    if kv.kv_mode is not None:
        raise WireError("error",
                        f"cannot requantize a {kv.kv_mode!r} handoff "
                        f"to {mode!r}: only float sources carry full "
                        "precision")
    k, ksc = quantize_rows(kv.k, mode)
    v, vsc = quantize_rows(kv.v, mode)
    return replace(kv, k=k, v=v, k_scale=ksc[..., None],
                   v_scale=vsc[..., None], kv_mode=mode)


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def frame_to_text(frame: bytes) -> str:
    """Base64-wrap a frame for the JSON-lines worker pipe. The CRC
    still validates the DECODED bytes, so pipe corruption is caught by
    the same check as socket corruption."""
    return base64.b64encode(frame).decode("ascii")


def frame_from_text(text: str) -> bytes:
    try:
        return base64.b64decode(text.encode("ascii"), validate=True)
    except Exception as e:
        raise WireError("truncated",
                        f"undecodable base64 frame: {e}") from e


def send_frame(sock: socket.socket, frame: bytes) -> None:
    """Ship one frame over a plain socket (remote tier targets)."""
    sock.sendall(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        c = sock.recv(min(1 << 20, n - got))
        if not c:
            raise WireError("truncated",
                            f"socket closed after {got}/{n} bytes")
        chunks.append(c)
        got += len(c)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    """Read exactly one frame off a socket (header first, then the
    declared payload). Returns the raw frame bytes; validation —
    including the CRC — happens in `decode_frame`, so a tampered
    length field surfaces as a typed `WireError`, not a hang."""
    hdr = _recv_exact(sock, HEADER_SIZE)
    _magic, _ver, _ftype, _res, plen, _crc = _HEADER.unpack(hdr)
    if plen > MAX_PAYLOAD:
        raise WireError("truncated",
                        f"declared payload of {plen} bytes exceeds "
                        f"the {MAX_PAYLOAD}-byte bound")
    return hdr + _recv_exact(sock, plen)


class WireServer:
    """Minimal request/response frame server over a plain socket: one
    frame in, ``handler(frame) -> frame`` out, per connection — what a
    REMOTE tier target mounts next to its health endpoints. Binds an
    ephemeral port by default; `.address` is the dial target."""

    def __init__(self, handler: Callable[[bytes], bytes],
                 host: str = "127.0.0.1", port: int = 0):
        self._handler = handler
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                try:
                    frame = recv_frame(self.request)
                    send_frame(self.request, outer._handler(frame))
                except Exception:
                    # a broken peer/frame must never kill the server;
                    # the DIALER sees the short read and degrades
                    pass

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv((host, port), _Conn)
        self.address: Tuple[str, int] = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name="kvwire-server")
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self.address[1])

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def wire_call(address: Tuple[str, int], frame: bytes,
              timeout: float = 10.0) -> bytes:
    """Dial a `WireServer`, send one frame, read one frame back."""
    with socket.create_connection(address, timeout=timeout) as sock:
        send_frame(sock, frame)
        return recv_frame(sock)
