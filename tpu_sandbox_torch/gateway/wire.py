"""Gateway wire protocol: the native kvstore's framing idioms, one tier up.
The port's copy of ``tpu_sandbox/gateway/wire.py``: the same ops, header,
cap and JSON bodies, so either package's client talks to either gateway.

Same shape as ``native/src/kvstore.cpp``'s protocol, deliberately — one
framing discipline across the whole system:

    request : op u8 | len u32 (network order) | payload
    response: status u8 | len u32 (network order) | payload

Payloads are JSON (the gateway speaks requests, not raw key bytes, so a
self-describing body beats the kvstore's key/val split). Ops:

    'H' hello   — payload = shared-secret token. When the gateway holds a
                  token this must be the FIRST frame on every connection;
                  wrong/missing token gets ST_AUTH and the socket closed.
                  On a token-less gateway 'H' is a no-op, so clients send
                  it unconditionally whenever they hold a token.
    'S' submit  — route + admit one request; responds with the admission
                  verdict (admitted + replica, or an explicit door shed).
    'W' wait    — block (server-side, bounded) for a terminal verdict.
    'T' try     — non-blocking verdict poll (ST_MISSING when none yet).
    'E' hedge   — duplicate a verdictless, leaseless request onto the
                  next-best replica (claim-once verdicts make races safe).
    'C' clear   — delete a SHED verdict + its claim marker so a retry's
                  fresh execution can publish (the client retry path).
    'L' stats   — gateway + per-fleet routing-table introspection.
    'M' metrics — live scrape of the obs metrics registry plus recorder
                  stats (gateway-local and per-replica via load reports).

Any protocol violation — oversized or truncated frame, undecodable JSON,
unknown op, auth failure — closes the connection; it never wedges the
accept loop or leaks a request (a request exists only after a fully
parsed, fully dispatched 'S').

TLS rides *under* this framing on the external wire: the gateway wraps
its listener in an ``ssl.SSLContext`` and the client wraps its socket
before the first frame, so the shared-secret hello (and everything after
it) is inside the encrypted channel. The framing code below is transport
agnostic — an ``ssl.SSLSocket`` and an ssl-wrapped asyncio stream expose
the same recv/readexactly surface — which is why the context builders
live here next to the protocol they protect. A plaintext client against
a TLS gateway fails the *handshake* (the server reads a frame header out
of the ClientHello bytes, or the client times out waiting for a
ServerHello that never parses); either way the connection dies before a
single op is interpreted.

Both ends set TCP_NODELAY: frames are small and latency is the product.
"""

from __future__ import annotations

import json
import socket
import ssl
import struct

#: one-frame cap, matching the kvstore's sanity cap in spirit; prompts are
#: token-id lists, so even huge requests are far below this
MAX_FRAME = 1 << 20

_HDR = struct.Struct("!BI")  # op/status u8 | length u32, network order

OP_HELLO = ord("H")
OP_SUBMIT = ord("S")
OP_WAIT = ord("W")
OP_TRY = ord("T")
OP_HEDGE = ord("E")
OP_CLEAR = ord("C")
OP_STATS = ord("L")
OP_METRICS = ord("M")

KNOWN_OPS = frozenset({OP_HELLO, OP_SUBMIT, OP_WAIT, OP_TRY, OP_HEDGE,
                       OP_CLEAR, OP_STATS, OP_METRICS})

ST_OK = 0
ST_ERR = 1
ST_MISSING = 2   # try/wait: no verdict yet
ST_TIMEOUT = 3   # wait: bounded server-side wait expired
ST_AUTH = 4      # hello rejected / required and absent


class ProtocolError(Exception):
    """The peer violated the framing contract; close the connection."""


# -- TLS contexts -------------------------------------------------------------


def make_server_ssl_context(certfile: str, keyfile: str) -> ssl.SSLContext:
    """The gateway's listener context: TLS 1.2+, server cert + key from
    committed PEM files (tests/fixtures/tls/ in the suite; an operator
    hands real paths in production). Client certs are not requested —
    the shared-secret hello inside the channel is the caller identity."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(certfile=certfile, keyfile=keyfile)
    return ctx


def make_client_ssl_context(cafile: str) -> ssl.SSLContext:
    """The client's context: verify the gateway against exactly the CA
    given (never the system trust store — a sandbox fleet's CA is
    private), hostname checking on."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_verify_locations(cafile=cafile)
    ctx.check_hostname = True
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def pack_frame(op: int, payload: bytes) -> bytes:
    if len(payload) > MAX_FRAME:
        raise ProtocolError(f"frame of {len(payload)} bytes exceeds cap")
    return _HDR.pack(op, len(payload)) + payload


def parse_header(header: bytes) -> tuple[int, int]:
    """(op_or_status, payload_length); oversized lengths are a protocol
    violation BEFORE any allocation — a hostile 4 GB length prefix must
    cost nothing."""
    if len(header) != _HDR.size:
        raise ProtocolError(f"short header: {len(header)} bytes")
    op, length = _HDR.unpack(header)
    if length > MAX_FRAME:
        raise ProtocolError(f"declared frame of {length} bytes exceeds cap")
    return op, length


def encode_body(body: dict) -> bytes:
    return json.dumps(body).encode()


def decode_body(payload: bytes) -> dict:
    try:
        body = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable payload: {e}") from e
    if not isinstance(body, dict):
        raise ProtocolError("payload must be a JSON object")
    return body


# -- sync side (GatewayClient) ------------------------------------------------


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("gateway closed the connection")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, op: int, body: dict) -> None:
    sock.sendall(pack_frame(op, encode_body(body)))


def recv_response(sock: socket.socket) -> tuple[int, dict]:
    status, length = parse_header(recv_exact(sock, _HDR.size))
    payload = recv_exact(sock, length) if length else b""
    return status, (decode_body(payload) if payload else {})


# -- async side (Gateway server) ----------------------------------------------


async def read_frame(reader) -> tuple[int, bytes]:
    """One request frame off an asyncio stream; raises ProtocolError on a
    hostile length prefix and IncompleteReadError on mid-frame EOF."""
    op, length = parse_header(await reader.readexactly(_HDR.size))
    payload = await reader.readexactly(length) if length else b""
    return op, payload


async def write_response(writer, status: int, body: dict | None) -> None:
    writer.write(pack_frame(status, encode_body(body) if body else b""))
    await writer.drain()
