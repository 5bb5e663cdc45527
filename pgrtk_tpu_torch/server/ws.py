"""Minimal RFC 6455 WebSocket support for the stdlib HTTP server — the
port's copy of pgrtk_tpu/server/ws.py (stdlib only).

The reference serves ROI-preset autocomplete over a `/ws` websocket
(pgr-web/pgr-server/src/main.rs:209-255): the client sends a text
prefix, the server answers with a JSON object of the ROI entries whose
name starts with that prefix (empty message -> "{}").  This module
implements just enough of the protocol for that exchange — server-side
handshake, masked client text frames, unmasked server text frames,
ping/pong and close.
"""
from __future__ import annotations

import base64
import hashlib
import struct

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

# ROI prefixes are tiny; a client-claimed length beyond this is abusive
# (the 64-bit length field would otherwise make rfile.read try to buffer
# whatever the client claims)
MAX_FRAME = 1 << 20


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def read_frame(rfile):
    """Read one frame; returns (fin, opcode, payload) or None on
    EOF/close/oversize.
    Client->server frames are always masked (RFC 6455 §5.1)."""
    hdr = rfile.read(2)
    if len(hdr) < 2:
        return None
    b0, b1 = hdr[0], hdr[1]
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    ln = b1 & 0x7F
    if ln == 126:
        ext = rfile.read(2)
        if len(ext) < 2:
            return None
        ln = struct.unpack(">H", ext)[0]
    elif ln == 127:
        ext = rfile.read(8)
        if len(ext) < 8:
            return None
        ln = struct.unpack(">Q", ext)[0]
    if ln > MAX_FRAME:
        return None  # protocol abuse: drop the connection
    mask = rfile.read(4) if masked else b"\x00" * 4
    payload = rfile.read(ln)
    if masked:
        payload = bytes(
            c ^ mask[i & 3] for i, c in enumerate(payload)
        )
    return fin, opcode, payload


def write_frame(wfile, payload: bytes, opcode: int = OP_TEXT):
    ln = len(payload)
    hdr = bytes([0x80 | opcode])
    if ln < 126:
        hdr += bytes([ln])
    elif ln < (1 << 16):
        hdr += bytes([126]) + struct.pack(">H", ln)
    else:
        hdr += bytes([127]) + struct.pack(">Q", ln)
    wfile.write(hdr + payload)
    wfile.flush()


def handshake(handler) -> bool:
    """Perform the server-side upgrade on a BaseHTTPRequestHandler whose
    current request carries Upgrade: websocket.  Returns True on
    success (the connection is then a raw WS stream)."""
    key = handler.headers.get("Sec-WebSocket-Key")
    if not key:
        return False
    handler.wfile.write(
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        + f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n".encode()
    )
    handler.wfile.flush()
    return True


def serve_text(handler, respond):
    """Text echo loop: for each client text message call respond(text)
    and send its return value back; handle ping/close and FIN=0
    fragmentation (continuation frames reassemble, bounded by
    MAX_FRAME) per the RFC.  Mirrors ws_handle_socket
    (pgr-server/src/main.rs:219-255)."""
    frag = None  # pending fragmented text message
    while True:
        frame = read_frame(handler.rfile)
        if frame is None:
            return
        fin, opcode, payload = frame
        if opcode == OP_CLOSE:
            try:
                write_frame(handler.wfile, payload[:2], OP_CLOSE)
            except OSError:
                pass
            return
        if opcode == OP_PING:
            write_frame(handler.wfile, payload, OP_PONG)
            continue
        if opcode == OP_TEXT and not fin:
            frag = bytearray(payload)
            continue
        if opcode == OP_CONT:
            if frag is None:
                return  # protocol violation
            frag.extend(payload)
            if len(frag) > MAX_FRAME:
                return
            if not fin:
                continue
            payload = bytes(frag)
            frag = None
        elif opcode != OP_TEXT:
            write_frame(handler.wfile, b"{}")
            continue
        out = respond(payload.decode("utf-8", "replace"))
        write_frame(handler.wfile, out.encode())
