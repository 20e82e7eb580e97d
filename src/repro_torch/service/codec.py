"""Length-prefixed npz framing for the shard wire protocol.

A message serialises to one npz archive (uncompressed zip of ``.npy``
members — numpy's own format, so dtypes/shapes round-trip exactly):

  * every array field -> member ``a:<field>``;
  * every array-dict field -> members ``d:<field>/<key>`` (snapshot state
    dicts keep their keys, including ``/``-nested ones);
  * everything else -> one JSON header member ``__meta__`` (uint8 bytes)
    holding ``{"kind": ..., <scalar fields>}``; ``None``/absent fields are
    simply omitted.

On the wire each message is one frame: an 8-byte big-endian length prefix
followed by the npz payload.  The framing is transport-agnostic — the
in-process transport skips it entirely, the process transport runs it over
a socket pair, and a future TCP transport reuses it unchanged.
"""

from __future__ import annotations

import dataclasses
import io
import json
import socket
import struct
from typing import Dict, Optional

import numpy as np

from .messages import MESSAGE_TYPES, Message

_LEN = struct.Struct(">Q")
MAX_FRAME = 1 << 40  # sanity bound: a corrupt length prefix fails fast


# ---------------------------------------------------------------------- #
# message <-> npz payload
# ---------------------------------------------------------------------- #
def _wire_array(owner: str, name: str, arr: np.ndarray) -> np.ndarray:
    """Refuse object/void arrays at encode time: decode runs with
    ``allow_pickle=False``, so letting one through here would serialise
    fine locally and explode on the *peer* — fail on the sender instead."""
    if arr.dtype.kind in ("O", "V"):
        raise TypeError(
            f"{owner}.{name} has non-fixed dtype {arr.dtype!r}; "
            "object arrays cannot cross the wire unpickled")
    return arr


def encode(msg: Message) -> bytes:
    meta: Dict[str, object] = {"kind": msg.kind}
    arrays: Dict[str, np.ndarray] = {}
    owner = type(msg).__name__
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if v is None:
            continue
        if f.name in msg._array_dicts:
            for key, arr in v.items():
                arrays[f"d:{f.name}/{key}"] = _wire_array(
                    owner, f"{f.name}[{key!r}]", np.asarray(arr))
        elif isinstance(v, np.ndarray):
            arrays[f"a:{f.name}"] = _wire_array(owner, f.name, v)
        else:
            meta[f.name] = v
    # observability sidecar: reserved header keys, present only when the
    # message was traced — absent, the bytes match the un-instrumented tree
    if msg.trace_ctx is not None:
        meta["__trace__"] = msg.trace_ctx
    if msg.span_summary:
        meta["__spans__"] = msg.span_summary
    if msg.op_seq is not None:
        meta["__seq__"] = list(msg.op_seq)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode(payload: bytes) -> Message:
    with np.load(io.BytesIO(payload), allow_pickle=False) as npz:
        meta = json.loads(bytes(npz["__meta__"]).decode("utf-8"))
        kind = meta.pop("kind")
        trace_ctx = meta.pop("__trace__", None)
        span_summary = meta.pop("__spans__", None)
        op_seq = meta.pop("__seq__", None)
        try:
            cls = MESSAGE_TYPES[kind]
        except KeyError:
            raise ValueError(f"unknown message kind {kind!r}") from None
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, object] = {
            k: v for k, v in meta.items() if k in fields}
        dicts: Dict[str, Dict[str, np.ndarray]] = {}
        for name in npz.files:
            if name == "__meta__":
                continue
            tag, _, rest = name.partition(":")
            if tag == "a":
                kwargs[rest] = npz[name]
            elif tag == "d":
                fname, _, key = rest.partition("/")
                dicts.setdefault(fname, {})[key] = npz[name]
        kwargs.update(dicts)
        msg = cls(**kwargs)
        if trace_ctx is not None:
            msg.trace_ctx = trace_ctx
        if span_summary is not None:
            msg.span_summary = span_summary
        if op_seq is not None:
            msg.op_seq = (str(op_seq[0]), int(op_seq[1]))
        return msg


# ---------------------------------------------------------------------- #
# frames over a stream socket
# ---------------------------------------------------------------------- #
def write_frame(sock: socket.socket, payload: bytes) -> int:
    frame = _LEN.pack(len(payload)) + payload
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise EOFError("peer closed the connection mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> Optional[bytes]:
    """Next frame payload, or None on clean EOF at a frame boundary."""
    head = b""
    while len(head) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(head))
        if not chunk:
            if head:
                raise EOFError("peer closed the connection mid-frame")
            return None
        head += chunk
    (n,) = _LEN.unpack(head)
    if n > MAX_FRAME:
        raise ValueError(f"frame length {n} exceeds MAX_FRAME")
    return _recv_exact(sock, n)
