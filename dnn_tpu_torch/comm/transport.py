"""The hop between stages: the transport handshake, the grpc rung, and
the framing of the streamed Relay RPC (port of the grpc parts of
dnn_tpu/comm/transport.py).

Negotiation rides one SendMessage call (sender_id `HELLO_SENDER`, a JSON
offer in the text, a JSON accept or decline in the reply), so it is
wire-compatible with a peer that knows nothing of it: a non-JSON reply
concludes on plain gRPC without Relay. This port proves no shm or device
rung: its offer wants none, and its stage servers decline every offer
while advertising `"relay": true`, so a peer of either package keeps the
streamed Relay RPC on the grpc rung.

Relay framing: a logical send is one or more TensorRequest frames whose
request_id carries `s=<seq>` (and `c=<i>/<n>` for chunk i of n of a
payload above CHUNK_BYTES); chunk 0 carries the shape, dtype and
checksum of the whole payload, and the receiver verifies it after
reassembly. Responses are `ack:<seq>` (accepted) and `res:<seq>:<status>`
(the result, or an error status for that item; seq -1 ends the stream
with an error). The `dl=` segment carries the deadline budget left.
"""

from __future__ import annotations

import json
import uuid
from typing import List, Optional, Tuple

from dnn_tpu_torch.comm import wirecodec as wc

TRANSPORTS = ("auto", "grpc")

# SendMessage's sender_id for the transport hello; every server of either
# package answers it before its normal text handling.
HELLO_SENDER = "dnn_tpu.transport.hello"


class TransportError(RuntimeError):
    """A relay frame that cannot be reassembled."""


def decline_hello(reason: str) -> str:
    """A decline without Relay: the endpoint serves unary calls only (the
    LM daemon)."""
    return json.dumps({"v": 1, "ok": False, "reason": reason})


def answer_hello(text: str) -> str:
    """A stage server's answer to an offer: no rung beyond grpc is
    proved here, so it declines, advertising the Relay RPC."""
    try:
        offer = json.loads(text)
        if not isinstance(offer, dict):
            raise TypeError
    except (json.JSONDecodeError, TypeError):
        return json.dumps({"v": 1, "ok": False, "reason": "bad offer"})
    return json.dumps({"v": 1, "ok": False, "relay": True,
                       "reason": "no common transport"})


class GrpcSender:
    """The grpc rung: the payload rides inline in the request."""

    name = "grpc"

    def make_request(self, arr, request_id: str) -> wc.TensorRequest:
        return wc.TensorRequest(request_id=request_id,
                                tensor=wc.make_tensor(arr))


class Negotiated:
    """A hop's handshake outcome. `relay_ok` means something only when
    `relay_known`: a hop without a handshake (explicit grpc, or a hello
    that failed) learns of Relay by trying it."""

    __slots__ = ("name", "sender", "relay_ok", "relay_known", "reason")

    def __init__(self, name: str, sender: GrpcSender, *,
                 relay_ok: bool = False, relay_known: bool = False,
                 reason: str = ""):
        self.name = name
        self.sender = sender
        self.relay_ok = relay_ok
        self.relay_known = relay_known
        self.reason = reason


def build_offer() -> dict:
    """This port's offer: no rung beyond grpc."""
    return {"v": 1, "want": [], "nonce": uuid.uuid4().hex}


def conclude(offer: dict, reply_text: str) -> Negotiated:
    """The peer's reply to `offer` -> the grpc outcome, with Relay on only
    when the reply is a JSON object that says `"relay": true` (a
    reference peer's plain confirmation string leaves it off)."""
    try:
        acc = json.loads(reply_text)
        if not isinstance(acc, dict):
            raise TypeError
    except (json.JSONDecodeError, TypeError):
        acc = {"reason": "peer is not transport-aware (reference "
                         "protocol)"}
    if acc.get("ok") and acc.get("nonce") == offer.get("nonce"):
        reason = f"peer chose {acc.get('chosen')!r}, which this port lacks"
    else:
        reason = str(acc.get("reason", "declined"))
    return Negotiated("grpc", GrpcSender(), relay_ok=bool(acc.get("relay")),
                      relay_known=True, reason=reason)


def negotiate_over(send_message_fn) -> Negotiated:
    """Run the handshake through `send_message_fn(sender_id, text) ->
    reply_text`; its RPC errors propagate (no verdict to keep)."""
    offer = build_offer()
    return conclude(offer, send_message_fn(HELLO_SENDER, json.dumps(offer)))


# ----------------------------------------------------------------------
# streamed relay framing
# ----------------------------------------------------------------------

_SEQ_PREFIX = "s="
_CHUNK_PREFIX = "c="
_ACK_PREFIX = "ack:"
_RES_PREFIX = "res:"

# payloads above this ride the Relay stream in chunks
CHUNK_BYTES = 1 << 20


def ack_status(seq: int) -> str:
    return f"{_ACK_PREFIX}{seq}"


def parse_ack(status: str) -> Optional[int]:
    if status.startswith(_ACK_PREFIX):
        try:
            return int(status[len(_ACK_PREFIX):])
        except ValueError:
            return None
    return None


def result_status(seq: int, human: str) -> str:
    return f"{_RES_PREFIX}{seq}:{human}"


def parse_result(status: str) -> Tuple[Optional[int], str]:
    """-> (seq or None, the human status); a plain status passes through
    with seq None."""
    if status.startswith(_RES_PREFIX):
        seq_s, _, human = status[len(_RES_PREFIX):].partition(":")
        try:
            return int(seq_s), human
        except ValueError:
            pass
    return None, status


def tag_seq(request_id: str, seq: int,
            chunk: Optional[Tuple[int, int]] = None) -> str:
    rid = f"{request_id}:{_SEQ_PREFIX}{seq}"
    if chunk is not None:
        rid += f":{_CHUNK_PREFIX}{chunk[0]}/{chunk[1]}"
    return rid


def parse_seq(request_id: str) -> Tuple[str, Optional[int],
                                        Optional[Tuple[int, int]]]:
    """-> (base request_id, seq or None, (chunk i, chunk n) or None)."""
    base, seq, chunk = [], None, None
    for seg in (request_id or "").split(":"):
        if seg.startswith(_SEQ_PREFIX):
            try:
                seq = int(seg[len(_SEQ_PREFIX):])
                continue
            except ValueError:
                pass
        if seg.startswith(_CHUNK_PREFIX):
            try:
                i, n = seg[len(_CHUNK_PREFIX):].split("/")
                chunk = (int(i), int(n))
                continue
            except ValueError:
                pass
        base.append(seg)
    return ":".join(base), seq, chunk


_DL_PREFIX = "dl="


def strip_deadline(request_id: str) -> str:
    if _DL_PREFIX not in (request_id or ""):
        return request_id
    return ":".join(seg for seg in request_id.split(":")
                    if not seg.startswith(_DL_PREFIX))


def tag_deadline(request_id: str, remaining_s: float) -> str:
    """request_id with its `dl=` segment set to the budget the sender
    grants the rest of the pipeline (opaque to peers that do not read
    it)."""
    return (f"{strip_deadline(request_id or '')}:"
            f"{_DL_PREFIX}{max(float(remaining_s), 0.001):.3f}")


def extract_deadline(request_id: str) -> Optional[float]:
    """The inbound `dl=` budget in seconds, or None when there is none."""
    for seg in (request_id or "").split(":"):
        if seg.startswith(_DL_PREFIX):
            try:
                return float(seg[len(_DL_PREFIX):])
            except ValueError:
                return None
    return None


def split_requests(request: wc.TensorRequest,
                   seq: int) -> List[wc.TensorRequest]:
    """One logical send -> its Relay frames: whole when the payload fits
    in CHUNK_BYTES, else chunks that are memoryview slices of it (no
    copy). Chunk 0 carries the shape, dtype and crc32c."""
    t = request.tensor
    data = t.tensor_data
    if len(data) <= CHUNK_BYTES:
        return [wc.TensorRequest(request_id=tag_seq(request.request_id, seq),
                                 tensor=t)]
    view = memoryview(data)
    n = (len(view) + CHUNK_BYTES - 1) // CHUNK_BYTES
    out = []
    for i in range(n):
        first = i == 0
        out.append(wc.TensorRequest(
            request_id=tag_seq(request.request_id, seq, (i, n)),
            tensor=wc.Tensor(
                tensor_data=view[i * CHUNK_BYTES:(i + 1) * CHUNK_BYTES],
                shape=t.shape if first else (), dtype=t.dtype if first else "",
                crc32c=t.crc32c if first else None)))
    return out


class ChunkAssembler:
    """Reassembles one Relay stream's frames: the in-order chunks of a
    sequence go into one buffer (the only copy); anything out of order
    raises TransportError."""

    def __init__(self):
        self._cur: Optional[dict] = None

    def add(self, request: wc.TensorRequest
            ) -> Optional[Tuple[str, int, wc.Tensor]]:
        """-> (base request_id, seq, the whole Tensor) when a payload is
        complete, else None."""
        base, seq, chunk = parse_seq(request.request_id)
        seq = 0 if seq is None else seq
        t = request.tensor
        if chunk is None:
            return base, seq, t
        i, n = chunk
        if i == 0:
            self._cur = {"base": base, "seq": seq, "n": n,
                         "shape": list(t.shape), "dtype": t.dtype,
                         "crc": t.crc32c, "parts": [], "next": 0}
        cur = self._cur
        if cur is None or cur["seq"] != seq or cur["next"] != i:
            raise TransportError(
                f"relay chunk out of order: got {i}/{n} for seq {seq}")
        cur["parts"].append(t.tensor_data)
        cur["next"] += 1
        if cur["next"] < cur["n"]:
            return None
        self._cur = None
        whole = bytearray(sum(len(p) for p in cur["parts"]))
        off = 0
        for p in cur["parts"]:
            whole[off:off + len(p)] = p
            off += len(p)
        return cur["base"], seq, wc.Tensor(
            tensor_data=memoryview(whole), shape=cur["shape"],
            dtype=cur["dtype"], crc32c=cur["crc"])
