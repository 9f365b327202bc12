"""The hop between stages: the transport ladder (device, shm, grpc) and
the framing of the streamed Relay RPC (port of
dnn_tpu/comm/transport.py:99-930).

    device   a hop inside one process: the sender parks the activation
             (a CUDA tensor stays on its card, never copied to the host)
             in the process-global mailbox under a ticket, with a CUDA
             event recorded on the producer's stream; the receiving
             stage waits on that event before it reads. The entry lives
             until the hop's response lands (the sender drops it), so a
             retry resends the same ticket. `make_hop_program` is the
             single-process hop of the stage mesh: stage i's row onto
             stage i + 1's device.
    shm      a hop between processes of one host: one host copy into a
             POSIX shared-memory ring slot, the ticket's meta (`seg`,
             `slot`, `nbytes`, `shape`, `dtype`) in the control message;
             the receiver copies the payload out of the slot. Same-host
             reachability is proven at the handshake: the server attaches
             the client's probe segment and must read the offer's nonce
             out of it.
    grpc     the reference wire, the payload inline.

Negotiation rides one SendMessage call (sender_id `HELLO_SENDER`, a JSON
offer in the text, a JSON accept or decline in the reply), byte for byte
JAX's, so a JAX stage and a port stage of one host settle on shm, and a
peer that knows nothing of it answers a non-JSON confirmation, which
concludes on plain gRPC without Relay. The device rung never crosses
packages: each package has its own PROC_TOKEN. "auto" walks device ->
shm -> grpc and records a `transport_fallback` flight event when it
degrades; an explicit "device" or "shm" that cannot be satisfied raises
TransportMisconfigError. Outcomes count in
`comm.transport_negotiations_total{chosen,role,stage|target}`.

Relay framing: a logical send is one or more TensorRequest frames whose
request_id carries `s=<seq>` (and `c=<i>/<n>` for chunk i of n of an
inline payload above CHUNK_BYTES; tickets are never chunked); chunk 0
carries the shape, dtype and checksum of the whole payload, and the
receiver verifies it after reassembly. Responses are `ack:<seq>`
(accepted) and `res:<seq>:<status>` (the result, or an error status for
that item; seq -1 ends the stream with an error). The `dl=` segment
carries the deadline budget left. The assembler consults the chaos seam
`perturb_relay()` for every frame.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dnn_tpu_torch import obs
from dnn_tpu_torch.chaos import inject as _chaos_inject
from dnn_tpu_torch.comm import wirecodec as wc
from dnn_tpu_torch.utils.metrics import labeled

log = logging.getLogger("dnn_tpu_torch.comm")

TRANSPORTS = ("auto", "grpc", "shm", "device")

# SendMessage's sender_id for the transport hello; every server of either
# package answers it before its normal text handling.
HELLO_SENDER = "dnn_tpu.transport.hello"

# ticket payloads ride the Tensor message with these dtype markers, only
# after a successful negotiation
TICKET_DTYPE_DEV = "dnn.dev1"
TICKET_DTYPE_SHM = "dnn.shm1"
TICKET_DTYPES = (TICKET_DTYPE_DEV, TICKET_DTYPE_SHM)

# one token a process: the device rung's proof (this package's own, so a
# JAX stage in the same process never takes the device rung)
PROC_TOKEN = uuid.uuid4().hex


def host_token() -> str:
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            boot = f.read().strip()
    except OSError:
        boot = "-"
    return f"{socket.gethostname()}:{boot}"


# per-stage compute slice plus the rung's wire margin (JAX :116-137)
STAGE_COMPUTE_BUDGET_S = 25.0
HOP_MARGIN_S = {"grpc": 5.0, "shm": 1.0, "device": 0.5}
PER_STAGE_BUDGET_S = STAGE_COMPUTE_BUDGET_S + HOP_MARGIN_S["grpc"]  # 30.0
# after a hop's first successful send the downstream stage is warm
WARM_STAGE_COMPUTE_BUDGET_S = 5.0


def hop_budget_s(transport: str, downstream_stages: int, *,
                 warm: bool = False) -> float:
    """The budget of one hop covering `downstream_stages` stages, by the
    negotiated rung; `warm` (a send on this hop already succeeded) drops
    a device or shm hop to the warm compute slice. grpc keeps the
    reference-compatible 30 s a stage."""
    name = "grpc" if transport not in HOP_MARGIN_S else transport
    compute = STAGE_COMPUTE_BUDGET_S
    if warm and name != "grpc":
        compute = WARM_STAGE_COMPUTE_BUDGET_S
    return (compute + HOP_MARGIN_S[name]) * max(downstream_stages, 1)


class TransportError(RuntimeError):
    """A relay frame that cannot be reassembled, or a ticket that cannot
    be resolved."""


class TransportMisconfigError(TransportError):
    """An explicitly requested rung cannot be satisfied on this hop
    (e.g. --transport device across processes): never downgraded."""


# ----------------------------------------------------------------------
# device mailbox (hops inside one process)
# ----------------------------------------------------------------------

class _DeviceMailbox:
    """Process-global rendezvous: the sender parks (tensor, event) under
    a ticket; the receiving stage peeks it (a retry resends the same
    ticket) and the sender drops it once the hop's response landed."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[str, Any] = {}

    def put(self, value) -> str:
        ticket = uuid.uuid4().hex
        with self._lock:
            self._entries[ticket] = value
        return ticket

    def peek(self, ticket: str):
        with self._lock:
            return self._entries.get(ticket)

    def drop(self, ticket: str):
        with self._lock:
            self._entries.pop(ticket, None)

    def __len__(self):
        with self._lock:
            return len(self._entries)


MAILBOX = _DeviceMailbox()


def _park(value, device=None):
    """(tensor on `device`, the event its producer's stream recorded, or
    None on the CPU). A numpy array becomes a tensor first."""
    if not isinstance(value, torch.Tensor):
        value = torch.as_tensor(np.asarray(value))
    if device is not None:
        value = value.to(device, non_blocking=True)
    event = None
    if value.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
    return value, event


def _claim(entry):
    """A parked (tensor, event) -> the tensor, the reader's stream
    ordered after the producer's event."""
    value, event = entry
    if event is not None:
        torch.cuda.current_stream(value.device).wait_event(event)
    return value


def make_hop_program(mesh):
    """The stage mesh's hop (JAX :189): hop(i, row) moves stage i's row
    onto stage i + 1's device, ordered after the work queued on stage
    i's device. On one card it is the row itself."""
    from dnn_tpu_torch.parallel.mesh import as_mesh

    devices = as_mesh(mesh).devices
    if len(devices) < 2:
        raise ValueError("hop program needs >= 2 stages on 'stage'")

    def hop(i: int, row):
        if not 0 <= i < len(devices) - 1:
            raise ValueError(f"hop {i} outside 0..{len(devices) - 2}")
        return _claim(_park(row, devices[i + 1]))

    return hop


# ----------------------------------------------------------------------
# shm ring (hops between processes of one host)
# ----------------------------------------------------------------------

def _new_segment(nbytes: int):
    from multiprocessing import shared_memory

    return shared_memory.SharedMemory(
        create=True, size=max(int(nbytes), 1),
        name=f"dnn_tpu_{uuid.uuid4().hex[:16]}")


class _ShmSlot:
    def __init__(self, nbytes: int):
        self.shm = _new_segment(nbytes)
        self.busy = False

    def ensure(self, nbytes: int):
        if self.shm.size < nbytes:
            self.close()
            self.shm = _new_segment(nbytes)

    def close(self):
        if self.shm is not None:
            try:
                self.shm.unlink()
                self.shm.close()
            except (OSError, BufferError):
                pass
            self.shm = None


class ShmRing:
    """Sender-owned ring of reusable shared-memory slots, one hop's
    in-flight window. A slot is busy from `write` until the receiver's
    response or ack frees it (the receiver copies the payload out of it
    first). A slot grows into a new segment (new name) when a payload
    outsizes it; segments are unlinked on close."""

    def __init__(self, slots: int = 4):
        self._slots: List[Optional[_ShmSlot]] = [None] * max(slots, 1)
        self._lock = threading.Lock()
        self._free = threading.Condition(self._lock)

    def _acquire_locked(self, nbytes: int):
        for i, s in enumerate(self._slots):
            if s is None or not s.busy:
                if s is None:
                    s = self._slots[i] = _ShmSlot(nbytes)
                else:
                    s.ensure(nbytes)
                s.busy = True
                return i, s
        return None

    def write(self, view: memoryview, timeout: float = 30.0
              ) -> Tuple[str, int]:
        """Copy `view` into a free slot (the shm path's one host copy);
        blocks while every slot is in flight."""
        with self._free:
            if not self._free.wait_for(
                    lambda: any(s is None or not s.busy
                                for s in self._slots), timeout=timeout):
                raise TransportError(
                    "shm ring exhausted: no slot freed within "
                    f"{timeout}s ({len(self._slots)} slots)")
            idx, slot = self._acquire_locked(len(view))
        slot.shm.buf[:len(view)] = view
        return slot.shm.name, idx

    def write_nowait(self, view: memoryview) -> Optional[Tuple[str, int]]:
        """write without waiting: None when every slot is in flight."""
        with self._free:
            got = self._acquire_locked(len(view))
            if got is None:
                return None
            idx, slot = got
        slot.shm.buf[:len(view)] = view
        return slot.shm.name, idx

    def release(self, idx: int):
        with self._free:
            s = self._slots[idx]
            if s is not None:
                s.busy = False
            self._free.notify_all()

    def close(self):
        with self._lock:
            for s in self._slots:
                if s is not None:
                    s.close()
            self._slots = [None] * len(self._slots)


# ----------------------------------------------------------------------
# senders: the client side of one hop
# ----------------------------------------------------------------------

class Sender:
    """One negotiated hop. `make_request(arr, request_id)` builds the
    wire message (inline tensor or ticket); `sent_ok` (the response
    landed) and `cleanup` (the send was abandoned) release a ticket's
    resources."""

    name = "grpc"

    def make_request(self, arr, request_id: str) -> wc.TensorRequest:
        raise NotImplementedError

    def make_request_nowait(self, arr, request_id: str
                            ) -> Optional[wc.TensorRequest]:
        """For event-loop callers: None when the send would wait (a full
        shm ring)."""
        return self.make_request(arr, request_id)

    def sent_ok(self, request: wc.TensorRequest):
        pass

    def cleanup(self, request: wc.TensorRequest):
        pass

    def close(self):
        pass


class GrpcSender(Sender):
    """The grpc rung: the payload rides inline in the request."""

    name = "grpc"

    def make_request(self, arr, request_id: str) -> wc.TensorRequest:
        return wc.TensorRequest(request_id=request_id,
                                tensor=wc.make_tensor(arr))


class DeviceSender(Sender):
    """A hop inside one process: the activation stays where it is (a
    CUDA tensor on its card), parked in the mailbox with its producer's
    event; `device`, the receiving stage's, starts the copy there before
    the control message."""

    name = "device"

    def __init__(self, device=None):
        self.device = device

    def make_request(self, arr, request_id: str) -> wc.TensorRequest:
        ticket = MAILBOX.put(_park(arr, self.device))
        return wc.TensorRequest(
            request_id=request_id,
            tensor=wc.Tensor(tensor_data=ticket.encode(), shape=(),
                             dtype=TICKET_DTYPE_DEV))

    @staticmethod
    def _ticket(request) -> str:
        return bytes(request.tensor.tensor_data).decode()

    def sent_ok(self, request):
        MAILBOX.drop(self._ticket(request))

    cleanup = sent_ok


class ShmSender(Sender):
    """A hop between processes of one host: one host copy into a ring
    slot; the ticket names the segment and the layout."""

    name = "shm"

    def __init__(self, slots: int = 4):
        self._ring = ShmRing(slots)

    @staticmethod
    def _payload(arr):
        a, name = wc._wire_array(arr)
        shape = tuple(a.shape)
        a = np.ascontiguousarray(a)
        return memoryview(a.reshape(-1).view(np.uint8)), shape, name

    @staticmethod
    def _ticket(request_id: str, seg: str, idx: int, view, shape, dtype
                ) -> wc.TensorRequest:
        meta = json.dumps({"seg": seg, "slot": idx, "nbytes": len(view),
                           "shape": list(shape), "dtype": dtype})
        return wc.TensorRequest(
            request_id=request_id,
            tensor=wc.Tensor(tensor_data=meta.encode(), shape=(),
                             dtype=TICKET_DTYPE_SHM))

    def make_request(self, arr, request_id: str) -> wc.TensorRequest:
        view, shape, dtype = self._payload(arr)
        seg, idx = self._ring.write(view)
        return self._ticket(request_id, seg, idx, view, shape, dtype)

    def make_request_nowait(self, arr, request_id: str
                            ) -> Optional[wc.TensorRequest]:
        view, shape, dtype = self._payload(arr)
        got = self._ring.write_nowait(view)
        if got is None:
            return None
        return self._ticket(request_id, got[0], got[1], view, shape, dtype)

    @staticmethod
    def _slot(request) -> int:
        return json.loads(bytes(request.tensor.tensor_data).decode())["slot"]

    def sent_ok(self, request):
        self._ring.release(self._slot(request))

    cleanup = sent_ok

    def close(self):
        self._ring.close()


# ----------------------------------------------------------------------
# negotiation
# ----------------------------------------------------------------------

def _ladder(transport: str) -> List[str]:
    if transport == "auto":
        return ["device", "shm"]
    if transport in ("device", "shm"):
        return [transport]
    return []


def build_offer(transport: str = "auto") -> Tuple[dict, Optional[object]]:
    """-> (offer, the shm probe segment or None). The caller closes the
    probe after the handshake (close_probe)."""
    want = _ladder(transport)
    offer = {"v": 1, "want": want, "proc": PROC_TOKEN,
             "host": host_token(), "nonce": uuid.uuid4().hex}
    probe = None
    if "shm" in want:
        try:
            from multiprocessing import shared_memory

            probe = shared_memory.SharedMemory(
                create=True, size=64,
                name=f"dnn_tpu_probe_{uuid.uuid4().hex[:12]}")
            nb = offer["nonce"].encode()
            probe.buf[:len(nb)] = nb
            probe.buf[len(nb)] = 0
            offer["shm_probe"] = probe.name
        except (OSError, ImportError, ValueError):
            offer["want"] = [w for w in want if w != "shm"]
    return offer, probe


def _read_probe(name: str) -> str:
    from multiprocessing import shared_memory

    probe = shared_memory.SharedMemory(name=name)
    try:
        return bytes(probe.buf[:64]).split(b"\x00", 1)[0].decode()
    finally:
        probe.close()


def answer_hello(text: str, *, allow: Tuple[str, ...] = ("device", "shm"),
                 stage: str = "") -> str:
    """A stage server's answer: the highest rung of the client's ladder
    this process can prove and `allow`s — device when the offer's
    `proc` is this process's token, shm when the probe segment holds
    the offer's nonce; else a decline that advertises Relay."""
    try:
        offer = json.loads(text)
        want = list(offer.get("want", ()))
        nonce = str(offer.get("nonce", ""))
    except (json.JSONDecodeError, AttributeError, TypeError):
        return json.dumps({"v": 1, "ok": False, "reason": "bad offer"})
    if "device" in want and "device" in allow \
            and offer.get("proc") == PROC_TOKEN:
        chosen = "device"
    elif "shm" in want and "shm" in allow and offer.get("shm_probe"):
        try:
            raw = _read_probe(offer["shm_probe"])
        except (OSError, ValueError):
            return json.dumps({"v": 1, "ok": False, "relay": True,
                               "reason": "shm probe unreachable"})
        if raw != nonce:
            return json.dumps({"v": 1, "ok": False, "relay": True,
                               "reason": "shm probe nonce mismatch"})
        chosen = "shm"
    else:
        return json.dumps({"v": 1, "ok": False, "relay": True,
                           "reason": "no common transport"})
    m = obs.metrics()
    if m is not None:
        m.inc(labeled("comm.transport_negotiations_total", chosen=chosen,
                      role="server", stage=stage or "-"))
    return json.dumps({"v": 1, "ok": True, "chosen": chosen,
                       "proc": PROC_TOKEN, "nonce": nonce, "relay": True})


def decline_hello(reason: str = "transport negotiation not supported "
                                "on this endpoint") -> str:
    """A decline without Relay: the endpoint serves unary calls only (the
    LM daemon)."""
    return json.dumps({"v": 1, "ok": False, "reason": reason})


class Negotiated:
    """A hop's handshake outcome. `relay_ok` means something only when
    `relay_known`: a hop without a handshake (explicit grpc, or a hello
    that failed) learns of Relay by trying it."""

    __slots__ = ("name", "sender", "relay_ok", "relay_known", "reason")

    def __init__(self, name: str, sender: Sender, *,
                 relay_ok: bool = False, relay_known: bool = False,
                 reason: str = ""):
        self.name = name
        self.sender = sender
        self.relay_ok = relay_ok
        self.relay_known = relay_known
        self.reason = reason


def close_probe(probe):
    """Release the handshake's shm probe segment (idempotent)."""
    if probe is not None:
        try:
            probe.close()
            probe.unlink()
        except (OSError, BufferError):
            pass


def conclude(offer: dict, reply_text: str, *, transport: str = "auto",
             target: str = "", device=None, shm_slots: int = 4
             ) -> Negotiated:
    """The peer's reply to `offer` -> the hop's rung. An explicit rung the
    reply does not grant raises TransportMisconfigError; "auto" falls
    back to grpc with a `transport_fallback` flight event. Relay is on
    when the reply is a JSON object that says `"relay": true`."""
    want = list(offer.get("want", ()))
    if transport != "auto" and not want:
        raise TransportMisconfigError(
            f"transport={transport!r} unavailable on this host "
            f"(shared memory unsupported)")
    try:
        acc = json.loads(reply_text)
        if not isinstance(acc, dict):
            raise TypeError
    except (json.JSONDecodeError, TypeError):
        acc = {"ok": False, "reason": "peer is not transport-aware "
                                      "(reference protocol)"}
    ok = bool(acc.get("ok")) and acc.get("chosen") in want \
        and acc.get("nonce") == offer.get("nonce")
    m = obs.metrics()
    if ok:
        chosen = acc["chosen"]
        sender: Sender = DeviceSender(device) if chosen == "device" \
            else ShmSender(shm_slots)
        if m is not None:
            m.inc(labeled("comm.transport_negotiations_total",
                          chosen=chosen, role="client", target=target))
        return Negotiated(chosen, sender, relay_ok=bool(acc.get("relay")),
                          relay_known=True)
    reason = str(acc.get("reason", "declined"))
    if transport != "auto":
        raise TransportMisconfigError(
            f"transport={transport!r} to {target or 'peer'} refused: "
            f"{reason}")
    if want:
        obs.flight.record("transport_fallback", target=target,
                          wanted=want, chosen="grpc", reason=reason)
        log.info("transport negotiation with %s fell back to grpc (%s)",
                 target or "peer", reason)
    if m is not None:
        m.inc(labeled("comm.transport_negotiations_total", chosen="grpc",
                      role="client", target=target))
    return Negotiated("grpc", GrpcSender(), reason=reason,
                      relay_ok=bool(acc.get("relay")), relay_known=True)


def negotiate_over(send_message_fn, *, transport: str = "auto",
                   target: str = "", device=None,
                   shm_slots: int = 4) -> Negotiated:
    """Run the handshake through `send_message_fn(sender_id, text) ->
    reply_text`; its RPC errors propagate (no verdict to keep)."""
    if transport not in TRANSPORTS:
        raise ValueError(
            f"transport must be one of {TRANSPORTS}, got {transport!r}")
    if transport == "grpc":
        return Negotiated("grpc", GrpcSender(), reason="explicit")
    offer, probe = build_offer(transport)
    try:
        reply = send_message_fn(HELLO_SENDER, json.dumps(offer))
        return conclude(offer, reply, transport=transport, target=target,
                        device=device, shm_slots=shm_slots)
    finally:
        close_probe(probe)


# ----------------------------------------------------------------------
# receiver side: tickets
# ----------------------------------------------------------------------

class TransportHost:
    """A stage server's receiver state: answers hellos and resolves
    inbound tickets. shm attachments are cached by segment name, at most
    MAX_SHM_ATTACHMENTS (LRU: a sender retires a segment whenever a
    payload outgrows its slot)."""

    MAX_SHM_ATTACHMENTS = 64

    def __init__(self, *, stage: str = "",
                 allow: Tuple[str, ...] = ("device", "shm")):
        self.stage = stage
        self.allow = tuple(allow)
        self._lock = threading.Lock()
        self._shm_attached: Dict[str, object] = {}

    def answer_hello(self, text: str) -> str:
        return answer_hello(text, allow=self.allow, stage=self.stage)

    @staticmethod
    def is_ticket(msg) -> bool:
        return msg.dtype in TICKET_DTYPES

    def _attach(self, name: str):
        from multiprocessing import shared_memory

        with self._lock:
            shm = self._shm_attached.pop(name, None)
            if shm is None:
                try:
                    shm = shared_memory.SharedMemory(name=name)
                except OSError as e:
                    raise TransportError(
                        f"shm segment {name} unreachable: {e}") from e
            self._shm_attached[name] = shm
            while len(self._shm_attached) > self.MAX_SHM_ATTACHMENTS:
                stale = self._shm_attached.pop(
                    next(iter(self._shm_attached)))
                try:
                    stale.close()
                except (OSError, BufferError):
                    pass
            return shm

    def resolve(self, msg) -> torch.Tensor:
        """A ticket -> the activation: a device ticket's parked tensor
        (the reader's stream waits on the producer's event), an shm
        ticket's payload copied out of its slot into a CPU tensor of its
        own (the sender may reuse the slot once the hop answers). Raises
        TransportError on an unknown or stale ticket."""
        if msg.dtype == TICKET_DTYPE_DEV:
            ticket = bytes(msg.tensor_data).decode()
            entry = MAILBOX.peek(ticket)
            if entry is None:
                raise TransportError(
                    f"device ticket {ticket[:8]}... not in this process's "
                    "mailbox (mis-negotiated or already consumed)")
            return _claim(entry)
        if msg.dtype == TICKET_DTYPE_SHM:
            meta = json.loads(bytes(msg.tensor_data).decode())
            nbytes = int(meta["nbytes"])
            shm = self._attach(meta["seg"])
            name = meta["dtype"]
            if name not in wc._DTYPES:
                raise TransportError(f"shm ticket dtype {name!r} unknown")
            dt = wc._DTYPES[name].newbyteorder("<")
            shape = tuple(int(s) for s in meta["shape"])
            count = int(np.prod(shape)) if shape else 1
            if count * dt.itemsize != nbytes or nbytes > shm.size:
                raise TransportError(f"shm ticket layout invalid: {meta}")
            a = np.frombuffer(shm.buf, dtype=dt, count=count).reshape(
                shape).astype(dt.newbyteorder("="), copy=True)
            t = torch.from_numpy(a)
            return t.view(torch.bfloat16) if name == "bfloat16" else t
        raise TransportError(f"not a transport ticket: dtype={msg.dtype!r}")

    def close(self):
        with self._lock:
            for shm in self._shm_attached.values():
                try:
                    shm.close()
                except (OSError, BufferError):
                    pass
            self._shm_attached.clear()


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
    """One logical send -> its Relay frames: whole when it is a ticket or
    the payload fits in CHUNK_BYTES, else chunks that are memoryview slices of it (no
    copy). Chunk 0 carries the shape, dtype and crc32c."""
    t = request.tensor
    data = t.tensor_data
    if t.dtype in TICKET_DTYPES or len(data) <= CHUNK_BYTES:
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
        complete, else None (also for a frame the chaos seam drops)."""
        if _chaos_inject.perturb_relay():
            return None
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
