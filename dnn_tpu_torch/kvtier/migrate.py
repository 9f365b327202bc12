"""Block migration: move a prefix's KV blocks between replicas (port of
dnn_tpu/kvtier/migrate.py).

Three layers, per block rather than one packed row:

  * the WIRE CODEC (`pack_blocks` / `unpack_blocks`): one uint8 array =
    magic + a 4-byte big-endian header length + a JSON header + the
    prompt's tokens + the raw block leaves in C order + the stored
    logits rows — byte for byte the JAX package's, so either package
    reads the other's payloads. Quantized pools migrate as they are:
    int8 K/V at one byte an element, int4 nibble-packed at half a byte
    (two values a byte; the fingerprint, not the host array, names a
    leaf int4). bfloat16 ships as its 16-bit words, read and written
    through torch views (no ml_dtypes). `unpack_blocks` returns CPU
    torch tensors.

  * the LEASE state machine (`Lease` / `LeaseTable`, donor side): a
    staged export is a lease — `offered` (bytes staged, optionally
    published to a shm segment) -> `pulling` (the adopter started a
    grpc fetch) -> `adopted` (the adopter acked its ingest) ->
    `released` (the donor freed the staging). TTL expiry from offered
    or pulling lands in `expired`, whose ONLY exit is the reclaim back
    to released. `TRANSITIONS` is the table (the JAX package's
    analysis/protocol.KVLEASE); every state change goes through it. A
    dying donor cannot corrupt an adopter: the adopter ingests only a
    fully parsed, geometry-checked payload into fresh local blocks, and
    a lease that dies mid-pull simply expires — the adopter prefills
    again.

  * the RUNGS (`publish_shm` / `attach_shm` / `pull_blocks`): on one
    host the payload crosses as one memcpy through a POSIX shared-memory
    segment whose first bytes hold the offer's nonce, which the adopter
    checks before it reads a byte; any failure there (a cross-host
    donor, a stale segment, a nonce mismatch) falls back to the grpc
    fetch rung.

Every lease transition lands in the flight recorder under the JAX
module's kinds (lease_pull, lease_adopt, lease_release, lease_expire,
lease_reclaim), and so does a failed shm rung (kvtier_shm_fallback).
Host code only; no device work.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dnn_tpu_torch import obs
from dnn_tpu_torch.control.handoff import _TORCH, host_bytes, np_dtype_name

__all__ = ["pack_blocks", "unpack_blocks", "MigrateFormatError",
           "Lease", "LeaseTable", "TRANSITIONS", "publish_shm",
           "attach_shm", "pull_blocks", "DEFAULT_LEASE_TTL_S"]

_MAGIC = b"dnnkvt1\n"
_NONCE_BYTES = 16
DEFAULT_LEASE_TTL_S = 30.0
MAX_LEASES = 16  # a donor's staged offers; past it the oldest expires

# the lease lifecycle: (state, event, next state). `expired` is not
# terminal: its one exit, the reclaim, is what frees an abandoned lease's
# staging
TRANSITIONS = (
    ("offered", "lease_pull", "pulling"),
    # the shm rung never calls kvfetch: the ack is the first the donor
    # hears of it
    ("offered", "lease_adopt", "adopted"),
    ("pulling", "lease_adopt", "adopted"),
    ("adopted", "lease_release", "released"),
    ("offered", "lease_expire", "expired"),
    ("pulling", "lease_expire", "expired"),
    ("expired", "lease_reclaim", "released"),
)
_NEXT = {(s, e): d for s, e, d in TRANSITIONS}


class MigrateFormatError(ValueError):
    """A payload this module cannot pack or parse — corrupt bytes, an
    unsupported dtype, or a header/byte-length mismatch. A ValueError, so
    the daemon answers INVALID_ARGUMENT."""


def _pack_nibbles(arr: np.ndarray) -> bytes:
    """int8 VALUES in [-8, 7] -> two's-complement nibbles, two a byte
    (even index = low nibble). An odd count pads one zero nibble; the
    header's shape recovers the true count."""
    flat = np.ascontiguousarray(arr, np.int8).reshape(-1)
    if flat.size % 2:
        flat = np.concatenate([flat, np.zeros((1,), np.int8)])
    u = (flat.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[0::2] | (u[1::2] << 4)).tobytes()


def _unpack_nibbles(raw: np.ndarray, n: int) -> np.ndarray:
    """Inverse of _pack_nibbles -> n int8 values in [-8, 7]."""
    lo = (raw & 0xF).astype(np.int8)
    hi = ((raw >> 4) & 0xF).astype(np.int8)
    out = np.empty((raw.size * 2,), np.int8)
    out[0::2], out[1::2] = lo, hi
    out = np.where(out > 7, out - 16, out).astype(np.int8)
    return out[:n]


def _leaf_dtype_name(fingerprint: dict, name: str, leaf) -> str:
    """The TRUE cache dtype of a leaf: int4 pools cross the host boundary
    as int8 values, so the fingerprint (not the host array) decides."""
    spec = (fingerprint or {}).get("leaves", {}).get(name)
    if spec:
        return spec[1]
    if isinstance(leaf, torch.Tensor):
        return np_dtype_name(leaf.dtype)
    return np.asarray(leaf).dtype.name


def pack_blocks(payload: Dict) -> np.ndarray:
    """`ContinuousBatcher.kvtier_export`'s dict -> one 1-D uint8 wire
    array. Leaves (torch tensors or numpy arrays) ride as raw C-order
    bytes; int4 leaves nibble-pack."""
    fp = payload.get("fingerprint") or {}
    tokens = np.ascontiguousarray(np.asarray(payload["tokens"]), np.int32)
    chunks = [tokens.tobytes()]
    leaf_specs = {}
    for name in sorted(payload["leaves"]):
        leaf = payload["leaves"][name]
        true_dt = _leaf_dtype_name(fp, name, leaf)
        if true_dt == "int4":
            host = np.asarray(leaf.cpu() if isinstance(leaf, torch.Tensor)
                              else leaf)
            wire, enc = _pack_nibbles(host), "nibble"
        else:
            host, _ = host_bytes(leaf, MigrateFormatError)
            wire, enc = host.tobytes(), "raw"
        chunks.append(wire)
        leaf_specs[name] = {"shape": list(host.shape), "dtype": true_dt,
                            "enc": enc, "bytes": len(wire)}
    lr = payload.get("logit_rows") or {}
    lr_idx = sorted(int(i) for i in lr)
    lr_arr = (np.stack([np.asarray(torch.as_tensor(lr[i]).float().cpu(),
                                   np.float32) for i in lr_idx])
              if lr_idx else np.zeros((0, 0), np.float32))
    chunks.append(np.ascontiguousarray(lr_arr).tobytes())
    header = json.dumps({
        "v": 1,
        "block_len": int(payload["block_len"]),
        "n_tokens": int(tokens.size),
        "fingerprint": fp,
        "leaves": leaf_specs,
        "logit_idx": lr_idx,
        "logit_shape": list(lr_arr.shape),
    }).encode()
    buf = b"".join([_MAGIC, len(header).to_bytes(4, "big"), header]
                   + chunks)
    return np.frombuffer(buf, np.uint8)


def unpack_blocks(buf) -> Dict:
    """Inverse of pack_blocks -> {tokens (int32 numpy), block_len, leaves
    {name: CPU torch tensor}, logit_rows {block index: (V,) f32 tensor},
    fingerprint}. Raises MigrateFormatError (a ValueError) on anything
    malformed — an adopter answers INVALID_ARGUMENT and never ingests
    garbage blocks."""
    if isinstance(buf, torch.Tensor):
        buf = buf.detach().cpu().numpy()
    raw = np.asarray(buf, np.uint8).tobytes()
    if not raw.startswith(_MAGIC):
        raise MigrateFormatError(
            "not a kvtier block payload (bad magic) — was this tensor "
            "produced by pack_blocks?")
    at = len(_MAGIC)
    if len(raw) < at + 4:
        raise MigrateFormatError("kvtier payload truncated (no header)")
    hlen = int.from_bytes(raw[at:at + 4], "big")
    at += 4
    try:
        head = json.loads(raw[at:at + hlen].decode())
        n_tok = int(head["n_tokens"])
        block_len = int(head["block_len"])
    except (ValueError, UnicodeDecodeError, KeyError, TypeError):
        raise MigrateFormatError("kvtier header is not valid JSON") from None
    at += hlen
    body = memoryview(raw)
    if at + n_tok * 4 > len(body):
        raise MigrateFormatError("kvtier payload truncated (tokens)")
    tokens = np.frombuffer(body[at:at + n_tok * 4], np.int32).copy()
    at += n_tok * 4
    leaves = {}
    for name in sorted(head.get("leaves", {})):
        spec = head["leaves"][name]
        n = int(spec["bytes"])
        if at + n > len(body):
            raise MigrateFormatError(
                f"kvtier payload truncated (leaf {name})")
        shape = tuple(spec["shape"])
        count = int(np.prod(shape)) if shape else 1
        wire = np.frombuffer(body[at:at + n], np.uint8)
        if spec.get("enc") == "nibble":
            arr = torch.from_numpy(_unpack_nibbles(wire, count).reshape(shape))
        else:
            dt = _TORCH.get(spec["dtype"])
            if dt is None:
                raise MigrateFormatError(
                    f"kvtier payload names unknown dtype {spec['dtype']!r}")
            flat = torch.from_numpy(wire.copy())
            try:
                arr = flat.view(dt).reshape(shape)
            except RuntimeError:
                raise MigrateFormatError(
                    f"kvtier leaf {name} bytes do not match shape {shape} "
                    f"dtype {spec['dtype']}") from None
        leaves[name] = arr
        at += n
    lr_shape = tuple(head.get("logit_shape") or (0, 0))
    lr_count = int(np.prod(lr_shape)) if lr_shape else 0
    lr_arr = np.frombuffer(body[at:at + lr_count * 4], np.float32)
    if lr_arr.size != lr_count:
        raise MigrateFormatError("kvtier payload truncated (logits)")
    lr_arr = lr_arr.reshape(lr_shape) if lr_count else lr_arr
    logit_rows = {int(i): torch.from_numpy(lr_arr[j].copy())
                  for j, i in enumerate(head.get("logit_idx", []))}
    return {"tokens": tokens, "block_len": block_len, "leaves": leaves,
            "logit_rows": logit_rows,
            "fingerprint": head.get("fingerprint") or {}}


# ----------------------------------------------------------------------
# shm rung: a same-host transfer without serialization

# segment names THIS process created (publish_shm): attach_shm must not
# deregister those from the resource tracker — the creator's own unlink
# still needs the registration (an in-process attach: tests)
_OWN_SHM_NAMES: set = set()


def publish_shm(data: bytes) -> Optional[Tuple[str, str, object]]:
    """Stage `data` in a fresh POSIX shm segment whose first _NONCE_BYTES
    hold a random nonce the adopter must check (its proof that it
    attached THE offered segment). Returns (name, nonce hex, segment), or
    None when this platform has no shm."""
    try:
        from multiprocessing import shared_memory
    except ImportError:  # pragma: no cover — a platform without shm
        return None
    nonce = secrets.token_bytes(_NONCE_BYTES)
    try:
        seg = shared_memory.SharedMemory(create=True,
                                         size=_NONCE_BYTES + len(data))
        seg.buf[:_NONCE_BYTES] = nonce
        seg.buf[_NONCE_BYTES:_NONCE_BYTES + len(data)] = data
    except OSError:  # pragma: no cover — /dev/shm full or missing
        return None
    _OWN_SHM_NAMES.add(seg.name)
    return seg.name, nonce.hex(), seg


def attach_shm(name: str, nonce_hex: str, nbytes: int) -> bytes:
    """The adopter's copy out of the donor's segment. Checks the nonce
    before it reads a byte of payload; any failure raises (the caller
    falls back to the grpc fetch rung)."""
    from multiprocessing import shared_memory

    seg = shared_memory.SharedMemory(name=name)
    if name not in _OWN_SHM_NAMES:
        # CPython registers an ATTACHED segment with its resource tracker
        # as if it owned it; the donor owns and unlinks this one
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(seg._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker internals vary by
            pass           # version; the worst case is a shutdown warning
    try:
        if bytes(seg.buf[:_NONCE_BYTES]).hex() != nonce_hex:
            raise ValueError(f"shm segment {name} nonce mismatch — not the "
                             "offered lease")
        return bytes(seg.buf[_NONCE_BYTES:_NONCE_BYTES + nbytes])
    finally:
        seg.close()


# ----------------------------------------------------------------------
# the lease state machine (donor side)

class Lease:
    """One staged export; its state moves only along TRANSITIONS."""

    def __init__(self, lease_id: str, data: bytes, ttl_s: float):
        self.lease_id = lease_id
        self.data: Optional[bytes] = data
        self.nbytes = len(data)
        self.ttl_s = float(ttl_s)
        self.t_offer = time.monotonic()
        self.shm_name: Optional[str] = None
        self.shm_nonce: Optional[str] = None
        self._seg = None
        self.state = "offered"

    def move(self, event: str):
        """Take `event`'s edge out of the current state (ValueError when
        the table has none)."""
        nxt = _NEXT.get((self.state, event))
        if nxt is None:
            raise ValueError(f"lease {self.lease_id}: no {event!r} edge out "
                             f"of state {self.state!r}")
        self.state = nxt

    def _free(self):
        self.data = None
        if self._seg is not None:
            try:
                self._seg.close()
                self._seg.unlink()
            except OSError:  # pragma: no cover — already gone
                pass
            self._seg = None


class LeaseTable:
    """Donor-side staging: offers carry a TTL, so an adopter that dies
    mid-pull never pins staged payloads (or their shm segments) for good.
    Thread-safe: gRPC handlers offer, fetch and ack; the worker's
    housekeeping sweeps."""

    def __init__(self, *, ttl_s: float = DEFAULT_LEASE_TTL_S,
                 use_shm: bool = True):
        self.ttl_s = float(ttl_s)
        self.use_shm = bool(use_shm)
        self._leases: Dict[str, Lease] = {}
        self._lock = threading.Lock()
        self._seq = 0

    def offer(self, data: bytes, *, ttl_s: Optional[float] = None) -> dict:
        """Stage `data`; returns the offer meta the adopter needs: {lease,
        bytes, shm?, nonce?}. Publishes a shm segment where the platform
        has one."""
        with self._lock:
            self._seq += 1
            lease_id = f"L{os.getpid()}_{self._seq}"
            lease = Lease(lease_id, data, ttl_s or self.ttl_s)
            if self.use_shm:
                pub = publish_shm(data)
                if pub is not None:
                    lease.shm_name, lease.shm_nonce, lease._seg = pub
            self._leases[lease_id] = lease
            # bounded: the oldest offer past MAX_LEASES expires now
            while len(self._leases) > MAX_LEASES:
                self._expire(min(self._leases.values(),
                                 key=lambda x: x.t_offer))
        meta = {"lease": lease_id, "bytes": lease.nbytes}
        if lease.shm_name:
            meta["shm"] = lease.shm_name
            meta["nonce"] = lease.shm_nonce
        return meta

    def fetch(self, lease_id: str) -> bytes:
        """The grpc rung: the staged bytes; offered -> pulling. KeyError
        for an unknown or expired lease (the adopter prefills again)."""
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.data is None:
                raise KeyError(lease_id)
            if lease.state == "offered":
                lease.move("lease_pull")
                obs.flight.record("lease_pull", lease=lease_id,
                                  bytes=lease.nbytes)
            return lease.data

    def ack(self, lease_id: str) -> bool:
        """The adopter confirmed its ingest: -> adopted, and the donor
        frees the staging at once (-> released). False for an unknown or
        expired lease (the ack raced the sweep: harmless, the adopter
        holds its blocks)."""
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None or lease.state in ("expired", "released"):
                return False
            lease.move("lease_adopt")
            obs.flight.record("lease_adopt", lease=lease_id)
            lease._free()
            lease.move("lease_release")
            obs.flight.record("lease_release", lease=lease_id)
            return True

    def _expire(self, lease: Lease):
        # under _lock: expired, then reclaimed at once
        lease.move("lease_expire")
        obs.flight.record("lease_expire", lease=lease.lease_id,
                          bytes=lease.nbytes,
                          age_s=round(time.monotonic() - lease.t_offer, 2),
                          cause="lease_reclaim")
        lease._free()
        lease.move("lease_reclaim")
        obs.flight.record("lease_reclaim", lease=lease.lease_id,
                          cause="lease_reclaim")
        self._leases.pop(lease.lease_id, None)

    def sweep(self, now: Optional[float] = None) -> int:
        """Expire offers past their TTL; returns how many."""
        now = time.monotonic() if now is None else now
        n = 0
        with self._lock:
            for lease in list(self._leases.values()):
                if lease.state in ("offered", "pulling") \
                        and now - lease.t_offer > lease.ttl_s:
                    self._expire(lease)
                    n += 1
        return n

    def state(self, lease_id: str) -> Optional[str]:
        """A live lease's state, or None once it left the table."""
        lease = self._leases.get(lease_id)
        return None if lease is None else lease.state

    @property
    def n_leases(self) -> int:
        return len(self._leases)

    def close(self):
        with self._lock:
            for lease in list(self._leases.values()):
                self._expire(lease)


# ----------------------------------------------------------------------
# the adopter's pull (rungs: shm, then grpc)

def pull_blocks(client, tokens, *, timeout: float = 30.0,
                shm: bool = True) -> Dict:
    """Pull a prefix's blocks from a donor through `client` (a
    comm/client.NodeClient pointed at the donor): lease the export, move
    the bytes over the best rung that proves itself (shm when the nonce
    checks out, else the grpc fetch; `shm=False` goes straight to the
    grpc rung), ack, unpack. The payload's "_wire_bytes" is the bytes
    moved and "_rung" the rung that moved them. Raises on any failure —
    the caller falls back to a prefill; this function never fabricates
    blocks."""
    meta = client.kv_lease(tokens, timeout=timeout)
    lease_id = meta["lease"]
    data, rung = None, "grpc"
    if shm and meta.get("shm"):
        try:
            data = attach_shm(meta["shm"], meta.get("nonce", ""),
                              int(meta["bytes"]))
            rung = "shm"
        except Exception as e:  # noqa: BLE001 — cross-host, stale segment
            # or a nonce mismatch: the grpc rung below, loud
            obs.flight.record("kvtier_shm_fallback",
                              error=f"{type(e).__name__}: {e}"[:160])
            data = None
    if data is None:
        data = client.kv_fetch(lease_id, timeout=timeout).tobytes()
    payload = unpack_blocks(np.frombuffer(data, np.uint8))
    payload["_wire_bytes"] = len(data)
    payload["_rung"] = rung
    try:
        client.kv_ack(lease_id, timeout=min(timeout, 5.0))
    except Exception:  # noqa: BLE001 — best effort: the donor's TTL sweep
        pass           # reclaims an unacked lease; the blocks are ours
    return payload
