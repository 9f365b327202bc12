"""kvlens: the memory-economy observatory for the radix KV tier (port
of dnn_tpu/obs/kvlens.py, copied: the same admission keys give a
bit-equal curve and summary in both packages; the port's batcher
attaches it to its radix store, runtime/serving.py).

The radix pool answers "what is resident"; nothing answered "what
WOULD be resident at a different size". When the pool fills, leaf-LRU
discards blocks and the only visible signal is the hit-ratio gauge at
the ONE capacity actually configured — useless for sizing a host tier
(ROADMAP item 4) or for an autoscaler deciding whether capacity, not
compute, is the scarce resource (item 3). This module is the sizing
oracle, three instruments in one object:

  1. **Sampled reuse-distance tracker.** Every admission lookup feeds
     the full-chunk keys of the arriving prompt through SHARDS-style
     spatial hash sampling: a chunk is tracked iff the low 64 bits of
     its deterministic blake2s path digest fall under `rate` (the
     chaos-planner idiom — zero wall-clock randomness, so the same
     trace + seed reproduces the same curve bit-for-bit). Tracked keys
     live in a bounded LRU stack; a re-access at stack depth d among
     sampled keys estimates a TRUE stack distance of d/rate distinct
     blocks — the classic SHARDS scaling.

  2. **Miss-ratio curves.** Each sampled re-access scores a hit at
     every hypothetical capacity its scaled distance fits under:
     0.5x/1x/2x/4x/8x of the configured pool. `curve()` is the
     predicted block-hit ratio vs capacity; exported as weak
     scrape-time gauges (`prom_gauges()`), as `/kvz` on the obs HTTP
     server (JSON | `?format=prom`), as `/fleetz` rollup columns, and
     via `python -m dnn_tpu_torch.obs kvlens [--url|PATH|--selftest]`.
     chip_smoke.py's [obs2] K leg proves the instrument against
     ground truth on the card: the curve's prediction for 2x the pool
     must land within 0.10 absolute of the ratio measured there.

  3. **Block-lifetime forensics + thrash detector.** A bounded
     per-block lifecycle ledger (its own FlightRecorder ring, so the
     process crash ring stays clean) records birth/share/COW/evict/
     migrate/refetch events with cause attribution. An evicted key
     re-inserted within `thrash_window_s` is a REFETCH — capacity
     churn that re-ran prefill for work the pool already held — priced
     in re-prefill chunk-seconds (an EMA fed by the serving prefill
     timer) and migrated bytes (adopted-origin refetches paid the
     wire again).

Overhead contract: every producer method opens with the obs gate
check (one boolean when DNN_TPU_OBS is off) and the hook sites in
kvtier/store.py guard with one `lens is not None` test; chip_smoke's
obs_overhead leg holds the step under its bound with the lens live.

Threading: producer methods run on the pool's single worker thread
(the PrefixStore contract); scrape-side readers (`curve`, `summary`,
`render_prom`, the gauge closures) only load ints/floats and copy
bounded structures, the same tolerance every serving gauge lives with.
"""

from __future__ import annotations

import hashlib
import time
import weakref
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

from dnn_tpu_torch.obs.flight import FlightRecorder
from dnn_tpu_torch.utils.metrics import labeled

__all__ = ["KVLens", "DEFAULT_MULTS", "DEFAULT_RATE"]

DEFAULT_MULTS = (0.5, 1.0, 2.0, 4.0, 8.0)
DEFAULT_RATE = 0.25

_obs = None  # lazy: breaks the obs<->kvlens import cycle (flight idiom)


def _enabled() -> bool:
    global _obs
    if _obs is None:
        from dnn_tpu_torch import obs as _o

        _obs = _o
    return _obs.enabled()


def _mult_label(m: float) -> str:
    return f"{m:g}x"


class KVLens:
    """One lens per PrefixStore. See module docstring."""

    def __init__(self, pool_blocks: int, block_len: int, *, seed: int = 0,
                 rate: float = DEFAULT_RATE,
                 mults: Sequence[float] = DEFAULT_MULTS,
                 thrash_window_s: float = 30.0,
                 ledger_cap: int = 512,
                 bytes_per_block: int = 0,
                 now=time.monotonic):
        if not (0.0 < rate <= 1.0):
            raise ValueError(f"rate must be in (0, 1], got {rate}")
        self.pool_blocks = int(pool_blocks)
        self.block_len = int(block_len)
        self.seed = int(seed)
        self.rate = float(rate)
        self.mults = tuple(float(m) for m in mults)
        self.thrash_window_s = float(thrash_window_s)
        self.bytes_per_block = int(bytes_per_block)
        self._now = now
        # the digest prefix pins the sample set to the seed: a different
        # seed picks a different (deterministic) 'rate' slice of keys
        self._prefix = f"kvlens:{self.seed}:".encode()
        # hypothetical capacities, in blocks, evaluated per re-access
        self._caps = [max(1, int(round(m * self.pool_blocks)))
                      for m in self.mults]
        # sampled-key LRU stack: only needs to resolve distances up to
        # the LARGEST evaluated capacity — beyond it every capacity
        # already scored a miss, so overflowed keys degrade to "cold"
        # (a miss everywhere), never to a wrong hit
        self._stack_cap = max(64, int(max(self._caps) * self.rate) + 16)
        self._stack: "OrderedDict[bytes, None]" = OrderedDict()
        # curve accumulators (ints only: scrape readers load atomically)
        self.accesses = 0            # full-chunk accesses, unsampled
        self.sampled = 0             # ... that fell under the hash rate
        self.sampled_cold = 0        # sampled first-touches (miss at all)
        self._hits = [0] * len(self._caps)   # per-capacity sampled hits
        self.stack_drops = 0         # keys aged past the bounded stack
        # exact measured tally at the REAL capacity (prediction's anchor)
        self.measured_accesses = 0
        self.measured_hits = 0
        # lifecycle counts + the bounded per-block ledger ring
        self.ledger = FlightRecorder(ledger_cap)
        self.births = 0
        self.shares = 0
        self.remote_shares = 0
        self.cows = 0
        self.migrations = 0
        self.migrated_bytes = 0
        self.evictions_by_cause: dict = {}
        # thrash detector: evicted key -> (monotonic ts, cause)
        self._evicted: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._evicted_cap = 4096
        self.refetch_blocks = 0
        self.thrash_chunk_seconds = 0.0
        self.thrash_migrated_bytes = 0
        self._chunk_s_ema: Optional[float] = None

    # -- keys ----------------------------------------------------------

    def chunk_keys(self, tokens, n_chunks: Optional[int] = None
                   ) -> List[bytes]:
        """Path digests for the full chunks of `tokens`: incremental
        blake2s over the int32 token bytes, one `.copy().digest()` per
        chunk boundary — O(len) total for the whole path, matching the
        radix trie's own `chunk_key` framing (prefix-closed: the key
        of chunk i commits to every token before it)."""
        arr = np.asarray(tokens).astype(np.int32, copy=False).ravel()
        bp = self.block_len
        n = arr.size // bp if n_chunks is None else min(
            int(n_chunks), arr.size // bp)
        if n <= 0:
            return []
        h = hashlib.blake2s(self._prefix, digest_size=16)
        out = []
        for i in range(n):
            h.update(arr[i * bp:(i + 1) * bp].tobytes())
            out.append(h.copy().digest())
        return out

    # -- producers (pool worker thread) --------------------------------

    def on_access(self, tokens, n_resident: int = 0):
        """One admission lookup: every full chunk of the prompt is one
        block access. `n_resident` = blocks the real store matched
        (the exact measured tally the curve is validated against)."""
        if not _enabled():
            return
        keys = self.chunk_keys(tokens)
        if not keys:
            return
        n = len(keys)
        self.accesses += n
        self.measured_accesses += n
        self.measured_hits += min(int(n_resident), n)
        rate = self.rate
        stack = self._stack
        for k in keys:
            if int.from_bytes(k[:8], "big") / 2.0 ** 64 >= rate:
                continue
            self.sampled += 1
            if k in stack:
                d = 0  # sampled keys more recent than k
                for kk in reversed(stack):
                    if kk == k:
                        break
                    d += 1
                scaled = d / rate
                for i, cap in enumerate(self._caps):
                    if scaled < cap:
                        self._hits[i] += 1
                stack.move_to_end(k)
            else:
                self.sampled_cold += 1
                stack[k] = None
                if len(stack) > self._stack_cap:
                    stack.popitem(last=False)
                    self.stack_drops += 1

    def on_insert(self, tokens, created, *, origin: str = "local",
                  now: Optional[float] = None):
        """Blocks became resident: stamp each created node's path
        digest (read back at evict time, after the trie detaches it),
        ledger a birth, and check the thrash window — a key evicted
        less than `thrash_window_s` ago is a REFETCH the pool's size
        forced us to re-prefill."""
        if not _enabled() or not created:
            return
        keys = self.chunk_keys(tokens)
        t = self._now() if now is None else now
        for node in created:
            depth = getattr(node, "depth", 0)
            key = keys[depth - 1] if 0 < depth <= len(keys) else None
            if key is not None:
                try:
                    node.obskey = key
                except AttributeError:
                    pass  # foreign node type: forensics degrade, counts hold
            self.births += 1
            self.ledger.record("birth", key=key.hex()[:12] if key else None,
                               depth=depth, origin=origin)
            if key is None:
                continue
            ev = self._evicted.pop(key, None)
            if ev is not None and t - ev[0] <= self.thrash_window_s:
                self.refetch_blocks += 1
                if self._chunk_s_ema is not None:
                    self.thrash_chunk_seconds += self._chunk_s_ema
                if origin == "adopted":
                    self.thrash_migrated_bytes += self.bytes_per_block
                self.ledger.record("refetch", key=key.hex()[:12],
                                   cause=ev[1], origin=origin,
                                   age_s=round(t - ev[0], 3))

    def on_evict(self, keys: Sequence[Optional[bytes]],
                 cause: str = "capacity", now: Optional[float] = None):
        """Blocks left residency. `keys` are the victims' stamped path
        digests (None for nodes born before the lens attached — the
        cause still counts, the refetch correlation is just lost)."""
        if not _enabled() or not keys:
            return
        t = self._now() if now is None else now
        self.evictions_by_cause[cause] = (
            self.evictions_by_cause.get(cause, 0) + len(keys))
        for key in keys:
            self.ledger.record(
                "evict", key=key.hex()[:12] if key else None, cause=cause)
            if key is None:
                continue
            self._evicted[key] = (t, cause)
            if len(self._evicted) > self._evicted_cap:
                self._evicted.popitem(last=False)

    def on_share(self, n_blocks: int, n_remote: int = 0,
                 cow: bool = False):
        """Admission actually reused `n_blocks` resident blocks (the
        note_reuse passthrough); `cow` marks a boundary copy-on-write
        alongside. One aggregate ledger event per admission, not per
        block — the ring stays bounded by admissions, not blocks."""
        if not _enabled() or (n_blocks <= 0 and not cow):
            return
        self.shares += max(0, int(n_blocks))
        self.remote_shares += max(0, int(n_remote))
        if cow:
            self.cows += 1
            self.ledger.record("cow", shared=int(n_blocks),
                               remote=int(n_remote))
        elif n_blocks > 0:
            self.ledger.record("share", shared=int(n_blocks),
                               remote=int(n_remote))

    def on_migrate(self, n_blocks: int, nbytes: int = 0):
        """Blocks adopted from a sibling replica over the wire."""
        if not _enabled() or n_blocks <= 0:
            return
        self.migrations += int(n_blocks)
        self.migrated_bytes += max(0, int(nbytes))
        self.ledger.record("migrate", blocks=int(n_blocks),
                           bytes=int(nbytes))

    def note_prefill(self, n_chunks: int, seconds: float):
        """Prefill cost signal: EMA of seconds per chunk, the price a
        refetch is billed at (re-prefill chunk-seconds)."""
        if not _enabled() or n_chunks <= 0 or seconds < 0:
            return
        per = float(seconds) / float(n_chunks)
        self._chunk_s_ema = per if self._chunk_s_ema is None else (
            0.2 * per + 0.8 * self._chunk_s_ema)

    # -- scrape side ---------------------------------------------------

    def predicted_hit_ratio(self, mult: float) -> Optional[float]:
        """Curve value at `mult` x pool (None until anything sampled)."""
        if self.sampled <= 0:
            return None
        for i, m in enumerate(self.mults):
            if m == mult:
                return self._hits[i] / self.sampled
        return None

    def curve(self) -> List[dict]:
        s = self.sampled
        return [{"mult": _mult_label(m),
                 "capacity_blocks": self._caps[i],
                 "predicted_hit_ratio":
                     (self._hits[i] / s) if s else None}
                for i, m in enumerate(self.mults)]

    def measured_hit_ratio(self) -> Optional[float]:
        if self.measured_accesses <= 0:
            return None
        return self.measured_hits / self.measured_accesses

    def thrash(self) -> dict:
        return {"window_s": self.thrash_window_s,
                "refetch_blocks": self.refetch_blocks,
                "chunk_seconds": round(self.thrash_chunk_seconds, 6),
                "migrated_bytes": self.thrash_migrated_bytes,
                "chunk_s_ema": self._chunk_s_ema}

    def summary(self) -> dict:
        """The /kvz JSON body."""
        return {
            "config": {"pool_blocks": self.pool_blocks,
                       "block_len": self.block_len,
                       "seed": self.seed, "rate": self.rate,
                       "mults": [_mult_label(m) for m in self.mults]},
            "samples": {"accesses": self.accesses,
                        "sampled": self.sampled,
                        "cold": self.sampled_cold,
                        "stack_len": len(self._stack),
                        "stack_cap": self._stack_cap,
                        "stack_drops": self.stack_drops},
            "curve": self.curve(),
            "measured": {"accesses": self.measured_accesses,
                         "hits": self.measured_hits,
                         "hit_ratio": self.measured_hit_ratio()},
            "lifecycle": {"births": self.births,
                          "shares": self.shares,
                          "remote_shares": self.remote_shares,
                          "cows": self.cows,
                          "migrations": self.migrations,
                          "migrated_bytes": self.migrated_bytes,
                          "evictions_by_cause":
                              dict(self.evictions_by_cause)},
            "thrash": self.thrash(),
            "ledger": self.ledger.events(last=64),
        }

    def render_prom(self) -> str:
        """Prometheus text for `/kvz?format=prom` (self-contained: the
        lens's own families, not the shared registry)."""
        lines = [
            "# HELP dnn_tpu_kvlens_pred_hit_ratio predicted block-hit "
            "ratio at a hypothetical pool capacity (SHARDS-sampled MRC)",
            "# TYPE dnn_tpu_kvlens_pred_hit_ratio gauge",
        ]
        s = self.sampled
        for i, m in enumerate(self.mults):
            v = (self._hits[i] / s) if s else 0.0
            lines.append(
                f'dnn_tpu_kvlens_pred_hit_ratio{{mult="{_mult_label(m)}"}}'
                f" {v:.6f}")
        mr = self.measured_hit_ratio()
        lines += [
            "# TYPE dnn_tpu_kvlens_measured_hit_ratio gauge",
            f"dnn_tpu_kvlens_measured_hit_ratio "
            f"{(mr if mr is not None else 0.0):.6f}",
            "# TYPE dnn_tpu_kvlens_accesses_total counter",
            f"dnn_tpu_kvlens_accesses_total {self.accesses}",
            "# TYPE dnn_tpu_kvlens_sampled_total counter",
            f"dnn_tpu_kvlens_sampled_total {self.sampled}",
            "# TYPE dnn_tpu_kvlens_thrash_refetch_blocks_total counter",
            f"dnn_tpu_kvlens_thrash_refetch_blocks_total "
            f"{self.refetch_blocks}",
            "# TYPE dnn_tpu_kvlens_thrash_chunk_seconds_total counter",
            f"dnn_tpu_kvlens_thrash_chunk_seconds_total "
            f"{self.thrash_chunk_seconds:.6f}",
            "# TYPE dnn_tpu_kvlens_thrash_migrated_bytes_total counter",
            f"dnn_tpu_kvlens_thrash_migrated_bytes_total "
            f"{self.thrash_migrated_bytes}",
            "# TYPE dnn_tpu_kvlens_evictions_total counter",
        ]
        for cause in sorted(self.evictions_by_cause):
            lines.append(
                f'dnn_tpu_kvlens_evictions_total{{cause="{cause}"}} '
                f"{self.evictions_by_cause[cause]}")
        return "\n".join(lines) + "\n"

    def prom_gauges(self) -> dict:
        """Weak scrape-time gauge closures for the serving registry
        (`_obs_gauges` idiom): the module-level metrics registry
        outlives any batcher, so the closures hold a weakref — a
        collected lens reads 0, never a dangling object."""
        ref = weakref.ref(self)

        def _g(fn):
            def read():
                lens = ref()
                if lens is None:
                    return 0.0
                v = fn(lens)
                return float(v) if v is not None else 0.0
            return read

        out = {}
        for m in self.mults:
            out[labeled("dnn_tpu_kvlens_pred_hit_ratio",
                        mult=_mult_label(m))] = _g(
                lambda lens, mm=m: lens.predicted_hit_ratio(mm))
        out["dnn_tpu_kvlens_measured_hit_ratio"] = _g(
            lambda lens: lens.measured_hit_ratio())
        out["dnn_tpu_kvlens_sampled_total"] = _g(
            lambda lens: lens.sampled)
        out["dnn_tpu_kvlens_thrash_refetch_blocks_total"] = _g(
            lambda lens: lens.refetch_blocks)
        out["dnn_tpu_kvlens_thrash_chunk_seconds_total"] = _g(
            lambda lens: lens.thrash_chunk_seconds)
        return out
