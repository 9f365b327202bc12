"""PrefixStore: the radix index bound to the paged BlockAllocator (port
of dnn_tpu/kvtier/store.py).

Ownership: the store holds EXACTLY ONE allocator reference per resident
node's block — taken at insert, released at eviction. Live decode slots
hold their own references (the batcher's admission refs shared blocks
before it allocates the tail), so evicting an entry whose blocks a slot
still shares frees nothing until the slot retires: eviction is leaf-LRU
under refcount protection, with the counts kept by
runtime/paged_kvcache.BlockAllocator.

The store is a host index and never touches device memory. The batcher
(runtime/serving.py) owns the device work — the gather of a hit's blocks
into the transient row, the one-block copy behind the copy-on-write
boundary, the install after a prefill — and calls `lookup` / `insert` /
`evict_one` from the pool's one worker thread, and block migration
(kvtier/migrate.py, the batcher's kvtier_export / kvtier_adopt /
stage_prefix) reads `nodes_for` and inserts adopted runs with origin
"adopted". Readers only load ints (`n_blocks`, the counters).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from dnn_tpu_torch.kvtier.radix import RadixIndex, RadixNode

__all__ = ["PrefixStore", "PrefixHit"]


@dataclasses.dataclass
class PrefixHit:
    """One admission lookup's answer.

    `shared` — physical block ids of the full-chunk matches, path
    order (the caller refs them before touching the allocator again);
    `origins` — each shared block's provenance ("local" | "adopted"),
    same order; `cow_src`/`cow_tokens`/`cow_origin` — the boundary
    block candidate: `cow_tokens` leading tokens of the next partial
    chunk agree with the cached block `cow_src`, so copying that ONE
    block lets prefill resume mid-block (0 = no boundary sharing);
    `logit_row` — the stored logits after the last shared token,
    present only when the prompt is exactly the shared run (the
    full-hit fast path: zero chunks run).

    Lookup itself counts NOTHING: the admission may truncate the run,
    hold the request back, or fail — the caller reports what it
    actually reused via `note_reuse`."""

    shared: List[int]
    origins: List[str]
    cow_src: int = -1
    cow_tokens: int = 0
    cow_origin: str = "local"
    logit_row: Optional[object] = None

    @property
    def n_shared(self) -> int:
        return len(self.shared)

    def remote_used(self, n_shared_used: int, cow_used: bool) -> int:
        """Adopted-origin blocks among the FIRST `n_shared_used`
        shared blocks (+ the COW boundary when used)."""
        n = sum(1 for o in self.origins[:n_shared_used]
                if o == "adopted")
        if cow_used and self.cow_origin == "adopted":
            n += 1
        return n


class PrefixStore:
    """See module docstring. `capacity` = resident blocks (the
    `prefix_cache=N` knob)."""

    def __init__(self, allocator, block_len: int, capacity: int):
        self.allocator = allocator
        self.block_len = int(block_len)
        self.index = RadixIndex(block_len, capacity)
        # counters (int loads for readers on other threads)
        self.block_hits = 0          # blocks reused across all lookups
        self.remote_block_hits = 0   # ... of adopted (migrated) origin
        self.evictions = 0
        # optional memory-economy observer (obs/kvlens.py), attached by
        # the batcher when the obs gate is on; every hook below is one
        # `is not None` test when absent
        self.lens = None

    @property
    def n_blocks(self) -> int:
        """Resident blocks (= nodes)."""
        return self.index.n_nodes

    def lookup(self, prompt: np.ndarray) -> PrefixHit:
        """Longest-prefix match for an arriving prompt (no counter
        side effects — `note_reuse` records what admission actually
        used)."""
        matched, cow_n, cow_node = self.index.match(prompt)
        if self.lens is not None:
            # admission demand only: nodes_for serves the export path,
            # not arriving traffic, and would skew the reuse sample
            self.lens.on_access(prompt, n_resident=len(matched))
        logit_row = None
        bp = self.block_len
        p = int(np.asarray(prompt).size)
        if matched and p == len(matched) * bp:
            logit_row = matched[-1].logit_row
        has_cow = cow_n > 0 and cow_node is not None
        return PrefixHit(
            shared=[n.block for n in matched],
            origins=[n.origin for n in matched],
            cow_src=cow_node.block if has_cow else -1,
            cow_tokens=cow_n if has_cow else 0,
            cow_origin=cow_node.origin if has_cow else "local",
            logit_row=logit_row)

    def note_reuse(self, n_blocks: int, n_remote: int,
                   cow: bool = False):
        """Admission succeeded reusing `n_blocks` resident blocks, of
        which `n_remote` were adopted from a sibling. `cow` marks that
        the reuse included the boundary copy-on-write block (the lens's
        lifecycle ledger; the counters are unchanged by it)."""
        self.block_hits += int(n_blocks)
        self.remote_block_hits += int(n_remote)
        if self.lens is not None:
            self.lens.on_share(int(n_blocks), int(n_remote), cow=cow)

    def insert(self, tokens: np.ndarray, blocks: List[int], *,
               logit_rows: Optional[dict] = None,
               origin="local") -> int:
        """Insert the full-chunk path for `tokens` over physical
        `blocks` (one per full chunk). The store refs every NEWLY
        resident block and frees every evicted one — the caller's own
        references are untouched (a live slot keeps its blocks).
        Returns the number of nodes created."""
        created, evicted = self.index.insert(
            tokens, blocks, logit_rows=logit_rows, origin=origin)
        if created:
            self.allocator.ref([n.block for n in created])
            if self.lens is not None:
                self.lens.on_insert(tokens, created, origin=origin)
        if evicted:
            self._release(evicted, cause="capacity")
        return len(created)

    def evict_one(self, cause: str = "capacity") -> bool:
        """Evict the LRU leaf (admission's make-room loop). False when
        nothing is evictable. `cause` attributes the eviction for the
        lens: "capacity" (pressure) or a housekeeping cause."""
        victim = self.index.evict_lru_leaf()
        if victim is None:
            return False
        self._release([victim], cause=cause)
        return True

    def nodes_for(self, tokens: np.ndarray) -> List[RadixNode]:
        """The matched full-block nodes of `tokens`, in path order (an
        export reads their blocks and logits rows)."""
        return self.index.match(tokens)[0]

    def _release(self, nodes: List[RadixNode], cause: str = "capacity"):
        self.allocator.free([n.block for n in nodes])
        self.evictions += len(nodes)
        if self.lens is not None:
            self.lens.on_evict(
                [getattr(n, "obskey", None) for n in nodes], cause=cause)

    def clear(self):
        """Release every resident block (teardown / tests)."""
        while self.evict_one(cause="clear"):
            pass
