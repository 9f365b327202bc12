"""Radix index: a trie over block_len-aligned token-id chunks (port of
dnn_tpu/kvtier/radix.py).

  * one node per KV pool block — `node.block` is the physical block id
    holding the K/V of this node's block_len positions; the token path
    from the root to the node is the prefix those positions encode;
  * the longest prefix match walks full chunks (`match`), then reports
    how many tokens of the next (possibly partial) chunk agree with an
    existing child — the copy-on-write boundary: the batcher copies that
    one block and resumes the prefill mid-block;
  * eviction is leaf-LRU (`evict_lru_leaf`): only leaves are evictable
    (an interior node's block is attended through every descendant's
    prefix), least recently matched first. Reference counts live in the
    pool's BlockAllocator: evicting a node drops only the store's
    reference, so blocks that live decode slots share survive until they
    retire.

Pure host Python: the index maps token bytes to block ids and never
touches device memory. All mutations happen on the pool's one worker
thread; readers only load counters (`n_nodes`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["RadixIndex", "RadixNode", "chunk_key"]


def chunk_key(tokens: np.ndarray) -> bytes:
    """The trie edge key for one block_len token chunk — raw int32
    bytes (the dense pool's LRU keys use the same spelling)."""
    return np.ascontiguousarray(tokens, dtype=np.int32).tobytes()


class RadixNode:
    """One resident block: `chunk` (the block_len token ids), `block`
    (the physical pool block id the store holds one reference on),
    `children` keyed by the next chunk's bytes, `logit_row` (the
    model's logits AFTER this node's last token, when the insert had
    them — what lets an exactly-block-aligned full-prompt hit sample
    its first token without running a single chunk), and `origin`
    ("local" = prefilled here, "adopted" = migrated in from a sibling
    replica; block migration is not ported, so the port's nodes are
    local unless a caller says otherwise)."""

    __slots__ = ("chunk", "block", "children", "parent", "logit_row",
                 "origin", "lru", "obskey")

    def __init__(self, chunk: np.ndarray, block: int,
                 parent: "Optional[RadixNode]", *, origin: str = "local"):
        self.chunk = np.ascontiguousarray(chunk, dtype=np.int32)
        self.block = int(block)
        self.children: Dict[bytes, RadixNode] = {}
        self.parent = parent
        self.logit_row = None
        self.origin = origin
        self.lru = 0
        # path digest stamped by obs/kvlens.py at insert time: evicted
        # nodes are detached, so the key the thrash detector needs is
        # captured while the path is still walkable; None when no lens
        # is attached
        self.obskey = None

    @property
    def depth(self) -> int:
        n, d = self, 0
        while n.parent is not None:
            n, d = n.parent, d + 1
        return d

    def __repr__(self):  # pragma: no cover — debugging aid
        return (f"RadixNode(block={self.block}, depth={self.depth}, "
                f"origin={self.origin}, leaf={not self.children})")


class RadixIndex:
    """The trie. `capacity` bounds RESIDENT NODES (= resident blocks;
    the `prefix_cache=N` constructor knob); `insert` evicts LRU leaves
    to stay inside it, `match` never allocates."""

    def __init__(self, block_len: int, capacity: int):
        if block_len < 1:
            raise ValueError(f"block_len must be >= 1, got {block_len}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.block_len = int(block_len)
        self.capacity = int(capacity)
        # sentinel root: no chunk, no block — never evicted, never
        # counted
        self.root = RadixNode(np.zeros((0,), np.int32), -1, None)
        self._nodes: List[RadixNode] = []
        self._tick = 0
        self._park = 0  # decreasing: newly INSERTED nodes park at the
        # LRU end, newest-first — only a MATCH promotes. A burst of
        # novel prompts then cycles its own one-shot nodes through the
        # eviction slot instead of unraveling the hot shared-prefix
        # path (the dense LRU's scan-resistant insertion)

    @property
    def n_nodes(self) -> int:
        return len(self._nodes)

    def _touch(self, node: RadixNode):
        self._tick += 1
        node.lru = self._tick

    # -- lookup --------------------------------------------------------

    def match(self, tokens: np.ndarray
              ) -> Tuple[List[RadixNode], int, Optional[RadixNode]]:
        """Longest-prefix match of `tokens` against the trie.

        Returns (matched_nodes, boundary_tokens, boundary_node):
        `matched_nodes` are the FULL-chunk matches in path order (their
        `.block` ids are the shared run); `boundary_node` is the child
        of the last match whose chunk agrees with the next, possibly
        partial, chunk of `tokens` on `boundary_tokens` > 0 leading
        tokens — the copy-on-write candidate. Matching touches the LRU
        clock on every node on the path (and the boundary)."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        bp = self.block_len
        node = self.root
        matched: List[RadixNode] = []
        at = 0
        while at + bp <= tokens.size:
            child = node.children.get(chunk_key(tokens[at:at + bp]))
            if child is None:
                break
            matched.append(child)
            self._touch(child)
            node = child
            at += bp
        # boundary: the longest leading agreement between the REMAINING
        # tokens and any child chunk (ties broken by most tokens, then
        # most recently used — deterministic given the LRU history)
        tail = tokens[at:at + bp]
        best: Optional[RadixNode] = None
        best_n = 0
        if tail.size:
            for child in node.children.values():
                n = int(np.argmin(
                    np.concatenate([
                        child.chunk[:tail.size] == tail, [False]])))
                if n > best_n or (n == best_n and n > 0 and best is not
                                  None and child.lru > best.lru):
                    best, best_n = child, n
        if best is not None:
            self._touch(best)
        return matched, best_n, best

    # -- insert / evict ------------------------------------------------

    def insert(self, tokens: np.ndarray, blocks: List[int], *,
               logit_rows: Optional[dict] = None,
               origin: str = "local"
               ) -> Tuple[List[RadixNode], List[RadixNode]]:
        """Insert the full-chunk path for `tokens` (block-aligned; the
        ragged tail is ignored) mapped onto physical `blocks` (one per
        full chunk, path order). Existing nodes are reused — their
        blocks stay as-is and the corresponding entry of `blocks` is
        simply not referenced (the caller keeps ownership of it).

        `logit_rows` maps chunk INDEX (0-based along this path) -> the
        logits row after that chunk's last token; attached to the node
        (existing nodes only gain a row they lacked — a row is a pure
        function of the prefix, so overwriting is a no-op by value).

        `origin` is one provenance for every created node, or a
        per-chunk sequence (short sequences pad "local") — a re-insert
        of a path whose ADOPTED nodes were evicted under pressure must
        not launder them into local-origin blocks, or the
        cross-replica hit accounting decays with cache churn.

        Returns (created_nodes, evicted_nodes): the caller must take
        one allocator reference per created node's block and release
        one per evicted node's block (the store does both)."""
        tokens = np.ascontiguousarray(tokens, dtype=np.int32)
        bp = self.block_len
        n_full = tokens.size // bp
        if len(blocks) < n_full:
            raise ValueError(
                f"insert covers {n_full} full chunks but only "
                f"{len(blocks)} blocks were supplied")
        if isinstance(origin, str):
            def origin_at(_i):
                return origin
        else:
            origins = list(origin)

            def origin_at(i):
                return origins[i] if i < len(origins) else "local"
        created: List[RadixNode] = []
        evicted: List[RadixNode] = []
        node = self.root
        for i in range(n_full):
            chunk = tokens[i * bp:(i + 1) * bp]
            key = chunk_key(chunk)
            child = node.children.get(key)
            if child is None:
                while self.n_nodes >= self.capacity:
                    victim = self.evict_lru_leaf(protect=node)
                    if victim is None:
                        # nothing evictable (every leaf is on the path
                        # being built): stop extending — the prefix we
                        # DID insert is still valid
                        return created, evicted
                    evicted.append(victim)
                child = RadixNode(chunk, blocks[i], node,
                                  origin=origin_at(i))
                # scan-resistant: park below every matched node (the
                # newest park evicts first); promotion is match()'s job
                self._park -= 1
                child.lru = self._park
                node.children[key] = child
                self._nodes.append(child)
                created.append(child)
            if logit_rows and i in logit_rows \
                    and child.logit_row is None:
                child.logit_row = logit_rows[i]
            node = child
        return created, evicted

    def evict_lru_leaf(self, protect: Optional[RadixNode] = None
                       ) -> Optional[RadixNode]:
        """Detach and return the least-recently-matched LEAF (interior
        nodes are load-bearing for every descendant's prefix). `protect`
        (and its ancestors) are exempt — the path an in-progress insert
        is extending must not be evicted under it. Returns None when
        nothing is evictable. The caller releases the store's allocator
        reference on the returned node's block.

        Cost note: O(resident nodes) per eviction (one linear scan +
        a list remove). At the capacities this repo serves (tens to a
        few thousand blocks) the scan is microseconds on the worker
        thread; a make-room burst evicting hundreds of leaves in one
        admission is the pathological corner — if profiles ever show
        it, the fix is an ordered leaf index maintained on park/touch,
        not a bigger scan."""
        protected = set()
        n = protect
        while n is not None:
            protected.add(id(n))
            n = n.parent
        victim: Optional[RadixNode] = None
        for node in self._nodes:
            if node.children or id(node) in protected:
                continue
            if victim is None or node.lru < victim.lru:
                victim = node
        if victim is None:
            return None
        self._nodes.remove(victim)
        parent = victim.parent
        if parent is not None:
            parent.children.pop(chunk_key(victim.chunk), None)
        victim.parent = None
        return victim

    def walk(self):
        """Every resident node (unordered) — gauges and tests."""
        return list(self._nodes)
