"""Paged KV cache: a shared block pool plus per-slot block tables (port
of dnn_tpu/runtime/paged_kvcache.py:59-363).

Layout (per K and per V):

    pool   (L, n_blocks, H, block_len, D)   f32, bf16 or int8; H is the
                                            model's KV heads
    scales (L, n_blocks, H, block_len)      f32, int8 pools only ("ks"/"vs")
    tables (B, nb_max)                      int32

The JAX layout replicates the tables over L so its layer scan can peel
them beside the pool; the port loops over layers in Python and keeps
one table. Block 0 is the reserved junk block: unowned table entries
point at it, gated decode writes and unowned install targets land on
it, and it is never attended live (the position mask stops at each
slot's length). All pool updates are in place.

Decode attention (`attend_rows`) runs the K7 paged-decode wrapper: the
CUDA kernel chases each slot's table straight into the pool on the card,
the plain gather-view version on the CPU. An int8 pool quantizes each
written row (kvcache._quantize_rows) and passes its scale blocks to K7;
its attention output is f32, a float pool's the pool dtype (the JAX
codec's output dtypes).

A windowed pool (`PagedKV(window=W)`, Mistral-class sliding windows;
JAX :181-330) adds the band's lower bound to every decode row: K7 skips
the blocks wholly before the band without reading them, which is what
lets the batcher reclaim those blocks while a request still runs
(serving.ContinuousBatcher._free_rolled_blocks) and point their table
entries at the junk block. Band only: softcapped and alternating-window
families never reach a paged pool.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import torch

from dnn_tpu_torch.ops.cuda.cached_attention import paged_decode_attention
from dnn_tpu_torch.runtime.kvcache import _quantize_rows, cache_shape

__all__ = ["PagedKV", "BlockAllocator", "InsufficientBlocks",
           "init_paged_cache"]


class InsufficientBlocks(RuntimeError):
    """The pool cannot satisfy an admission right now — TRANSIENT
    (blocks free as running requests retire), unlike the permanent
    never-fits error: the LM daemon's worker holds such a request back
    instead of failing it."""


class BlockAllocator:
    """Host-side free list over pool block ids, with reference counts
    and a high-water mark. Block 0 is reserved (the junk target)."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(1, n_blocks))
        self._rc: dict = {}
        self.high_water = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """Blocks currently held; n_used + n_free == n_blocks - 1."""
        return self.n_blocks - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh block ids at refcount 1, or None when the pool can't
        satisfy the request."""
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        for b in taken:
            self._rc[b] = 1
        self.high_water = max(self.high_water, self.n_used)
        return taken

    def ref(self, blocks: List[int]):
        """One more reference on live blocks; validates the whole list
        before changing anything."""
        for b in blocks:
            if self._rc.get(b, 0) < 1:
                raise ValueError(f"ref on non-live block {b}")
        for b in blocks:
            self._rc[b] += 1

    def free(self, blocks: List[int]):
        """Drop one reference per listed occurrence; a block whose last
        reference goes returns to the free list. Validates the whole
        list first, so a bad id never leaves the allocator half-freed."""
        counts = Counter(blocks)
        for b, n in counts.items():
            if b == 0 or b >= self.n_blocks or self._rc.get(b, 0) < n:
                raise ValueError(f"free of non-live block {b}")
        for b, n in counts.items():
            rc = self._rc[b] - n
            if rc == 0:
                del self._rc[b]
                self._free.append(b)
            else:
                self._rc[b] = rc


def init_paged_cache(cfg, slots: int, max_len: int, *, n_blocks: int,
                     block_len: int, dtype, device):
    """Pool + table for `slots` decode rows of up to `max_len` positions
    sharing `n_blocks` physical blocks of `block_len` positions. `dtype`
    is torch.float32, torch.bfloat16 or "int8" (int8 K/V blocks plus
    (L, n_blocks, H, block_len) f32 scale blocks initialised to ones).
    H and D are the dense cache's (`kvcache.cache_shape`): a grouped-query
    family stores its KV heads, as JAX's init_paged_cache(kv_heads=)."""
    if max_len % block_len:
        raise ValueError(f"max_len {max_len} must tile block_len {block_len}")
    shape = cache_shape(cfg, n_blocks, block_len)
    tables = torch.zeros((slots, max_len // block_len), dtype=torch.int32,
                         device=device)
    if dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "ks": torch.ones(shape[:-1], dtype=torch.float32, device=device),
            "vs": torch.ones(shape[:-1], dtype=torch.float32, device=device),
            "tables": tables,
        }
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"paged pool dtype {dtype!r}: the port has f32, bf16 and int8 "
            "pools (int4 waits for ROADMAP PyTorch/CUDA port item 2)")
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "tables": tables}


class PagedKV:
    """Codec over the block pool. `write_rows`/`attend_rows` take one
    layer's view — {"k","v"} (n_blocks, H, bp, D), int8 pools' {"ks",
    "vs"} (n_blocks, H, bp), and the shared "tables" (B, nb_max);
    `install_row` takes the whole cache."""

    def __init__(self, block_len: int, window: Optional[int] = None):
        self.block_len = block_len
        self.window = window

    def write_rows(self, c, k, v, pos, write_gate):
        """k/v (B, H, 1, D) land at each slot's position pos (B,):
        physical block tables[b, pos // bp], row pos % bp. Gated-off
        slots are ROUTED TO the junk block (0, row 0) rather than
        restored in place: a retired slot's stale table may point at a
        block since reallocated to another request, and restoring it
        would write the old request's K/V into the new owner's cache.
        Collisions between gated slots on the junk block are harmless.
        An int8 pool quantizes the rows first and scatters their scales
        alongside."""
        bp = self.block_len
        slot = torch.arange(pos.shape[0], device=pos.device)
        live_pos = torch.where(write_gate, pos, 0).long()
        blk = c["tables"][slot, live_pos // bp].long()
        blk = torch.where(write_gate, blk, 0)
        row = torch.where(write_gate, live_pos % bp, 0)
        if "ks" in c:
            kq, ks = _quantize_rows(k[:, :, 0])  # (B, H, D), (B, H)
            vq, vs = _quantize_rows(v[:, :, 0])
            new = {"k": kq, "v": vq, "ks": ks, "vs": vs}
        else:
            new = {"k": k[:, :, 0], "v": v[:, :, 0]}
        for name, val in new.items():
            c[name][blk, :, row] = val.to(c[name].dtype)

    def attend_rows(self, q, c, pos, window=None):
        """q (B, H, R, D), R rows a pool head (a GQA config's folded
        query group); every row of slot b attends its logical positions
        <= pos[b], and > pos[b] - window for a windowed pool. Returns (B,
        H, R, D): q's type for an int8 pool, the pool dtype for a float
        one. A per-call `window` (the dense codecs' per-layer channel)
        raises, as JAX's: alternating-window families never get here."""
        if window is not None:
            raise ValueError(
                "PagedKV has no per-layer window channel (alt-window "
                "families are rejected for paged pools); set the codec's "
                "window at construction")
        if "ks" in c:
            return paged_decode_attention(q.contiguous(), c["k"], c["v"],
                                          c["tables"], pos, ks=c["ks"],
                                          vs=c["vs"], window=self.window)
        out = paged_decode_attention(q.contiguous(), c["k"], c["v"],
                                     c["tables"], pos, window=self.window)
        return out.to(c["v"].dtype)

    def gather_row(self, cache, row, blk_ids):
        """Rebuild a transient row cache from pool blocks, in place (JAX's
        serving gather_row): the first nb_max * block_len positions of
        every leaf of `row` ((L, 1, H, row_len[, D]), K/V and int8 scales
        alike) take the blocks `blk_ids` (nb_max,) in order. The radix
        prefix hit's resume: later chunks attend the shared prefix
        through this row; positions past it are overwritten by those
        chunks before anything attends them."""
        idx = blk_ids.long()
        for kk, leaf in cache.items():
            if kk == "tables":
                continue
            g = leaf[:, idx]  # (L, nb_max, H, bp[, D])
            n_l, nb, h, bl = g.shape[:4]
            row[kk][:, 0, :, :nb * bl] = g.transpose(1, 2).reshape(
                n_l, h, nb * bl, *g.shape[4:])

    @staticmethod
    def read_block(cache, block: int) -> dict:
        """One physical block's leaves {name: (L, H, bp[, D])} — K/V and,
        on an int8 pool, the scales — as views of the pool (JAX's
        kv_get_block); a block migration's export copies them off the
        card."""
        return {kk: leaf[:, block] for kk, leaf in cache.items()
                if kk != "tables"}

    @staticmethod
    def write_block(cache, vals: dict, dst: int):
        """Store one migrated block's leaves `vals` {name: (L, H, bp[,
        D])} at physical block `dst`, IN PLACE (JAX's kv_put_block
        rebinds the pool; a captured step reads the pool's fixed
        addresses, so the port writes into them)."""
        for kk, leaf in cache.items():
            if kk != "tables":
                leaf[:, dst].copy_(vals[kk])

    @staticmethod
    def copy_block(cache, src: int, dst: int):
        """The copy-on-write of one physical block: every leaf's block
        `src` (K/V and, on an int8 pool, the scales) copied to `dst`, in
        place (JAX's cow_copy)."""
        for kk, leaf in cache.items():
            if kk != "tables":
                leaf[:, dst] = leaf[:, src]

    def install_row(self, cache, row, blk_ids):
        """Scatter a finished transient row cache (leaves (L, 1, H,
        row_len[, D]) — K/V and int8 scales alike) into the physical
        blocks `blk_ids` (nb_max,). ALL nb_max logical blocks install
        unconditionally: entries the request does not own — past its
        length, and the shared prefix blocks of a radix hit, which other
        requests attend — are routed to junk block 0 by the caller
        (duplicate targets there, never on a live block), so one code
        path serves every prompt length."""
        bp = self.block_len
        nb_max = blk_ids.shape[0]
        idx = blk_ids.long()
        for kk, leaf in cache.items():
            if kk == "tables":
                continue
            r = row[kk][:, 0]  # (L, H, row_len[, D])
            n_l, h, rl = r.shape[:3]
            blocks = r.reshape(n_l, h, rl // bp, bp, *r.shape[3:])[:, :, :nb_max]
            leaf[:, idx] = blocks.transpose(1, 2).to(leaf.dtype)
