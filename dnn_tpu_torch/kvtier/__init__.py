"""The radix prefix store of the paged pool (port of dnn_tpu/kvtier's
radix.py and store.py).

  * `radix.py` — a trie over block_len token chunks, one node per pool
    block, leaf-LRU eviction; pure host Python;
  * `store.py` — PrefixStore: the trie bound to the paged pool's
    BlockAllocator (runtime/paged_kvcache.py), holding one reference per
    resident block. The batcher (`ContinuousBatcher(kv="paged",
    prefix_cache=N)`) consults it at admission: the longest prefix match
    returns a run of shared blocks, and a prompt that leaves the cached
    text mid-block copies only the boundary block.

Block migration between replicas is `migrate.py`. Of the JAX package's
kvtier only the router's prefix directory (directory.py) is left to
port (ROADMAP Queue 1 item 11).
"""

from dnn_tpu_torch.kvtier.radix import RadixIndex, RadixNode  # noqa: F401
from dnn_tpu_torch.kvtier.store import PrefixHit, PrefixStore  # noqa: F401

__all__ = ["RadixIndex", "RadixNode", "PrefixStore", "PrefixHit"]
