"""The port's radix prefix store (dnn_tpu_torch/kvtier) against the JAX
package's (dnn_tpu/kvtier) on the same operations: the same matches,
copy-on-write boundaries, eviction order, refcounts and hit accounting
(the scripts of tests/test_kvtier.py's radix and store suites, each a
case of one parametrised test run on both). Pure host Python: no model,
no device."""

import numpy as np
import pytest

from dnn_tpu.kvtier.radix import RadixIndex as JaxIndex
from dnn_tpu.kvtier.store import PrefixStore as JaxStore
from dnn_tpu_torch.kvtier import PrefixStore, RadixIndex
from dnn_tpu_torch.runtime.paged_kvcache import BlockAllocator

BP = 4  # block_len of the host suites


class FakeAllocator:
    """BlockAllocator-shaped double: refcount bookkeeping only."""

    def __init__(self):
        self.rc = {}

    def seed(self, blocks):
        for b in blocks:
            self.rc[b] = self.rc.get(b, 0) + 1

    def ref(self, blocks):
        for b in blocks:
            assert self.rc.get(b, 0) >= 1, f"ref on dead block {b}"
        for b in blocks:
            self.rc[b] += 1

    def free(self, blocks):
        for b in blocks:
            assert self.rc.get(b, 0) >= 1, f"free of dead block {b}"
        for b in blocks:
            self.rc[b] -= 1
            if self.rc[b] == 0:
                del self.rc[b]


def toks(*vals):
    return np.asarray(vals, np.int32)


def seq(n, start=1):
    return np.arange(start, start + n, dtype=np.int32)


def _match(ix, tokens):
    m, cow_n, cow = ix.match(tokens)
    return ([n.block for n in m], cow_n, None if cow is None else cow.block)


def _insert(ix, tokens, blocks):
    created, evicted = ix.insert(tokens, blocks)
    return ([n.block for n in created], sorted(n.block for n in evicted))


def _evict(ix):
    v = ix.evict_lru_leaf()
    return None if v is None else v.block


# each script: a list of (op, args) run against a fresh RadixIndex of
# the given capacity; every op's result is recorded
INDEX_SCRIPTS = {
    "insert-lookup-golden": (16, [
        ("insert", (seq(12), [10, 11, 12])), ("match", (seq(12),)),
        ("match", (seq(8),)), ("match", (seq(10),)),
        ("match", (np.concatenate([seq(8), toks(99, 98)]),))]),
    "cow-longest-agreement": (16, [
        ("insert", (np.concatenate([seq(4), toks(5, 6, 90, 91)]), [1, 2])),
        ("insert", (np.concatenate([seq(4), toks(5, 6, 7, 92)]), [1, 3])),
        ("match", (np.concatenate([seq(4), toks(5, 6, 7, 8)]),))]),
    "reuses-existing-nodes": (16, [
        ("insert", (seq(8), [1, 2])), ("insert", (seq(12), [91, 92, 3])),
        ("match", (seq(12),))]),
    "leaf-lru-scan-resistant": (16, [
        ("insert", (seq(4, start=1), [1])),
        ("insert", (seq(4, start=100), [2])),
        ("insert", (seq(4, start=200), [3])),
        ("match", (seq(4, start=1),)),
        ("evict", ()), ("evict", ()), ("evict", ()), ("evict", ())]),
    "interior-not-evictable": (16, [
        ("insert", (seq(12), [1, 2, 3])),
        ("evict", ()), ("evict", ()), ("evict", ()), ("evict", ())]),
    "capacity-evicts-on-insert": (2, [
        ("insert", (seq(8), [1, 2])),
        ("insert", (seq(8, start=100), [3, 4])),
        ("nodes", ()), ("match", (seq(8, start=100),))]),
    "ragged-tail-ignored": (16, [
        ("insert", (seq(10), [5, 6, 7])), ("nodes", ()),
        ("match", (seq(11),)), ("match", (toks(1, 2, 3),))]),
    "branching-then-evict": (3, [
        ("insert", (seq(8), [1, 2])),
        ("insert", (np.concatenate([seq(4), toks(50, 51, 52, 53)]), [1, 3])),
        ("match", (seq(8),)),
        ("insert", (seq(4, start=70), [4])),
        ("nodes", ()), ("evict", ()), ("evict", ()), ("nodes", ())]),
}


def _run_index(cls, capacity, script):
    ix = cls(BP, capacity)
    out = []
    for op, args in script:
        if op == "insert":
            out.append(_insert(ix, *args))
        elif op == "match":
            out.append(_match(ix, *args))
        elif op == "evict":
            out.append(_evict(ix))
        else:
            out.append(sorted(n.block for n in ix.walk()))
    return out


@pytest.mark.parametrize("name", sorted(INDEX_SCRIPTS))
def test_radix_index_equals_jax(name):
    capacity, script = INDEX_SCRIPTS[name]
    want = _run_index(JaxIndex, capacity, script)
    got = _run_index(RadixIndex, capacity, script)
    assert got == want
    assert any(r not in (None, [], ([], 0, None)) for r in got)


def _store_script(store_cls, kind):
    """One store scenario on a fake allocator; returns what it records."""
    a = FakeAllocator()
    if kind == "refcount":
        a.seed([7, 8])
        st = store_cls(a, BP, capacity=8)
        st.insert(seq(8), [7, 8])
        out = [dict(a.rc)]
        out += [st.evict_one(), st.evict_one(), dict(a.rc), st.evict_one()]
        return out
    if kind == "hit-accounting":
        a.seed([1, 2])
        st = store_cls(a, BP, capacity=8)
        st.insert(seq(8), [1, 2], origin="adopted")
        hit = st.lookup(seq(8))
        out = [hit.shared, hit.origins, hit.remote_used(2, False),
               st.block_hits]
        st.note_reuse(2, hit.remote_used(2, False))
        miss = st.lookup(seq(8, start=500))
        return out + [st.block_hits, st.remote_block_hits,
                      hit.remote_used(1, False), miss.shared]
    if kind == "full-hit-row":
        a.seed([1, 2, 3])
        st = store_cls(a, BP, capacity=8)
        st.insert(seq(8), [1, 2], logit_rows={1: "row"})
        st.insert(seq(4, start=40), [3])
        return [st.lookup(seq(8)).logit_row, st.lookup(seq(7)).logit_row,
                st.lookup(seq(4, start=40)).logit_row,
                st.lookup(seq(7)).cow_tokens, st.lookup(seq(7)).cow_src]
    if kind == "capacity":
        a.seed([1, 2, 3, 4, 5])
        st = store_cls(a, BP, capacity=3)
        created = [st.insert(seq(8), [1, 2]),
                   st.insert(seq(12, start=50), [3, 4, 5])]
        return created + [dict(a.rc), st.n_blocks, st.evictions]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["refcount", "hit-accounting",
                                  "full-hit-row", "capacity"])
def test_prefix_store_equals_jax(kind):
    assert _store_script(PrefixStore, kind) == _store_script(JaxStore, kind)


def test_store_on_the_block_allocator():
    """The store over the pool's own allocator: one reference per
    resident block; a slot's references keep a block alive through its
    eviction; clear() returns every block the slot does not hold."""
    a = BlockAllocator(9)
    slot = a.alloc(3)
    st = PrefixStore(a, BP, capacity=8)
    assert st.insert(seq(12), slot) == 3 and a.n_used == 3
    a.free(slot)                  # the slot retires: the store keeps them
    assert a.n_used == 3 and st.n_blocks == 3
    assert st.lookup(seq(12)).shared == slot
    other = a.alloc(2)
    st.insert(np.concatenate([seq(4), toks(9, 9, 9, 9)]),
              [slot[0], other[0]])
    assert a.n_used == 5          # the slot's 2 others + the new node's
    st.clear()
    assert a.n_used == 2 and st.n_blocks == 0
    a.free(other)
    assert a.n_used == 0
