"""The port's KV-cache accounting (``serving/kv_cache.py``) against the
JAX package's: the cases of ``tests/test_serving.py``'s allocator,
prefix-hash and prefix-cache classes, and the session lease table, each
run on both modules. Every case returns what it observed, and the two
packages must observe the same (the chained prefix digests byte for
byte); the assertions inside each case hold on both.
"""

import numpy as np
import pytest

from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu_torch.serving import kv_cache as tkv


def scratch_is_never_handed_out(m):
    a = m.BlockAllocator(8)
    got = a.alloc(7)
    assert got is not None and m.SCRATCH_BLOCK not in got
    assert a.alloc(1) is None
    return got


def all_or_nothing(m):
    a = m.BlockAllocator(5)
    assert a.alloc(5) is None
    assert a.free == 4
    got = a.alloc(3)
    assert len(got) == 3 and a.free == 1
    return got, a.free, a.in_use, a.total


def release_recycles(m):
    a = m.BlockAllocator(4)
    got = a.alloc(3)
    a.release(got)
    assert a.free == 3
    return a.alloc(3)


def double_free_and_scratch_release_raise(m):
    a = m.BlockAllocator(4)
    got = a.alloc(2)
    a.release(got)
    out = []
    for bad in ([got[0]], [m.SCRATCH_BLOCK]):
        with pytest.raises(ValueError) as e:
            a.release(bad)
        out.append(str(e.value))
    assert "double free" in out[0] and "scratch" in out[1]
    return out


def blocks_needed(m):
    out = [m.blocks_needed(p, n, b) for p, n, b in
           [(4, 1, 4), (4, 2, 4), (5, 8, 4), (1, 1, 16), (33, 64, 16)]]
    assert out[:3] == [1, 2, 3]
    with pytest.raises(ValueError):
        m.blocks_needed(0, 4, 4)
    return out


def refcount_shared_block_survives_first_release(m):
    a = m.BlockAllocator(4)
    got = a.alloc(2)
    a.incref(got[0])
    assert a.refcount(got[0]) == 2
    a.release(got)
    assert a.free == 2 and a.refcount(got[0]) == 1
    assert a.decref(got[0]) is True
    assert a.free == 3
    return got


def incref_free_or_scratch_block_raises(m):
    a = m.BlockAllocator(4)
    out = []
    for block in (1, m.SCRATCH_BLOCK):
        with pytest.raises(ValueError) as e:
            a.incref(block)
        out.append(str(e.value))
    got = a.alloc(1)
    a.release(got)
    with pytest.raises(ValueError, match="free"):
        a.incref(got[0])
    return out


def prefix_hashes_chained(m):
    toks = list(range(20))
    h1 = m.prefix_hashes(toks, 4)
    assert h1 == m.prefix_hashes(list(toks), 4)
    assert len(h1) == 4
    other = m.prefix_hashes([99] + toks[1:], 4)
    assert other[0] != h1[0] and other[1] != h1[1]
    div = m.prefix_hashes(toks[:8] + [99] * 12, 4)
    assert div[:2] == h1[:2] and div[2] != h1[2]
    return h1, other, div


def prefix_hashes_random_prompts(m):
    rng = np.random.RandomState(0)
    return [m.prefix_hashes(list(rng.randint(0, 32000, int(n))), bs)
            for n, bs in zip(rng.randint(1, 600, 12),
                             [1, 4, 16, 16, 32, 7] * 2)]


def short_prompt_has_no_shareable_blocks(m):
    assert m.prefix_hashes([1, 2, 3, 4], 4) == []
    return m.prefix_hashes([1, 2, 3, 4, 5], 4)


def prefix_lookup_increfs_and_longest_prefix(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a)
    blocks = a.alloc(3)
    h = m.prefix_hashes(list(range(13)), 4)
    for hj, b in zip(h, blocks):
        pc.insert(hj, b)
    assert a.refcount(blocks[0]) == 2
    got = pc.lookup(h[:2] + [b"nope"])
    assert got == blocks[:2]
    assert a.refcount(blocks[0]) == 3 and a.refcount(blocks[2]) == 2
    return got


def prefix_insert_first_writer_wins(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a)
    b1, b2 = a.alloc(2)
    h = m.prefix_hashes(list(range(5)), 4)[0]
    assert pc.insert(h, b1) is True
    assert pc.insert(h, b2) is False
    return pc.lookup([h])


def prefix_evict_one_drops_lru(m):
    a = m.BlockAllocator(8)
    pc = m.PrefixCache(a)
    blocks = a.alloc(2)
    h = m.prefix_hashes(list(range(9)), 4)
    pc.insert(h[0], blocks[0])
    pc.insert(h[1], blocks[1])
    a.release(blocks)
    assert a.free == 5
    pc.lookup([h[0]])
    assert pc.evict_one() is True
    assert a.free == 6 and pc.lookup([h[1]]) == [] and len(pc) == 1
    return a.free


def prefix_max_entries_bounds_the_index(m):
    a = m.BlockAllocator(16)
    pc = m.PrefixCache(a, max_entries=2)
    blocks = a.alloc(3)
    h = m.prefix_hashes(list(range(13)), 4)
    for hj, b in zip(h, blocks):
        pc.insert(hj, b)
    assert len(pc) == 2 and pc.lookup([h[0]]) == []
    return len(pc)


def lease_put_get_pop_release(m):
    a = m.BlockAllocator(16)
    t = m.SessionLeaseTable(a, max_entries=3)
    blocks = a.alloc(3)
    t.put("s1", list(range(10)), blocks)
    lease = t.get("s1")
    assert lease.n_tokens == 10 and lease.blocks == blocks
    popped = t.pop("s1")
    assert t.get("s1") is None and len(t) == 0
    t.release(popped)
    assert a.free == 15
    return blocks, a.free


def lease_supersede_and_lru_order(m):
    a = m.BlockAllocator(16)
    t = m.SessionLeaseTable(a)
    t.put("a", [1, 2], a.alloc(1))
    t.put("b", [3, 4], a.alloc(1))
    t.put("a", [1, 2, 5], a.alloc(2))     # supersedes: old block freed
    t.get("b")                           # freshen b
    return t.ids(), a.free


def lease_evict_demotes_to_prefix_cache(m):
    a = m.BlockAllocator(16)
    pc = m.PrefixCache(a)
    t = m.SessionLeaseTable(a)
    toks = list(range(13))
    blocks = a.alloc(4)
    t.put("s", toks, blocks)
    assert t.evict_one(pc, 4) is True
    assert t.evict_one(pc, 4) is False
    hit = pc.lookup(m.prefix_hashes(toks, 4))
    assert hit == blocks[:3]
    return hit, a.free, len(pc)


CASES = [scratch_is_never_handed_out, all_or_nothing, release_recycles,
         double_free_and_scratch_release_raise, blocks_needed,
         refcount_shared_block_survives_first_release,
         incref_free_or_scratch_block_raises, prefix_hashes_chained,
         prefix_hashes_random_prompts,
         short_prompt_has_no_shareable_blocks,
         prefix_lookup_increfs_and_longest_prefix,
         prefix_insert_first_writer_wins, prefix_evict_one_drops_lru,
         prefix_max_entries_bounds_the_index, lease_put_get_pop_release,
         lease_supersede_and_lru_order,
         lease_evict_demotes_to_prefix_cache]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_kv_cache_matches_jax(case):
    assert case(tkv) == case(jkv)


def test_scratch_block_is_zero():
    assert tkv.SCRATCH_BLOCK == jkv.SCRATCH_BLOCK == 0
