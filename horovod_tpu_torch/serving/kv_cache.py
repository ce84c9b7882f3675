"""Block-granular KV-cache accounting — the free-list behind continuous
batching. Counterpart of ``horovod_tpu/serving/kv_cache.py``, copied:
:func:`prefix_hashes` gives the same chained digests.

The device-side pool (``models.transformer.init_cache``) is a flat
array of fixed-size token blocks; this module owns the *host-side*
bookkeeping: which blocks are free, which sequence holds which, and how
many a request needs end-to-end. Slicing the cache into blocks is what
lets concurrency be bounded by total tokens instead of by
``max_batch × max_seq`` — a finished request returns whole blocks to
the pool and the next admit reuses them, with no fragmentation between
differently-sized sequences (vLLM's PagedAttention argument, SOSP '23).

Allocation is all-or-nothing and up-front: :class:`BlockAllocator`
hands a request every block its worst case needs (prompt + max new
tokens) at admission, or none at all. That conservative reservation is
the engine's no-preemption guarantee — pool exhaustion can only ever
*defer admission*; it can never strand a live sequence mid-decode or
force evicting one to disk (docs/serving.md).

Block 0 is reserved as scratch and never handed out: padded prefill
positions and inactive batch slots point their block tables at it, so
their garbage K/V writes land where no live sequence reads.

Blocks are *refcounted*: a plain allocation holds one reference, and
the shared prefix cache (:class:`PrefixCache`) adds references so two
sequences with the same system prompt can address the same read-only
prefix blocks. A block returns to the free list only when its last
holder lets go — ``release`` is a decref, not an unconditional free.
Divergence past a shared prefix is copy-on-write at block granularity:
writes only ever land in a sequence's privately-allocated blocks (a
shareable block is by construction a FULL block of prompt tokens, and
every later position falls in a later, private block), so the
"divergent copy" is realized by writing fresh K/V into fresh blocks —
shared blocks are never mutated.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence

SCRATCH_BLOCK = 0


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Worst-case block count for a request: K/V is written for the
    prompt and for every generated token that is fed back (the last
    generated token is output-only), i.e. positions
    ``[0, prompt_len + max_new_tokens - 1)``."""
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    tokens = prompt_len + max_new_tokens - 1
    return -(-tokens // int(block_size))


class BlockAllocator:
    """Refcounted free-list over pool blocks ``1..n_blocks-1`` (0 is
    scratch). Every operation is O(1) per block touched: ``alloc`` pops
    off the free stack (no scan of the free set), ``release``/``decref``
    push back the moment the count hits zero.

    Not thread-safe by itself — the engine serializes all scheduler
    state under its own lock.
    """

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError(
                f"the pool needs the scratch block plus at least one "
                f"allocatable block; got n_blocks={n_blocks}")
        self.n_blocks = int(n_blocks)
        # LIFO free stack, low ids first out — deterministic layouts
        # for the seeded bench.
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._refs = [0] * self.n_blocks

    @property
    def total(self) -> int:
        """Allocatable blocks (excludes scratch)."""
        return self.n_blocks - 1

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.total - self.free

    def refcount(self, block: int) -> int:
        return self._refs[block]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks at one reference each, all-or-nothing; None when
        the pool cannot cover the request (the admission gate's signal
        to leave it queued)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, block: int) -> None:
        """Add a holder to a live block — how the prefix cache (and
        through it a second sequence) shares a block already in use."""
        if block == SCRATCH_BLOCK:
            raise ValueError("block 0 is the scratch block; it is "
                             "never allocated and never shared")
        if self._refs[block] <= 0:
            raise ValueError(
                f"cannot incref free KV block {block} — only a held "
                "block can gain holders")
        self._refs[block] += 1

    def decref(self, block: int) -> bool:
        """Drop one holder; frees (returns True) when the last one
        lets go. Over-release and scratch-release are hard errors —
        both would hand one block to two live sequences and silently
        corrupt their caches."""
        if block == SCRATCH_BLOCK:
            raise ValueError("block 0 is the scratch block; it is "
                             "never allocated and never released")
        if self._refs[block] <= 0:
            raise ValueError(f"double free of KV block {block}")
        self._refs[block] -= 1
        if self._refs[block] == 0:
            self._free.append(block)
            return True
        return False

    def release(self, blocks: List[int]) -> None:
        """Drop one reference on each of a finished sequence's blocks
        (shared prefix blocks stay resident under the cache's ref)."""
        for b in blocks:
            self.decref(b)


def prefix_hashes(tokens: Sequence[int], block_size: int) -> List[bytes]:
    """Chained digest per FULL prompt block: entry ``j`` identifies
    ``tokens[0:(j+1)*block_size]`` — a prefix, not a window, so two
    prompts share entry ``j`` iff they agree on every token up to
    there. Only blocks wholly inside ``tokens[:-1]`` are hashed: the
    final prompt token is never shareable because admission always
    needs at least one token to prefill (its forward produces the
    first-token logits).

    Deterministic across processes (hashlib, not Python's salted
    ``hash``) — the fleet router hashes the same prompts with the same
    function to score replica cache warmth."""
    bs = int(block_size)
    n_full = max(0, (len(tokens) - 1) // bs)
    out: List[bytes] = []
    h = b""
    for j in range(n_full):
        blk = ",".join(str(int(t)) for t in tokens[j * bs:(j + 1) * bs])
        h = hashlib.blake2b(h + blk.encode(), digest_size=16).digest()
        out.append(h)
    return out


class PrefixCache:
    """LRU map from chained prompt-prefix hashes to resident pool
    blocks — the host-side index behind shared-prefix prefill.

    The cache holds ONE reference on every block it indexes (via
    :meth:`BlockAllocator.incref`), so an indexed block outlives the
    sequence that wrote it. ``lookup`` increfs each matched block for
    the caller (the admitting sequence's own hold); ``evict_one`` pops
    the least-recently-used entry and drops the cache's reference —
    blocks still shared by live sequences are freed only when those
    finish. Not thread-safe — engine-lock discipline, like the
    allocator."""

    def __init__(self, alloc: BlockAllocator,
                 max_entries: Optional[int] = None):
        self._alloc = alloc
        self._map: "OrderedDict[bytes, int]" = OrderedDict()
        self.max_entries = max_entries

    def __len__(self) -> int:
        return len(self._map)

    def lookup(self, hashes: Sequence[bytes]) -> List[int]:
        """Longest cached prefix of ``hashes``; increfs every returned
        block (the caller now holds them) and freshens their LRU
        position."""
        out: List[int] = []
        for h in hashes:
            b = self._map.get(h)
            if b is None:
                break
            self._map.move_to_end(h)
            self._alloc.incref(b)
            out.append(b)
        return out

    def insert(self, h: bytes, block: int) -> bool:
        """Index ``block`` (held by the caller) under ``h``; the cache
        takes its own reference. No-op when the hash is already
        indexed (first writer wins — both blocks hold identical K/V,
        keeping one mapping makes sharing converge)."""
        if h in self._map:
            return False
        self._alloc.incref(block)
        self._map[h] = block
        if self.max_entries is not None \
                and len(self._map) > self.max_entries:
            self.evict_one()
        return True

    def evict_one(self) -> bool:
        """Drop the LRU entry's cache reference; True when an entry was
        evicted. The engine calls this under pool pressure until the
        pending admission fits (or the cache is empty)."""
        if not self._map:
            return False
        _, block = self._map.popitem(last=False)
        self._alloc.decref(block)
        return True


class SessionLease:
    """One conversation's resident KV claim between turns: the token
    context the blocks encode (``prompt + generated[:-1]`` of the last
    turn — exactly the positions whose K/V was written) and the leading
    pool blocks that hold it. The lease owns one reference on each
    block."""

    __slots__ = ("tokens", "blocks")

    def __init__(self, tokens: List[int], blocks: List[int]):
        self.tokens = tokens
        self.blocks = blocks

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


class SessionLeaseTable:
    """LRU map ``session_id -> SessionLease`` — KV-block survival
    between conversation turns (docs/serving.md#session-affinity).

    Where the prefix cache shares FULL prompt blocks across unrelated
    requests, a lease keeps a single conversation's *entire* context
    resident — including generated tokens, which the prefix cache never
    indexes — so the next turn of that conversation resumes decoding
    from its stored position instead of re-prefilling the transcript.

    Leases are the first thing sacrificed under pool pressure: eviction
    *demotes* a lease to the refcounted prefix cache (its full prompt-
    prefix blocks get indexed there, a degraded-but-still-warm tier)
    before dropping the lease's references. Not thread-safe —
    engine-lock discipline, like the allocator."""

    def __init__(self, alloc: BlockAllocator,
                 max_entries: Optional[int] = None):
        self._alloc = alloc
        self._map: "OrderedDict[str, SessionLease]" = OrderedDict()
        self.max_entries = max_entries

    def __len__(self) -> int:
        return len(self._map)

    def ids(self) -> List[str]:
        """Live session ids, LRU-oldest first — advertised by the
        replica's ``/healthz`` for router pinning."""
        return list(self._map)

    def get(self, session_id: str) -> Optional[SessionLease]:
        """Peek a lease (freshens LRU position; ownership stays with
        the table). The engine inspects ``tokens`` to decide between
        resuming from the lease and releasing it as divergent."""
        lease = self._map.get(session_id)
        if lease is not None:
            self._map.move_to_end(session_id)
        return lease

    def pop(self, session_id: str) -> Optional[SessionLease]:
        """Remove a lease, transferring its block references to the
        caller (who must release or re-``put`` them)."""
        return self._map.pop(session_id, None)

    def put(self, session_id: str, tokens: List[int],
            blocks: List[int]) -> None:
        """Store a lease; the table takes over the caller's reference
        on each block. A superseded lease for the same id is released
        first."""
        old = self._map.pop(session_id, None)
        if old is not None:
            self.release(old)
        self._map[session_id] = SessionLease(list(tokens), list(blocks))

    def release(self, lease: SessionLease) -> None:
        """Drop the lease's reference on every block (blocks shared
        with the prefix cache or a live sequence stay resident)."""
        self._alloc.release(lease.blocks)
        lease.blocks = []

    def evict_one(self, prefix: Optional["PrefixCache"] = None,
                  block_size: int = 0) -> bool:
        """Sacrifice the LRU lease under pool pressure; True when one
        was evicted. With a prefix cache, the lease's FULL prompt-
        prefix blocks are demoted into it first (the cache increfs what
        it indexes), so a follow-up turn still skips those chunks via
        the ordinary shared-prefix path."""
        if not self._map:
            return False
        _, lease = self._map.popitem(last=False)
        if prefix is not None and block_size > 0:
            hashes = prefix_hashes(lease.tokens, block_size)
            for j, h in enumerate(hashes[:len(lease.blocks)]):
                prefix.insert(h, lease.blocks[j])
        self.release(lease)
        return True
