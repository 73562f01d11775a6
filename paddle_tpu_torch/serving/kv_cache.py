"""KV cache + slot state machine for the serving engine.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (``KVCacheManager`` and
``PagedKVCacheManager`` with the draft-model tenant; the host-RAM tier
and block-chain export/import are not ported yet).  The manager owns the
per-slot facts the scheduler reads and the device steps consume:

* ``caches`` — the per-layer ``(k, v)`` tensors (for an int8 cache, each
  a ``(data, scale)`` pair), allocated once and then updated IN PLACE by
  every dispatch (the reference rebound donated outputs instead).
  Nothing here keeps an older copy of them.
* ``lengths`` — the host int32 mirror of each slot's write offset.
  ``device_lengths`` masks it: a dead slot gets ``max_len``, so its cache
  writes drop (the write-drop parking invariant).
* ``reqs`` — slot -> live Request (None = free), lowest-free-first.

``PagedKVCacheManager`` swaps the dense rows for a global block pool
indirected through per-slot block tables: refcounted blocks, a radix
map keyed on token-id chunks for prefix reuse, and LRU eviction of
refcount-0 cached prefixes.  Its host bookkeeping is a line-for-line
port, so for the same call sequence it hands out the same block ids as
the reference.

A resident draft model (speculative decoding) is a second TENANT of the
same pool: a second chain per slot (``draft_tables``) drawing the same
free list, refcounts and admission reservation, with its own radix
namespace (a salted root chunk).  Draft blocks free outright at
refcount 0 — never parked evictable — so the draft tenant's accounting
(``draft_blocks_used``) returns to 0 once every spec request drains.
The rows a speculative rewind leaves mapped past a slot's accepted
length stay in its chains (capped by the admission budget) and are
released with them, both chains together, when the slot retires.

Under tensor parallelism (``serving/sharding.py``) each rank's manager
is built with the rank's ``num_kv_heads / N`` heads, so its caches and
pools — int8 scale leaves and the draft tenant's layers included — hold
only the rank's heads (``kv_cache_pspec``: the head axis, index 2 in both
geometries).  The host bookkeeping is identical on every rank, so the
ranks hand out the same slots and the same block ids.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.device import h2d
from paddle_tpu_torch.ops.decode_attention import (
    init_kv_cache, init_kv_pool, kv_data,
)

__all__ = ["KVCacheManager", "PagedKVCacheManager", "KVPoolExhausted"]


class KVPoolExhausted(RuntimeError):
    """A block allocation could not be satisfied even after evicting
    every refcount-0 cached block (admission reserves worst-case budgets
    up front, so the engine treats this as back-pressure)."""


class KVCacheManager:
    """Slot allocator + dense KV-cache owner for one fixed-batch engine."""

    def __init__(self, n_layers, batch_size, max_len, num_kv_heads,
                 head_dim, dtype, device=None):
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.caches = [init_kv_cache(self.batch_size, self.max_len,
                                     num_kv_heads, head_dim, dtype, device)
                       for _ in range(n_layers)]
        self.device = kv_data(self.caches[0][0]).device
        self.lengths = np.zeros((self.batch_size,), np.int32)
        self.reqs = [None] * self.batch_size

    # ------------------------------------------------------------- slots
    def free_slots(self):
        """Free slot indices, lowest first (the admission fill order)."""
        return [i for i in range(self.batch_size) if self.reqs[i] is None]

    def occupied(self):
        return sum(r is not None for r in self.reqs)

    def any_live(self):
        return any(r is not None for r in self.reqs)

    def live_tokens(self):
        """Total context tokens held by live slots."""
        return int(sum(int(self.lengths[i]) for i in range(self.batch_size)
                       if self.reqs[i] is not None))

    def assign(self, slot, request):
        """Bind ``request`` to ``slot``; assigning over a live slot
        raises (the occupant would be orphaned)."""
        if self.reqs[slot] is not None:
            raise ValueError(
                f"slot {slot} already holds request "
                f"{getattr(self.reqs[slot], 'rid', None)!r} — release it "
                "before assigning (double-assign orphans the occupant)")
        self.reqs[slot] = request

    def release(self, slot):
        """Free ``slot``; its cache rows are left as they are (the slot is
        parked at ``max_len`` from the next dispatch on).  Releasing a
        free slot raises."""
        if self.reqs[slot] is None:
            raise ValueError(
                f"slot {slot} is already free — double-release corrupts "
                "the slot free list")
        self.reqs[slot] = None

    # ------------------------------------------------------------ device
    def device_lengths(self, active):
        """The lengths operand for one dispatch: the host mirror with
        every non-``active`` slot masked to ``max_len``, copied to the
        device without a sync."""
        masked = np.where(np.asarray(active, bool), self.lengths,
                          np.int32(self.max_len)).astype(np.int32)
        return h2d(masked, self.device)


class PagedKVCacheManager(KVCacheManager):
    """Block allocator + radix prefix cache over a paged KV pool.

    * ``caches`` — per-layer ``(k, v)`` pools ``[N, C, Hkv, D]`` with
      ``N = max_live_tokens // C``.
    * ``block_tables`` — host int32 ``[B, W]`` (``W = Lmax / C``); unmapped
      entries hold the sentinel ``N``, so device writes there drop.
    * every block is on the free list, LIVE (refcount > 0) or EVICTABLE
      (refcount 0, still a registered prefix, tracked LRU);
      ``refcnt[child] <= refcnt[parent]`` along every registered chain,
      which is what makes subtree eviction safe.
    """

    def __init__(self, n_layers, batch_size, max_len, num_kv_heads,
                 head_dim, dtype, block, max_live_tokens, device=None,
                 on_event=None):
        self.batch_size = int(batch_size)
        self.max_len = int(max_len)
        self.block = int(block)
        if self.block <= 0 or self.max_len % self.block:
            raise ValueError(
                f"kv block ({block}) must divide max_len ({max_len}): the "
                "paged read is the chunked loop and a partial tail block "
                "would break the clamped-tail masking")
        self.width = self.max_len // self.block
        self.num_blocks = int(max_live_tokens) // self.block
        if self.num_blocks < self.width:
            raise ValueError(
                f"max_live_tokens ({max_live_tokens}) must cover at least "
                f"one full-length request ({max_len} tokens): a smaller "
                "pool could never admit a valid submit() and would defer "
                "it forever")
        self.caches = [init_kv_pool(self.num_blocks, self.block,
                                    num_kv_heads, head_dim, dtype, device)
                       for _ in range(n_layers)]
        self.device = kv_data(self.caches[0][0]).device
        self.lengths = np.zeros((self.batch_size,), np.int32)
        self.reqs = [None] * self.batch_size
        self.block_tables = np.full((self.batch_size, self.width),
                                    self.num_blocks, np.int32)
        self.refcnt = np.zeros((self.num_blocks,), np.int32)
        self._free = list(range(self.num_blocks - 1, -1, -1))  # pop() -> 0
        self._mapped = [0] * self.batch_size
        self._resv_left = [0] * self.batch_size
        # draft tenancy: a second chain per slot for the draft model's KV
        self.draft_tables = np.full((self.batch_size, self.width),
                                    self.num_blocks, np.int32)
        self._dmapped = [0] * self.batch_size      # draft chunks per slot
        self._draft_blocks = set()                 # live draft block ids
        # radix prefix map (root parent id = -1)
        self._node = {}     # (parent_block, chunk tokens) -> block id
        self._key_of = {}   # registered block id -> its key
        self._kids = {}     # parent block id -> set(registered child ids)
        self._lru = {}      # evictable block id -> release tick
        self._tick = 0
        self._on_event = on_event

    def _emit(self, kind, **info):
        if self._on_event is not None:
            self._on_event(kind, **info)

    def _check_block(self, b):
        if not 0 <= b < self.num_blocks:
            raise ValueError(
                f"block index {b} out of range [0, {self.num_blocks})")

    # ---------------------------------------------------------- accounting
    def free_count(self):
        return len(self._free)

    def evictable_count(self):
        return len(self._lru)

    def blocks_used(self):
        """Blocks that are live OR holding an evictable cached prefix."""
        return self.num_blocks - len(self._free)

    def draft_blocks_used(self):
        """LIVE draft-chain blocks (0 once every spec request drained:
        draft blocks free outright at refcount 0)."""
        return len(self._draft_blocks)

    def outstanding(self):
        """Blocks promised to admitted slots but not yet allocated."""
        return sum(self._resv_left)

    def can_reserve(self, n_blocks):
        """Whether ``n_blocks`` new allocations can be promised without
        starving an existing reservation (evictable blocks count as
        available)."""
        return n_blocks <= (len(self._free) + len(self._lru)
                            - self.outstanding())

    def reserve(self, slot, n_blocks):
        """Record ``slot``'s remaining worst-case block budget."""
        self._resv_left[slot] = int(n_blocks)

    # ---------------------------------------------------------- allocator
    def _evict_subtree(self, root):
        """Reclaim evictable ``root`` and every registered descendant (all
        refcount 0 by the chain invariant) to the free list."""
        parent = self._key_of[root][0]
        self._kids.get(parent, set()).discard(root)
        stack, n = [root], 0
        while stack:
            b = stack.pop()
            if self.refcnt[b] != 0:
                raise RuntimeError(
                    f"prefix chain invariant broken: evicting block {b} "
                    f"with refcount {int(self.refcnt[b])}")
            stack.extend(self._kids.pop(b, ()))
            self._node.pop(self._key_of.pop(b), None)
            self._lru.pop(b, None)
            self._free.append(b)
            n += 1
            self._emit("block_free", block=int(b), evicted=True)
        return n

    def alloc_block(self):
        """One free block (refcount 1), evicting the least-recently-
        released cached prefix subtree if the free list is dry.  Raises
        ``KVPoolExhausted`` when every block is live."""
        if not self._free:
            if not self._lru:
                raise KVPoolExhausted(
                    f"kv pool exhausted: all {self.num_blocks} blocks of "
                    f"{self.block} tokens are live")
            self._evict_subtree(min(self._lru, key=self._lru.get))
        b = self._free.pop()
        self.refcnt[b] = 1
        self._emit("block_alloc", block=int(b))
        return b

    def free_block(self, b):
        """Drop one reference.  At refcount 0 a registered block parks as
        EVICTABLE; an unregistered one returns to the free list.
        Underflow and out-of-range raise."""
        b = int(b)
        self._check_block(b)
        if self.refcnt[b] <= 0:
            raise ValueError(
                f"refcount underflow: block {b} is already free "
                "(double-free corrupts the pool)")
        self.refcnt[b] -= 1
        if self.refcnt[b] == 0:
            if b in self._draft_blocks:
                # draft policy: leave the draft radix namespace and free
                # outright — never LRU-park
                key = self._key_of.pop(b, None)
                if key is not None:
                    self._node.pop(key, None)
                    self._kids.get(key[0], set()).discard(b)
                    self._kids.pop(b, None)
                self._draft_blocks.discard(b)
                self._free.append(b)
            elif b in self._key_of:
                self._tick += 1
                self._lru[b] = self._tick
            else:
                self._free.append(b)
            self._emit("block_free", block=b, evicted=False)

    def ensure_rows(self, slot, upto):
        """Grow ``slot``'s chain to cover logical rows ``[0, upto)``
        (rows past ``max_len`` are capped — the device drops them)."""
        need = min(-(-int(upto) // self.block), self.width)
        while self._mapped[slot] < need:
            b = self.alloc_block()
            self.block_tables[slot, self._mapped[slot]] = b
            self._mapped[slot] += 1
            if self._resv_left[slot] > 0:
                self._resv_left[slot] -= 1
        return self._mapped[slot]

    def ensure_draft_rows(self, slot, upto):
        """``ensure_rows`` for ``slot``'s DRAFT chain: the same free list
        and the same admission reservation."""
        need = min(-(-int(upto) // self.block), self.width)
        while self._dmapped[slot] < need:
            b = self.alloc_block()
            self._draft_blocks.add(b)
            self.draft_tables[slot, self._dmapped[slot]] = b
            self._dmapped[slot] += 1
            if self._resv_left[slot] > 0:
                self._resv_left[slot] -= 1
        return self._dmapped[slot]

    # ------------------------------------------------------- prefix reuse
    def match_prefix(self, tokens, touch=True):
        """Longest cached prefix of ``tokens`` -> (matched_tokens, blocks).
        Only full blocks are shareable, capped at ``((p-1)//C)*C`` so at
        least one suffix token prefills (its forward yields the first
        token).  With ``touch`` every matched evictable block gets a fresh
        LRU tick."""
        cap = max(0, (len(tokens) - 1) // self.block)
        parent, out = -1, []
        for k in range(cap):
            chunk = tuple(int(t) for t in
                          tokens[k * self.block:(k + 1) * self.block])
            b = self._node.get((parent, chunk))
            if b is None:
                break
            if touch and b in self._lru:
                self._tick += 1
                self._lru[b] = self._tick
            out.append(b)
            parent = b
        return len(out) * self.block, out

    def adopt_prefix(self, slot, blocks):
        """Map shared prefix ``blocks`` at the head of fresh ``slot``'s
        chain: refcounts bump, evictable blocks return to LIVE."""
        if self._mapped[slot]:
            raise ValueError(
                f"adopt_prefix: slot {slot} already maps "
                f"{self._mapped[slot]} blocks")
        for w, b in enumerate(blocks):
            b = int(b)
            self._check_block(b)
            self.refcnt[b] += 1
            if self.refcnt[b] == 1:
                self._lru.pop(b, None)
            self.block_tables[slot, w] = b
        self._mapped[slot] = len(blocks)

    def register_prefix(self, slot, tokens):
        """Publish ``slot``'s full-block prefix chain into the radix map —
        at first-token emission, after the finite check.  First writer
        wins per chunk key; on a collision the rest of the chain stays
        private."""
        parent = -1
        n_full = min(len(tokens) // self.block, self._mapped[slot])
        for k in range(n_full):
            chunk = tuple(int(t) for t in
                          tokens[k * self.block:(k + 1) * self.block])
            key = (parent, chunk)
            b = int(self.block_tables[slot, k])
            cur = self._node.get(key)
            if cur is None:
                self._node[key] = b
                self._key_of[b] = key
                self._kids.setdefault(parent, set()).add(b)
                parent = b
            elif cur == b:
                parent = b
            else:
                break

    # ------------------------------------------------ draft radix namespace
    # The draft chains live in the same radix maps under a salted root
    # chunk, so identical prompts share one draft chain while a draft
    # chunk can never be matched as a target chunk.  A draft chunk stays
    # matchable only while some slot references it.
    _DRAFT_SALT = "__draft__"

    def _draft_chunk(self, tokens, k):
        chunk = tuple(int(t) for t in
                      tokens[k * self.block:(k + 1) * self.block])
        return ((self._DRAFT_SALT,) + chunk) if k == 0 else chunk

    def match_draft_prefix(self, tokens):
        """``match_prefix`` over the draft namespace (draft blocks are
        never in the LRU, so a match touches nothing)."""
        cap = max(0, (len(tokens) - 1) // self.block)
        parent, out = -1, []
        for k in range(cap):
            b = self._node.get((parent, self._draft_chunk(tokens, k)))
            if b is None:
                break
            out.append(b)
            parent = b
        return len(out) * self.block, out

    def register_draft_prefix(self, slot, tokens):
        """``register_prefix`` for ``slot``'s draft chain."""
        parent = -1
        n_full = min(len(tokens) // self.block, self._dmapped[slot])
        for k in range(n_full):
            key = (parent, self._draft_chunk(tokens, k))
            b = int(self.draft_tables[slot, k])
            cur = self._node.get(key)
            if cur is None:
                self._node[key] = b
                self._key_of[b] = key
                self._kids.setdefault(parent, set()).add(b)
                parent = b
            elif cur == b:
                parent = b
            else:
                break

    def adopt_draft_prefix(self, slot, blocks):
        """``adopt_prefix`` for ``slot``'s fresh draft chain."""
        if self._dmapped[slot]:
            raise ValueError(
                f"adopt_draft_prefix: slot {slot} already maps "
                f"{self._dmapped[slot]} draft blocks")
        for w, b in enumerate(blocks):
            b = int(b)
            self._check_block(b)
            self.refcnt[b] += 1
            self.draft_tables[slot, w] = b
        self._dmapped[slot] = len(blocks)

    # -------------------------------------------------------------- slots
    def release(self, slot):
        """Retire ``slot``: unreference its chain (shared or registered
        blocks may stay EVICTABLE), reset its table row to the sentinel,
        clear its reservation.  The draft chain goes LEAF-FIRST, so a
        shared draft parent stays registered until its registered
        children are gone."""
        super().release(slot)
        for w in range(self._mapped[slot]):
            self.free_block(int(self.block_tables[slot, w]))
        self.block_tables[slot, :] = self.num_blocks
        self._mapped[slot] = 0
        for w in range(self._dmapped[slot] - 1, -1, -1):
            self.free_block(int(self.draft_tables[slot, w]))
        self.draft_tables[slot, :] = self.num_blocks
        self._dmapped[slot] = 0
        self._resv_left[slot] = 0

    # -------------------------------------------------------------- device
    def device_tables(self):
        """The ``[B, W]`` int32 block-table operand for one dispatch."""
        return h2d(self.block_tables, self.device)

    def device_draft_tables(self):
        """The ``[B, W]`` int32 DRAFT block-table operand."""
        return h2d(self.draft_tables, self.device)
