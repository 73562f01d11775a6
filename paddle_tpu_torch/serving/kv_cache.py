"""KV cache + slot state machine for the serving engine.

Counterpart of ``paddle_tpu/serving/kv_cache.py`` (``KVCacheManager``,
``PagedKVCacheManager`` with the draft-model tenant, and the host-RAM
tier ``BlockStore``; block-chain import for disaggregation is not ported
yet).  The manager owns the per-slot facts the scheduler reads and the
device steps consume:

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

``BlockStore`` is the HOST-RAM tier below the pool: when the allocator
reclaims a registered EVICTABLE chain, its block data is *demoted*
instead of destroyed — gathered off the pool on the device at eviction
(``export_chain``, enqueued on the stream, so it runs before any later
write to the freed blocks) and copied to the host by the engine's
between-steps pump (``pump_host_tier``: every staged gather of a pump in
one device-to-host copy, ``_kv_transfer``).  Store entries are keyed by
CONTENT (``chunk_keys``: the nested spelling of the whole token prefix),
hold numpy leaves (bf16 data as its int16 bits), carry a CRC32 taken at
insert, and live under an LRU and a byte budget that evicts a whole
subtree at a time.  At admission ``restore_from_host`` validates the
host continuation of a prompt and copies it into freshly allocated,
EVICTABLE-registered blocks (``kv_transfer``: host to device through
``core/device.h2d``, then one in-place ``index_copy_`` per pool leaf), so
the ordinary radix match adopts them: a restore is a copy, never a
suffix prefill, and no kernel runs.  The host bookkeeping is a
line-for-line port, so the same calls store, evict and reject the same
entries as the reference.

Under tensor parallelism (``serving/sharding.py``) each rank's manager
is built with the rank's ``num_kv_heads / N`` heads, so its caches and
pools — int8 scale leaves and the draft tenant's layers included — hold
only the rank's heads (``kv_cache_pspec``: the head axis, index 2 in both
geometries).  The host bookkeeping is identical on every rank, so the
ranks hand out the same slots and the same block ids.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.device import h2d
from paddle_tpu_torch.ops.decode_attention import (
    init_kv_cache, init_kv_pool, kv_data,
)

__all__ = ["BlockStore", "KVCacheManager", "PagedKVCacheManager",
           "KVPoolExhausted", "chunk_keys"]

#: the host dtype a pool leaf's bytes are kept in (numpy has no bfloat16:
#: its bits ride as int16)
_HOST_DTYPE = {torch.bfloat16: torch.int16}


def chunk_keys(tokens, block):
    """Content keys for every FULL ``block``-sized chunk of ``tokens``:
    the nested ``(parent_key, chunk)`` spelling — the whole token prefix
    up to and including each chunk, hashable, with shared structure
    between a chain and its extensions.  Keying the host tier by content
    (not device block ids) lets a chain whose ancestors still live in the
    pool match its demoted continuation."""
    keys, key = [], None
    block = int(block)
    for k in range(len(tokens) // block):
        chunk = tuple(int(t) for t in tokens[k * block:(k + 1) * block])
        key = (key, chunk)
        keys.append(key)
    return keys


def _walk(leaf, fn):
    """``fn`` over every array of one cache leaf (a tensor / array or an
    int8 ``(data, scale)`` pair), keeping the tuple structure."""
    if isinstance(leaf, tuple):
        return tuple(_walk(x, fn) for x in leaf)
    return fn(leaf)


def _kv_transfer(staged):
    """Device -> host half of the tier boundary: every staged demotion
    gather of one pump (a list of per-layer ``(k, v)`` leaf lists) copied
    to the host in ONE transfer — the bytes of all of them concatenated
    on the device, copied once (the pump's one wait, between scheduler
    steps, long after the gathers ran), and cut back into numpy arrays
    the store owns.  Called only from ``pump_host_tier``."""
    flat = []
    for leaves in staged:
        for k, v in leaves:
            _walk((k, v), flat.append)
    host = torch.cat([t.reshape(-1).view(torch.uint8) for t in flat]).cpu()
    arrs, off = [], 0
    for t in flat:
        nb = t.numel() * t.element_size()
        part = host[off:off + nb].view(_HOST_DTYPE.get(t.dtype, t.dtype))
        arrs.append(part.reshape(t.shape).numpy())
        off += nb
    it = iter(arrs)
    return [[_walk((k, v), lambda _: next(it)) for k, v in leaves]
            for leaves in staged]


def kv_transfer(caches, ids, leaves):
    """Host -> device half: copy host-tier block data ``leaves`` (per
    layer ``(k, v)`` numpy leaves stacked over the blocks) into pool
    blocks ``ids`` — each leaf through ``h2d`` and one in-place
    ``index_copy_`` along the block axis.  Shapes and addresses of the
    pool are untouched.  Called only from ``restore_from_host``, at
    admission, between steps."""
    dev = kv_data(caches[0][0]).device
    idx = h2d(np.asarray(ids, np.int64), dev)

    def put(pool, leaf):
        if isinstance(pool, tuple):
            for p, x in zip(pool, leaf):
                put(p, x)
            return
        pool.index_copy_(0, idx, h2d(leaf, dev).view(pool.dtype))
    for (kc, vc), (lk, lv) in zip(caches, leaves):
        put(kc, lk)
        put(vc, lv)
    return caches


def _leaf_nbytes(leaf):
    if isinstance(leaf, tuple):
        return sum(_leaf_nbytes(x) for x in leaf)
    return int(leaf.nbytes)


def _leaf_crc(leaf, crc=0):
    if isinstance(leaf, tuple):
        for x in leaf:
            crc = _leaf_crc(x, crc)
        return crc
    return zlib.crc32(np.ascontiguousarray(leaf).tobytes(), crc)


def _leaf_spec_of(leaf):
    if isinstance(leaf, tuple):
        return tuple(_leaf_spec_of(x) for x in leaf)
    return (tuple(leaf.shape), str(leaf.dtype))


class BlockStore:
    """Host-RAM demotion tier for evicted prefix chains.

    A radix map over CONTENT keys (``chunk_keys``) holding one KV block's
    per-layer ``(k, v)`` numpy leaves per entry — ``[C, Hkv, D]`` data
    plus ``[C, Hkv]`` scales on int8 pools — under its own LRU and byte
    budget:

    * ``put`` inserts one block's leaves; when the budget overflows, the
      least-recently-used entry AND its registered descendants are
      evicted first (a child is only matchable through its parent).  An
      entry bigger than the whole budget is rejected.
    * ``fetch`` validates the entry against the pool's expected leaf
      structure and the CRC32 taken at insert; a mismatch (a truncated
      or garbled chain — ``FaultPlan(host_tier_corrupt=...)``) drops the
      entry's subtree, counts ``stats["errors"]`` and returns None, so
      wrong bytes are never copied into a pool — the caller falls back
      to suffix prefill.
    * ``has`` is a pure probe (no LRU touch).

    Host bookkeeping only; the device halves of demotion and restore are
    ``_kv_transfer`` / ``kv_transfer``.  One store may serve several
    managers whose block sizes agree.
    """

    def __init__(self, max_bytes, block):
        self.max_bytes = int(max_bytes)
        self.block = int(block)
        if self.max_bytes < 0:
            raise ValueError("BlockStore max_bytes must be >= 0")
        if self.block <= 0:
            raise ValueError("BlockStore block must be > 0")
        self._data = {}     # key -> per-layer [(k, v)] numpy leaves
        self._nbytes = {}   # key -> payload bytes
        self._crc = {}      # key -> crc32 at insert
        self._kids = {}     # parent key -> set(child keys)
        self._lru = {}      # key -> tick
        self._tick = 0
        self.total_bytes = 0
        self.stats = {"demoted": 0, "restored": 0, "evicted": 0,
                      "rejected": 0, "errors": 0}

    @property
    def n_blocks(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def has(self, key):
        """Pure presence probe — no LRU touch."""
        return key in self._data

    @staticmethod
    def key_digest(key):
        """Short stable hex digest of a content key for events and logs."""
        return format(zlib.crc32(repr(key).encode()), "08x")

    def nbytes_of(self, key):
        return self._nbytes.get(key, 0)

    # ------------------------------------------------------------ mutation
    def _drop_subtree(self, key, stat):
        """Remove ``key`` and every registered descendant; returns the
        dropped keys.  ``stat`` names the stats counter to charge."""
        dropped, stack = [], [key]
        while stack:
            k = stack.pop()
            stack.extend(self._kids.pop(k, ()))
            if k not in self._data:
                continue
            del self._data[k]
            self.total_bytes -= self._nbytes.pop(k)
            self._crc.pop(k, None)
            self._lru.pop(k, None)
            kids = self._kids.get(k[0])
            if kids is not None:
                kids.discard(k)
            dropped.append(k)
            self.stats[stat] += 1
        return dropped

    def put(self, key, leaves):
        """Insert one block's per-layer leaves under content ``key``.
        Returns ``(stored, evicted_keys)``: LRU entries (with subtrees)
        evicted to make room, or ``stored=False`` when the entry alone
        exceeds the budget (counted ``rejected``).  Re-inserting a present
        key refreshes its LRU tick and payload."""
        nb = sum(_leaf_nbytes(k) + _leaf_nbytes(v) for k, v in leaves)
        evicted = []
        if nb > self.max_bytes:
            self.stats["rejected"] += 1
            return False, evicted
        if key in self._data:
            self.total_bytes -= self._nbytes[key]
        while self.total_bytes + nb > self.max_bytes:
            victim = min(self._lru, key=self._lru.get)
            evicted.extend(self._drop_subtree(victim, "evicted"))
        self._data[key] = leaves
        self._nbytes[key] = nb
        self._crc[key] = _leaf_crc(tuple(leaves))
        self._kids.setdefault(key[0], set()).add(key)
        self.total_bytes += nb
        self._tick += 1
        self._lru[key] = self._tick
        self.stats["demoted"] += 1
        return True, evicted

    def fetch(self, key, spec=None):
        """The entry's leaves, validated — or None (absent, or corrupt:
        structure / shape / dtype mismatch against ``spec`` or a CRC
        mismatch; the bad entry's subtree is dropped and ``errors``
        counted)."""
        entry = self._data.get(key)
        if entry is None:
            return None
        ok = True
        if spec is not None:
            ok = (len(entry) == len(spec)
                  and all(_leaf_spec_of(k) == sk and _leaf_spec_of(v) == sv
                          for (k, v), (sk, sv) in zip(entry, spec)))
        if ok:
            ok = _leaf_crc(tuple(entry)) == self._crc.get(key)
        if not ok:
            self._drop_subtree(key, "errors")
            return None
        self._tick += 1
        self._lru[key] = self._tick
        self.stats["restored"] += 1
        return entry

    # --------------------------------------------------------- fault seam
    def corrupt(self, key=None, mode="truncate"):
        """Test-only damage seam (``FaultPlan.host_tier_corrupt``):
        truncate (drop the last cached row of every leaf — a structural
        mismatch ``fetch`` catches against the pool spec) or garble (flip
        payload bytes in place, leaving the insert-time CRC stale) the
        entry at ``key``, or every entry when ``key`` is None.  Returns
        the number of entries damaged."""
        if mode not in ("truncate", "garble"):
            raise ValueError(f"unknown corruption mode {mode!r}")
        keys = [key] if key is not None else list(self._data)
        n = 0
        for k in keys:
            entry = self._data.get(k)
            if entry is None:
                continue
            if mode == "truncate":
                self._data[k] = [(_walk(kk, lambda x: x[:-1]),
                                  _walk(vv, lambda x: x[:-1]))
                                 for kk, vv in entry]
            else:
                def garble(leaf):
                    if isinstance(leaf, tuple):
                        return (garble(leaf[0]),) + tuple(leaf[1:])
                    out = np.array(leaf)
                    raw = out.reshape(-1).view(np.uint8)
                    raw[: min(8, raw.size)] ^= 0xFF
                    return out
                kk, vv = entry[0]
                entry[0] = (garble(kk), vv)
            n += 1
        return n

    # ------------------------------------------------------- introspection
    def snapshot(self):
        """JSON-ready occupancy and stats view for debug endpoints."""
        return {"max_bytes": self.max_bytes, "block": self.block,
                "n_blocks": self.n_blocks,
                "total_bytes": self.total_bytes,
                "stats": dict(self.stats)}


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
                 on_event=None, host_store=None):
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
        # the host tier (BlockStore): eviction demotes instead of
        # destroying; staged (keys, device leaves) pairs wait here for the
        # engine's between-steps pump
        if host_store is not None and host_store.block != self.block:
            raise ValueError(
                f"host tier block size ({host_store.block}) must match "
                f"the pool block size ({self.block}): content keys are "
                "chunked at the block width")
        self._host = host_store
        self._pending_demote = []

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
    def _content_key(self, b):
        """The host-tier content key of registered block ``b``: its chunk
        path from the radix root, spelled as ``chunk_keys`` nests it."""
        parts = []
        while b != -1:
            parent, chunk = self._key_of[b]
            parts.append(chunk)
            b = parent
        key = None
        for chunk in reversed(parts):
            key = (key, chunk)
        return key

    def _evict_subtree(self, root):
        """Reclaim evictable ``root`` and every registered descendant (all
        refcount 0 by the chain invariant) to the free list.  With a host
        tier this DEMOTES: the subtree's blocks not already in the store
        are gathered off the pool here (``export_chain``, enqueued on the
        stream ahead of any later write to the freed blocks) and staged
        with their content keys for ``pump_host_tier``."""
        parent = self._key_of[root][0]
        self._kids.get(parent, set()).discard(root)
        demote = self._host is not None
        stack = [(root, self._content_key(root) if demote else None)]
        n, order, keys = 0, [], []
        while stack:
            b, ck = stack.pop()
            if self.refcnt[b] != 0:
                raise RuntimeError(
                    f"prefix chain invariant broken: evicting block {b} "
                    f"with refcount {int(self.refcnt[b])}")
            for kid in self._kids.pop(b, ()):
                stack.append(
                    (kid, (ck, self._key_of[kid][1]) if demote else None))
            if demote and not self._host.has(ck):
                order.append(b)
                keys.append(ck)
            self._node.pop(self._key_of.pop(b), None)
            self._lru.pop(b, None)
            self._free.append(b)
            n += 1
            self._emit("block_free", block=int(b), evicted=True)
        if order:
            self._pending_demote.append((keys, self.export_chain(order)))
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

    # ---------------------------------------------------------- host tier
    @property
    def host_tier(self):
        """The attached ``BlockStore`` (None: eviction destroys)."""
        return self._host

    def _block_spec(self):
        """Expected per-block leaf structure for host-tier validation:
        per-layer ``(k, v)`` of ``(shape, host dtype)`` over ONE block's
        rows (tuple-nested on int8 pools)."""
        def spec(leaf):
            dt = _HOST_DTYPE.get(leaf.dtype, leaf.dtype)
            return (tuple(leaf.shape[1:]),
                    str(torch.empty((), dtype=dt).numpy().dtype))
        return [(_walk(k, spec), _walk(v, spec)) for k, v in self.caches]

    def host_match(self, tokens, matched_tokens):
        """Host-tier tokens CONTINUING a device match of
        ``matched_tokens``: contiguous chunks present in the store from the
        device break on, capped like ``match_prefix``.  Pure probe."""
        if self._host is None:
            return 0
        cap = max(0, (len(tokens) - 1) // self.block)
        k0 = int(matched_tokens) // self.block
        n = 0
        for k, key in enumerate(chunk_keys(tokens[:cap * self.block],
                                           self.block)):
            if k < k0:
                continue
            if not self._host.has(key):
                break
            n += 1
        return n * self.block

    def restore_from_host(self, tokens, rid=None, min_blocks=1):
        """Copy the host-tier continuation of ``tokens`` into freshly
        allocated, EVICTABLE-registered blocks; returns blocks restored.
        The caller re-runs ``match_prefix`` and adopts through the
        ordinary radix path — restored blocks enter the state a released
        registered chain parks in (refcount 0, a fresh LRU tick).

        Chains shorter than ``min_blocks`` are left to suffix prefill.  A
        validation failure stops the walk at the bad chunk, emits
        ``host_error`` and leaves earlier blocks to restore — wrong bytes
        are never copied in.  Allocation stops rather than evict a block
        of the chain being extended (or just restored)."""
        if self._host is None:
            return 0
        cap = max(0, (len(tokens) - 1) // self.block)
        keys = chunk_keys(tokens[:cap * self.block], self.block)
        parent, k0, protected = -1, 0, set()
        for k, key in enumerate(keys):
            b = self._node.get((parent, key[1]))
            if b is None:
                break
            parent = b
            protected.add(b)
            k0 = k + 1
        spec = self._block_spec()
        entries, errors = [], 0
        for k in range(k0, cap):
            if not self._host.has(keys[k]):
                break
            leaves = self._host.fetch(keys[k], spec)
            if leaves is None:
                errors += 1
                self._emit("host_error", rid=rid,
                           key=BlockStore.key_digest(keys[k]))
                break
            entries.append((keys[k][1], leaves))
        if not errors and len(entries) < max(1, int(min_blocks)):
            return 0
        if not entries:
            return 0
        blocks = []
        for _ in entries:
            if not self._free:
                if not self._lru:
                    break
                if min(self._lru, key=self._lru.get) in protected:
                    break
            blocks.append(self.alloc_block())
            protected.add(blocks[-1])
        entries = entries[:len(blocks)]
        if not blocks:
            return 0

        def stack(li, which):
            parts = [e[1][li][which] for e in entries]
            if isinstance(parts[0], tuple):
                return tuple(np.stack([p[j] for p in parts])
                             for j in range(len(parts[0])))
            return np.stack(parts)
        kv_transfer(self.caches, blocks,
                    [(stack(li, 0), stack(li, 1))
                     for li in range(len(self.caches))])
        nbytes = 0
        for b, (chunk, leaves) in zip(blocks, entries):
            key = (parent, chunk)
            self._node[key] = b
            self._key_of[b] = key
            self._kids.setdefault(parent, set()).add(b)
            self.refcnt[b] = 0
            self._tick += 1
            self._lru[b] = self._tick
            parent = b
            nbytes += sum(_leaf_nbytes(kk) + _leaf_nbytes(vv)
                          for kk, vv in leaves)
        self._emit("restore", rid=rid, n_blocks=len(blocks), bytes=nbytes,
                   key=BlockStore.key_digest(self._content_key(blocks[0])))
        return len(blocks)

    def pump_host_tier(self):
        """Copy every staged demotion into the host store — called by the
        engine BETWEEN scheduler steps, never inside the dispatch loop
        (one device-to-host transfer for all of them, ``_kv_transfer``).
        Returns blocks demoted."""
        if self._host is None or not self._pending_demote:
            return 0
        staged, self._pending_demote = self._pending_demote, []
        hosts = _kv_transfer([leaves for _, leaves in staged])
        demoted = 0
        for (keys, _), host in zip(staged, hosts):
            stored_n, stored_bytes = 0, 0
            for i, key in enumerate(keys):
                per_block = [(_walk(kk, lambda x: np.array(x[i])),
                              _walk(vv, lambda x: np.array(x[i])))
                             for kk, vv in host]
                stored, evicted = self._host.put(key, per_block)
                for ek in evicted:
                    self._emit("host_evict",
                               key=BlockStore.key_digest(ek))
                if stored:
                    stored_n += 1
                    stored_bytes += self._host.nbytes_of(key)
            if stored_n:
                demoted += stored_n
                self._emit("demote", n_blocks=stored_n,
                           bytes=stored_bytes,
                           key=BlockStore.key_digest(keys[0]))
        return demoted

    def corrupt_host(self, tokens=None, mode="truncate"):
        """Damage the host-tier entries along ``tokens``'s chunk chain (or
        every entry when None) — the manager half of the
        ``FaultPlan(host_tier_corrupt=...)`` seam.  Returns entries
        damaged."""
        if self._host is None:
            return 0
        if tokens is None:
            return self._host.corrupt(None, mode=mode)
        n = 0
        for key in chunk_keys(tokens, self.block):
            if self._host.has(key):
                n += self._host.corrupt(key, mode=mode)
        return n

    def export_chain(self, blocks):
        """Gather ``blocks``'s rows out of every pool leaf -> per-layer
        ``(k, v)`` leaves (``[n, C, Hkv, D]`` data, plus ``[n, C, Hkv]``
        scales on int8 pools), on the device: the gather is enqueued on
        the stream, so the source blocks may be released and rewritten
        right after this returns."""
        for b in blocks:
            self._check_block(int(b))
        ids = h2d(np.asarray(blocks, np.int64), self.device)
        return [(_walk(k, lambda x: x.index_select(0, ids)),
                 _walk(v, lambda x: x.index_select(0, ids)))
                for k, v in self.caches]

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
