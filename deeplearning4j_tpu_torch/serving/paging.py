"""Host-side KV paging: refcounted page allocator + radix prefix cache.

A copy of deeplearning4j_tpu/serving/paging.py (host-only: numpy and
hashlib), kept whole so the port imports nothing of the JAX package.

The device side (parallel/serving.py paged section) stores slot KV in
a fixed pool of ``page_size``-token pages addressed through per-slot
block tables. THIS module owns the indices: which physical page backs
which logical page of which slot, who else references it, and which
cached prefix chains can map straight into a new slot's table.

- `PageAllocator` — free list + per-page refcounts over physical
  pages 1..num_pages-1 (page 0 is the device scratch page, never
  handed out). A page is WRITABLE only while its refcount is exactly 1
  (one owner); the engine's copy-on-write guard enforces that before
  every compiled call that writes.
- `RadixPrefixCache` — a trie over token sequences at PAGE
  granularity: each node is one full page of tokens keyed by its
  token tuple under its parent, holding the physical page whose K/V
  rows those tokens produced. On admission the longest cached chain
  matching the new request's prefix maps those pages into the slot's
  block table (refcount bumped per sharer), so co-tenant traffic
  sharing a system prompt shares both the KV bytes and — because
  prefill resumes from the matched boundary — the prefill compute.
  Only FULL pages are cached (a partial page's tail would be
  overwritten by the sharer — that is what the engine's COW copy is
  for, when a full-prefix match forces re-computing the last token
  inside a shared page). Eviction is LRU over leaf nodes whose page
  nobody but the cache references; interior nodes become evictable as
  their children go. `flush()` drops everything — hot weight reload
  must call it, because cached K/V encodes the weights that wrote it.

Fleet-wide prefix affinity adds the ADVERTISEMENT layer:
every page-aligned prefix chain in the trie carries a deterministic
64-bit `chain hash` (chained blake2b over the page's token bytes, so
two processes hashing the same tokens agree), and `chain_digest()`
compacts the whole cache into a probe-sized summary — the top-K
hottest chains as exact (hash, tokens) pairs plus a small bloom filter
over EVERY chain hash, stamped with a `generation` counter that bumps
on insert/evict/flush so a router can age out stale advertisements.
`chain_hashes()` + `digest_lookup()` are the router-side half: hash a
request's prompt at page granularity and find the deepest advertised
chain. A bloom false positive or an eviction between probe and
dispatch costs one normal prefill — never correctness.

Thread-safety: both classes are driven only under the engine lock
(admission, reap, reload all already serialize on it), so they stay
lock-free themselves.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: Physical page index reserved as the device scratch target for
#: masked/inactive writes — never allocated, never attended.
SCRATCH_PAGE = 0

# ---------------------------------------------------------------------------
# chain hashing + digests (fleet-wide prefix affinity)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
#: the empty chain's hash (root node) — a fixed seed so chain hashes
#: are a pure function of the token content, identical across
#: processes (Python's own hash() is salted per process and would
#: break router<->replica hash agreement)
ROOT_CHAIN_HASH = int.from_bytes(
    hashlib.blake2b(b"dl4j-prefix-chain-v1", digest_size=8).digest(),
    "little")

#: digest shape defaults: K exact chains + an m-bit/k-hash bloom over
#: every chain. At the default geometry 64 cached chains keep the
#: bloom false-positive rate ≈ (1 - e^(-k*n/m))^k ≈ 2.4% — and a
#: false positive only costs the router a mispredicted dispatch that
#: degrades to a normal prefill.
DIGEST_TOP_K = 16
DIGEST_BLOOM_BITS = 512
DIGEST_BLOOM_HASHES = 4


def page_chain_hash(parent_hash: int, key: Sequence[int]) -> int:
    """Hash of the chain ``parent chain + one page of tokens``:
    blake2b over (parent hash || page token bytes), 64-bit."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent_hash).to_bytes(8, "little"))
    h.update(np.asarray(key, np.int32).tobytes())
    return int.from_bytes(h.digest(), "little")


def chain_hashes(tokens: Sequence[int], page_size: int) -> List[int]:
    """Hashes of every page-aligned prefix of ``tokens``:
    ``out[j-1]`` is the hash of the first ``j`` full pages. The
    router computes these ONCE per request and compares against
    advertised digests."""
    toks = np.asarray(tokens, np.int32)
    ps = int(page_size)
    out: List[int] = []
    h = ROOT_CHAIN_HASH
    for j in range(toks.shape[0] // ps):
        h = page_chain_hash(h, toks[j * ps:(j + 1) * ps])
        out.append(h)
    return out


def _mix64(x: int) -> int:
    """splitmix64 finalizer — decorrelates the k bloom probes derived
    from one chain hash."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _bloom_indices(h: int, m: int, k: int):
    for i in range(k):
        yield _mix64(h + i * 0x9E3779B97F4A7C15) % m


def bloom_add(bits: int, h: int, m: int, k: int) -> int:
    for idx in _bloom_indices(h, m, k):
        bits |= 1 << idx
    return bits


def bloom_has(bits: int, h: int, m: int, k: int) -> bool:
    return all((bits >> idx) & 1 for idx in _bloom_indices(h, m, k))


def digest_lookup(digest: Optional[dict],
                  hashes: Sequence[int]) -> Tuple[int, Optional[int]]:
    """The router-side match: given a replica's advertised
    ``chain_digest()`` and a request's page-prefix ``chain_hashes``,
    return ``(cached_tokens, chain_hash)`` for the DEEPEST advertised
    chain prefixing the request — exact top-K entries first, then the
    bloom filter (probabilistic: a false positive costs one normal
    prefill). ``(0, None)`` when nothing matches."""
    if not digest or not hashes:
        return 0, None
    ps = int(digest.get("page_size", 0) or 0)
    if ps <= 0:
        return 0, None
    top = {int(h) for h, _ in digest.get("top", ())}
    for j in range(len(hashes), 0, -1):
        if hashes[j - 1] in top:
            return j * ps, int(hashes[j - 1])
    bloom = digest.get("bloom")
    if bloom:
        bits = int(bloom, 16)
        m = int(digest.get("bloom_m", DIGEST_BLOOM_BITS))
        k = int(digest.get("bloom_k", DIGEST_BLOOM_HASHES))
        if m > 0 and k > 0:
            for j in range(len(hashes), 0, -1):
                if bloom_has(bits, hashes[j - 1], m, k):
                    return j * ps, int(hashes[j - 1])
    return 0, None


class PageAllocator:
    """Free-list allocator with refcounts over pages 1..num_pages-1."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is "
                             f"scratch), got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = np.zeros(num_pages, np.int32)

    @property
    def usable_pages(self) -> int:
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.usable_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self) -> Optional[int]:
        """One fresh page with refcount 1, or None when exhausted."""
        if not self._free:
            return None
        p = self._free.pop()
        self._ref[p] = 1
        return p

    def incref(self, page: int) -> None:
        if page == SCRATCH_PAGE:
            raise ValueError("scratch page cannot be referenced")
        if self._ref[page] <= 0:
            raise ValueError(f"incref on free page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise ValueError(f"decref on free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    # -- chain operations (cross-tier KV handoff) -------------
    def alloc_chain(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, all-or-nothing: either a full chain
        (each page refcount 1) or None with NOTHING allocated — the
        adopt path's no-partial-claim guarantee (a decode-side
        adoption that cannot fit must block or shed, never leave
        orphaned refcounts behind)."""
        if n > len(self._free):
            return None
        return [self.alloc() for _ in range(n)]

    def release_chain(self, pages: Sequence[int]) -> None:
        """Decref every page of a chain — the one call every
        slot-clearing AND handoff-error path shares, so the refcount
        audit has a single choke point."""
        for p in pages:
            self.decref(p)


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used",
                 "chain_hash", "depth")

    def __init__(self, key, page, parent):
        self.key = key                    # tuple of page_size tokens
        self.page = page                  # physical page index
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0
        # every node IS a page-aligned chain (root -> here);
        # its deterministic hash is what digests advertise and what
        # export_cached_chain() is asked for
        self.chain_hash = ROOT_CHAIN_HASH
        self.depth = 0                    # pages from root


class RadixPrefixCache:
    """Page-granular radix/trie prefix cache over token sequences."""

    def __init__(self, page_size: int, allocator: PageAllocator):
        self.page_size = int(page_size)
        self.alloc = allocator
        self._root = _Node((), SCRATCH_PAGE, None)
        self._tick = 0
        self._nodes = 0
        # lifetime stats (the engine mirrors them into counters)
        self.evictions = 0
        # chain-hash index for export_cached_chain() plus
        # the generation counter every digest is stamped with —
        # bumped on insert/evict/flush so a router can tell a live
        # advertisement from a stale one (the idle-replica staleness
        # fix: an unchanged generation means the digest is still
        # exact, a bumped one means re-read it)
        self._by_hash: Dict[int, _Node] = {}
        self._gen = 0
        self._digest_cache: Optional[tuple] = None
        # chain hashes the FLEET is actively advertising
        # (routing by); eviction is biased away from them so a chain
        # another replica may migrate in is not the first thing a
        # local pool squeeze throws away
        self._advertised: frozenset = frozenset()

    def set_advertised(self, hashes) -> int:
        """Replace the fleet-advertised chain-hash set.
        Entries need not exist locally — the set protects whatever
        subset IS cached here. Returns the set's size."""
        self._advertised = frozenset(int(h) for h in hashes)
        return len(self._advertised)

    @property
    def generation(self) -> int:
        return self._gen

    def __len__(self) -> int:
        return self._nodes

    def _chunks(self, tokens: Sequence[int]):
        ps = self.page_size
        for j in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached page chain prefixing ``tokens`` — the
        physical pages, in logical order. Touches the chain for LRU
        recency. The caller owns claiming (incref) what it uses."""
        self._tick += 1
        node, pages = self._root, []
        for key in self._chunks(tokens):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = self._tick
            pages.append(child.page)
            node = child
        return pages

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> int:
        """Record ``tokens``' full-page chain backed by ``pages``
        (the owning slot's block-table pages, logical order). New
        nodes incref their page — the cache becomes a co-owner, which
        is what keeps a freed slot's prefix resident for the next
        tenant. Chunks already cached keep their existing page (a twin
        admitted in the same round just doesn't dedupe). Returns the
        number of pages newly adopted."""
        self._tick += 1
        node, adopted = self._root, 0
        for j, key in enumerate(self._chunks(tokens)):
            child = node.children.get(key)
            if child is None:
                page = int(pages[j])
                self.alloc.incref(page)
                child = _Node(key, page, node)
                child.last_used = self._tick
                child.chain_hash = page_chain_hash(node.chain_hash,
                                                   key)
                child.depth = node.depth + 1
                node.children[key] = child
                self._by_hash[child.chain_hash] = child
                self._nodes += 1
                adopted += 1
            else:
                child.last_used = self._tick
            node = child
        if adopted:
            self._gen += 1
        return adopted

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by dropping LRU leaf entries
        whose page only the cache references (refcount 1 — pages a
        live slot shares are never touched). Eviction is BIASED away
        from fleet-advertised chains: an advertised leaf
        is taken only when no unadvertised candidate exists — a bias,
        not immunity, so a squeezed pool still makes progress.
        Returns pages freed."""
        freed = 0
        while freed < n_pages:
            victim = None
            shielded = None
            for node in self._iter_leaves():
                if self.alloc.refcount(node.page) != 1:
                    continue
                if node.chain_hash in self._advertised:
                    if (shielded is None
                            or node.last_used < shielded.last_used):
                        shielded = node
                    continue
                if victim is None or node.last_used < victim.last_used:
                    victim = node
            if victim is None:
                victim = shielded
            if victim is None:
                break
            self._drop(victim)
            freed += 1
            self.evictions += 1
        if freed:
            self._gen += 1
        return freed

    def _iter_leaves(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                yield n

    def _drop(self, node: _Node) -> None:
        del node.parent.children[node.key]
        if self._by_hash.get(node.chain_hash) is node:
            del self._by_hash[node.chain_hash]
        self._nodes -= 1
        self.alloc.decref(node.page)

    def flush(self) -> int:
        """Drop EVERY entry (decref all cached pages) — the hot-reload
        path: cached K/V encodes the old weights. Returns entries
        dropped."""
        dropped = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.alloc.decref(n.page)
            dropped += 1
        self._root.children.clear()
        self._by_hash.clear()
        self._nodes = 0
        if dropped:
            self._gen += 1
        return dropped

    def stats(self) -> dict:
        return {"entries": self._nodes,
                "page_size": self.page_size,
                "generation": self._gen,
                "evictions": self.evictions}

    # -- advertisement + export -------------------------------------
    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def node_for_hash(self, chain_hash: int) -> Optional[_Node]:
        return self._by_hash.get(int(chain_hash))

    def chain_pages(self, node: _Node) -> List[int]:
        """Physical pages of the chain root -> ``node``, logical
        order."""
        out: List[int] = []
        while node is not None and node.parent is not None:
            out.append(node.page)
            node = node.parent
        out.reverse()
        return out

    def chain_tokens(self, node: _Node) -> np.ndarray:
        """Token ids of the chain root -> ``node`` (full pages)."""
        keys: List[tuple] = []
        while node is not None and node.parent is not None:
            keys.append(node.key)
            node = node.parent
        keys.reverse()
        return np.asarray([t for k in keys for t in k], np.int32)

    def chain_digest(self, top_k: int = DIGEST_TOP_K,
                     bloom_m: int = DIGEST_BLOOM_BITS,
                     bloom_k: int = DIGEST_BLOOM_HASHES) -> dict:
        """The probe-sized advertisement of this cache: the ``top_k``
        hottest chains as exact ``[chain_hash, cached_tokens]`` pairs
        (ranked by recency, then depth — the system-prompt interior
        nodes co-tenant traffic matches through stay hot because
        `match()` touches the whole path) plus a ``bloom_m``-bit
        bloom filter over EVERY chain hash, so deep uncommon chains
        are still findable probabilistically. JSON-pure (ints + a hex
        string) so it rides health probes and worker pipes verbatim.
        Cached per generation: an idle replica's probes cost a dict
        lookup, not a trie walk."""
        key = (self._gen, int(top_k), int(bloom_m), int(bloom_k))
        if self._digest_cache is not None \
                and self._digest_cache[0] == key:
            return self._digest_cache[1]
        nodes = list(self._iter_nodes())
        bits = 0
        for n in nodes:
            bits = bloom_add(bits, n.chain_hash, bloom_m, bloom_k)
        nodes.sort(key=lambda n: (n.last_used, n.depth), reverse=True)
        digest = {
            "generation": int(self._gen),
            "page_size": int(self.page_size),
            "entries": int(self._nodes),
            "top": [[int(n.chain_hash), int(n.depth * self.page_size)]
                    for n in nodes[:max(0, int(top_k))]],
            "bloom_m": int(bloom_m),
            "bloom_k": int(bloom_k),
            "bloom": format(bits, "x") if bits else "",
        }
        self._digest_cache = (key, digest)
        return digest


def pages_for(tokens: int, page_size: int) -> int:
    """Logical pages needed to hold ``tokens`` positions."""
    return -(-int(tokens) // int(page_size))
