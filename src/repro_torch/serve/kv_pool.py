"""Paged KV-cache block allocator (vLLM-style block tables).

The engine's physical KV cache is one flat pool of ``num_blocks`` fixed-size
pages (``block_size`` token positions each); a *sequence* owns an ordered
list of block ids — its block table — covering its logical positions
``[0, len)``. This module is the pure-Python bookkeeping side (no torch):

* **Free-list allocation** — ``allocate`` reserves enough blocks for a
  request's whole lifetime (prompt + generation) up front, so a running
  request can never deadlock on pool memory mid-decode; ``extend`` grows a
  table on demand for drivers that prefer lazy growth; ``free`` returns
  blocks at retirement. Double-free and unknown ids raise.
* **Ref-counted blocks + prefix caching** — full *prompt* blocks are
  content-addressed by a chained key over ``(policy_key, token prefix)``.
  A new request whose prompt (under the same numerics policy!) shares a
  committed prefix adopts those blocks (refcount++) and skips recomputing
  them — ``allocate`` returns ``cached_len`` so the engine starts chunked
  prefill at the first uncached token. Blocks enter the cache only after
  the owner's prefill completes (``commit_prefix``), so a reader can never
  adopt K/V that has not been written yet. K/V depend on the approximation
  policy, hence ``policy_key`` participates in the cache key: a ``free``-tier
  and a ``paid``-tier request never share pages.
* **Eviction** — a cached block whose refcount drops to zero stays in the
  prefix cache but becomes *evictable* (LRU): a later identical prompt can
  still hit it, and the allocator reclaims evictable blocks (oldest first)
  only after the plain free list is exhausted.
* **Fragmentation accounting** — ``stats`` / ``utilization`` report live
  tokens vs. reserved cells vs. pool capacity, the numbers serve_bench.py
  uses to demonstrate the paged pool's memory win over the slot pool
  (a slot pool is the degenerate ``block_size == max_seq`` configuration).

* **Speculative rollback** — speculative decoding writes ``k`` draft
  positions ahead of a sequence's committed length and may keep only a
  prefix of them; ``truncate`` rolls the reservation back, freeing pages
  that cover *only* rejected positions while leaving partially-kept pages
  (their stale cells are overwritten in place by the next decode window).

Writes never need copy-on-write: only *full, committed prompt* blocks are
shared, and no request ever writes at a logical position inside its
(committed) prompt prefix again — decode and speculative drafts append
strictly after it (``truncate`` also refuses to cut into prompt pages).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

SENTINEL = -1  # block-table entry for "no page mapped" (the step drops it)


def blocks_needed(n_tokens: int, block_size: int) -> int:
    """Pages covering ``n_tokens`` logical positions."""
    return max(0, -(-n_tokens // block_size))


@dataclasses.dataclass
class _Sequence:
    blocks: List[int]
    prompt: Tuple[int, ...]
    policy_key: Hashable
    total_len: int          # reserved logical capacity (tokens)
    live_len: int           # tokens actually written so far (fragmentation)
    cached_len: int         # prefix adopted from the cache at allocation
    committed: bool = False


class BlockPool:
    """Allocator + prefix cache over ``num_blocks`` pages of ``block_size``."""

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError(f"BlockPool.num_blocks must be >= 1 "
                             f"(got {num_blocks})")
        if block_size < 1:
            raise ValueError(f"BlockPool.block_size must be >= 1 "
                             f"(got {block_size})")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free: List[int] = list(range(num_blocks))[::-1]  # pop() -> 0,1..
        self._ref: Dict[int, int] = {}
        # content-addressed prompt blocks: key -> block id, and the reverse
        self._prefix: Dict[Hashable, int] = {}
        self._block_key: Dict[int, Hashable] = {}
        # cached blocks with refcount 0, LRU order (oldest first)
        self._evictable: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._seqs: Dict[Hashable, _Sequence] = {}
        self.prefix_queries = 0
        self.prefix_hits = 0      # blocks adopted from the cache
        self.peak_blocks_in_use = 0

    def __contains__(self, seq_id: Hashable) -> bool:
        return seq_id in self._seqs

    # -- capacity ----------------------------------------------------------

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free) - len(self._evictable)

    @property
    def blocks_available(self) -> int:
        """Blocks an ``allocate`` call may claim (free + evictable)."""
        return len(self._free) + len(self._evictable)

    def _prefix_key(self, policy_key: Hashable, prompt: Sequence[int],
                    i: int) -> Hashable:
        # chained by construction: the key of block i embeds the whole
        # token prefix up to its end, so equal keys => equal K/V content
        # under the same policy
        return (policy_key, i, tuple(prompt[:(i + 1) * self.block_size]))

    def _lookup(self, prompt: Sequence[int], policy_key: Hashable
                ) -> List[int]:
        """Longest run of committed cached blocks for this prompt. Never
        covers the full prompt: at least one token is left to prefill so
        the engine can compute first-token logits."""
        hits: List[int] = []
        full = (len(prompt) - 1) // self.block_size  # last token excluded
        for i in range(full):
            bid = self._prefix.get(self._prefix_key(policy_key, prompt, i))
            if bid is None:
                break
            hits.append(bid)
        return hits

    def can_allocate(self, prompt: Sequence[int], total_len: int,
                     policy_key: Hashable = None) -> bool:
        hits = self._lookup(prompt, policy_key)
        evict_hits = sum(1 for b in hits if b in self._evictable)
        need_new = blocks_needed(total_len, self.block_size) - len(hits)
        return need_new <= self.blocks_available - evict_hits

    # -- alloc / extend / free --------------------------------------------

    def _claim_block(self) -> int:
        if self._free:
            bid = self._free.pop()
        else:  # reclaim the least-recently-freed cached block
            bid, _ = self._evictable.popitem(last=False)
            key = self._block_key.pop(bid)
            del self._prefix[key]
        self._ref[bid] = 1
        return bid

    def allocate(self, seq_id: Hashable, prompt: Sequence[int],
                 total_len: int, policy_key: Hashable = None
                 ) -> Optional[Tuple[List[int], int]]:
        """Reserve pages for a sequence of ``total_len`` logical positions.

        Returns ``(block_table, cached_len)`` — ``cached_len`` leading
        prompt tokens are covered by adopted prefix-cache blocks and need no
        recompute — or ``None`` when the pool cannot satisfy the request
        (admission control backpressure; no partial state is changed).
        """
        if seq_id in self._seqs:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        if total_len < 1:
            raise ValueError(f"total_len must be >= 1 (got {total_len})")
        if not self.can_allocate(prompt, total_len, policy_key):
            return None
        self.prefix_queries += 1
        hits = self._lookup(prompt, policy_key)
        self.prefix_hits += len(hits)
        for bid in hits:  # adopt: refcount++, pull out of the evictable LRU
            if bid in self._evictable:
                del self._evictable[bid]
                self._ref[bid] = 1
            else:
                self._ref[bid] += 1
        n = blocks_needed(total_len, self.block_size)
        table = hits + [self._claim_block() for _ in range(n - len(hits))]
        cached_len = len(hits) * self.block_size
        self._seqs[seq_id] = _Sequence(
            blocks=table, prompt=tuple(prompt), policy_key=policy_key,
            total_len=total_len, live_len=cached_len, cached_len=cached_len)
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return list(table), cached_len

    def extend(self, seq_id: Hashable, new_total_len: int
               ) -> Optional[List[int]]:
        """Grow a sequence's reservation to ``new_total_len`` positions.
        Returns the new block table, or ``None`` if the pool is exhausted
        (caller decides: wait, preempt, or reject)."""
        seq = self._seqs[seq_id]
        extra = blocks_needed(new_total_len, self.block_size) - len(seq.blocks)
        if extra <= 0:
            seq.total_len = max(seq.total_len, new_total_len)
            return list(seq.blocks)
        if extra > self.blocks_available:
            return None
        seq.blocks.extend(self._claim_block() for _ in range(extra))
        seq.total_len = new_total_len
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return list(seq.blocks)

    def advance(self, seq_id: Hashable, live_len: int) -> None:
        """Record that ``live_len`` logical positions now hold real K/V
        (utilization accounting only; no allocation happens here)."""
        self._seqs[seq_id].live_len = live_len

    def truncate(self, seq_id: Hashable, keep_len: int) -> int:
        """Logically truncate a sequence to ``keep_len`` positions, freeing
        trailing pages past the kept region (speculative-decode rollback).

        ``extend``-ed pages that ended up covering only *rejected* draft
        positions return to the pool immediately; a partially-kept trailing
        page stays (its rejected cells are overwritten in place by the next
        decode/verify window — attention never reads past the row's write
        position, so stale K/V there is inert). Pages covering the prompt
        are never cut: shared committed prefix blocks keep their refcounts
        and later speculation can never invalidate a prefix-cache hit.
        Returns the number of pages released."""
        seq = self._seqs[seq_id]
        if keep_len < 0:
            raise ValueError(f"keep_len must be >= 0 (got {keep_len})")
        keep_blocks = max(blocks_needed(keep_len, self.block_size),
                          blocks_needed(len(seq.prompt), self.block_size))
        freed = 0
        while len(seq.blocks) > keep_blocks:
            bid = seq.blocks.pop()
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                del self._ref[bid]
                if bid in self._block_key:
                    self._evictable[bid] = None
                else:
                    self._free.append(bid)
            freed += 1
        cover = len(seq.blocks) * self.block_size
        seq.total_len = max(min(seq.total_len, cover), 1)
        seq.live_len = min(seq.live_len, max(keep_len, seq.cached_len))
        return freed

    def commit_prefix(self, seq_id: Hashable) -> int:
        """Publish the sequence's full prompt blocks into the prefix cache
        (call once prefill has written them). Returns #blocks published."""
        seq = self._seqs[seq_id]
        if seq.committed:
            return 0
        seq.committed = True
        published = 0
        full = (len(seq.prompt) - 1) // self.block_size
        for i in range(full):
            bid = seq.blocks[i]
            key = self._prefix_key(seq.policy_key, seq.prompt, i)
            if key in self._prefix or bid in self._block_key:
                continue  # already cached (an adopted block, or a dup)
            self._prefix[key] = bid
            self._block_key[bid] = key
            published += 1
        return published

    def free(self, seq_id: Hashable) -> None:
        """Release the sequence's pages. Cached blocks whose refcount hits
        zero become evictable (still prefix-hittable); uncached ones return
        to the free list."""
        seq = self._seqs.pop(seq_id, None)
        if seq is None:
            raise KeyError(f"sequence {seq_id!r} is not allocated "
                           "(double free?)")
        for bid in seq.blocks:
            self._ref[bid] -= 1
            if self._ref[bid] > 0:
                continue
            del self._ref[bid]
            if bid in self._block_key:
                self._evictable[bid] = None  # newest at the end (LRU front pops)
            else:
                self._free.append(bid)

    # -- accounting --------------------------------------------------------

    def live_tokens(self) -> int:
        return sum(s.live_len for s in self._seqs.values())

    def utilization(self) -> Dict[str, float]:
        """KV memory utilization: live tokens vs reserved cells vs pool.

        ``internal_frag`` is the fraction of *reserved* cells not (yet)
        holding live tokens — the waste a slot pool maximizes and paging
        minimizes."""
        cells = self.num_blocks * self.block_size
        reserved = self.blocks_in_use * self.block_size
        live = self.live_tokens()
        return {
            "pool_util": live / cells if cells else 0.0,
            "reserved_util": reserved / cells if cells else 0.0,
            "internal_frag": (reserved - live) / reserved if reserved else 0.0,
        }

    def stats(self) -> Dict[str, float]:
        return {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.blocks_in_use,
            "blocks_free": len(self._free),
            "blocks_evictable": len(self._evictable),
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            **self.utilization(),
        }
