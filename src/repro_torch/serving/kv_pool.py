"""Paged KV storage: a NUMA-sharded device page pool over a host spill tier.

The DSA mapping (DESIGN.md §2): pages are the transfer granule; swapping a
sequence's pages between tiers is a BATCH DESCRIPTOR of page copies executed
as one ``batch_copy`` kernel launch (paper F2), and tier choice follows G4
(the faster-write tier holds the hot working set).  The topology layer
(core/topology.py) adds the paper's §4 axis: the device pool is SHARDED
across NUMA nodes — every page-table entry carries its home node, each pool
slab is registered with the device's buffer-locality registry (so swap
descriptors derive src/dst nodes and the ``numa_local`` policy can keep the
engine next to the data), and a multi-node swap batches per node: one batch
descriptor per (node, direction) pair, never one descriptor mixing nodes.

Pages are [page_tokens, kv_dim] slabs; a sequence owns an ordered page list
in the page table.  This is the state layer under the Vhost-style serving
pipeline.  Pools are written IN PLACE (the reference's functional updates
mint new arrays); a failed swap restores the free lists, and the pages it
may have half-written are free pages, whose contents nothing reads.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.topology import Topology
from repro_torch.kernels import ops as kops


@dataclasses.dataclass
class PoolStats:
    device_pages_used: int = 0
    host_pages_used: int = 0
    swaps_in: int = 0
    swaps_out: int = 0
    batch_copies: int = 0
    pages_moved: int = 0
    cross_node_swaps: int = 0  # swaps whose src and dst homes differ
    copy_fallbacks: int = 0  # engine path failed -> sync kops.batch_copy (the CUDA kernel)


class PagedKVPool:
    """NUMA-sharded two-tier page pool.  The per-node 'device' pools and the
    'host' pool are all tensors on the engine's device (the Device's, else
    CUDA): the host tier is modelled, as in the reference, and every swap is
    a ``batch_copy_pages`` launch.

    ``n_device_pages`` is the FABRIC total, split as evenly as possible
    across the topology's nodes (earlier nodes take the remainder).  The
    default single-node topology reproduces the old flat pool exactly.
    """

    def __init__(self, n_device_pages: int, n_host_pages: int, page_tokens: int,
                 kv_dim: int, dtype=torch.bfloat16, device=None,
                 topology: Optional[Topology] = None, host_node: int = 0):
        self.page_tokens = page_tokens
        self.kv_dim = kv_dim
        self.device = device  # optional Device: swaps become engine descriptors
        self.topology = (topology
                         or (device.topology if device is not None else None)
                         or Topology.single_node())
        n_nodes = self.topology.n_nodes
        if not 0 <= host_node < n_nodes:
            raise ValueError(f"host_node {host_node} out of range for "
                             f"{n_nodes}-node topology")
        self.host_node = host_node
        base, extra = divmod(n_device_pages, n_nodes)
        self._node_pages = [base + (1 if n < extra else 0) for n in range(n_nodes)]
        where = (device.engines[0].device if device is not None else resolve_device(None))
        self.device_pools: List[torch.Tensor] = [
            torch.zeros((p, page_tokens, kv_dim), dtype=dtype, device=where)
            for p in self._node_pages
        ]
        self.host_pool = torch.zeros((n_host_pages, page_tokens, kv_dim), dtype=dtype,
                                     device=where)
        self._free_device: List[List[int]] = [
            list(range(p))[::-1] for p in self._node_pages
        ]
        self._free_host = list(range(n_host_pages))[::-1]
        # seq_id -> list of (tier, node, page_idx) in order
        self.page_table: Dict[int, List[Tuple[str, int, int]]] = {}
        self.stats = PoolStats()
        if self.device is not None:
            for n, pool in enumerate(self.device_pools):
                self.device.register(pool, n)
            self.device.register(self.host_pool, self.host_node)

    # ------------------------------------------------------------------ pool state
    @property
    def device_pool(self) -> torch.Tensor:
        """Single-node compatibility view (the old flat-pool attribute)."""
        if self.topology.n_nodes != 1:
            raise AttributeError(
                "device_pool is ambiguous on a multi-node pool; "
                "use device_pools[node]"
            )
        return self.device_pools[0]

    def _set_device_pool(self, node: int, pool: torch.Tensor):
        """Replace one node's slab, keeping the locality registry current."""
        self.device_pools[node] = pool
        if self.device is not None:
            self.device.register(pool, node)

    def _set_host_pool(self, pool: torch.Tensor):
        self.host_pool = pool
        if self.device is not None:
            self.device.register(pool, self.host_node)

    def free_device_pages(self, node: Optional[int] = None) -> int:
        if node is not None:
            return len(self._free_device[self._check_node(node)])
        return sum(len(f) for f in self._free_device)

    def _check_node(self, node: int) -> int:
        """Range-check a caller-supplied node id BEFORE any free-list pops:
        a bad pin must fail cleanly, not alias via negative indexing or
        blow up mid-commit after state has already moved."""
        if not 0 <= node < self.topology.n_nodes:
            raise ValueError(f"node {node} out of range for "
                             f"{self.topology.n_nodes}-node pool")
        return node

    # ------------------------------------------------------------------ alloc
    def alloc(self, seq_id: int, n_pages: int, tier: str = "device",
              node: Optional[int] = None) -> bool:
        """Reserve pages.  Device pages come from ``node`` when pinned, else
        greedily from the freest nodes (locality beats striping: a sequence
        lands on as few nodes as possible)."""
        if tier == "host":
            if len(self._free_host) < n_pages:
                return False
            pages = [self._free_host.pop() for _ in range(n_pages)]
            self.page_table.setdefault(seq_id, []).extend(
                ("host", self.host_node, p) for p in pages)
            self._count()
            return True
        candidates = ([self._check_node(node)] if node is not None
                      else sorted(range(self.topology.n_nodes),
                                  key=lambda n: -len(self._free_device[n])))
        if sum(len(self._free_device[n]) for n in candidates) < n_pages:
            return False
        entries: List[Tuple[str, int, int]] = []
        remaining = n_pages
        for n in candidates:
            take = min(remaining, len(self._free_device[n]))
            entries.extend(("device", n, self._free_device[n].pop())
                           for _ in range(take))
            remaining -= take
            if not remaining:
                break
        self.page_table.setdefault(seq_id, []).extend(entries)
        self._count()
        return True

    def free(self, seq_id: int):
        for tier, node, p in self.page_table.pop(seq_id, []):
            if tier == "device":
                self._free_device[node].append(p)
            else:
                self._free_host.append(p)
        self._count()

    def _count(self):
        self.stats.device_pages_used = (
            sum(self._node_pages) - sum(len(f) for f in self._free_device)
        )
        self.stats.host_pages_used = self.host_pool.shape[0] - len(self._free_host)

    # ------------------------------------------------------------------ page IO
    def write_page(self, seq_id: int, page_no: int, data: torch.Tensor):
        tier, node, idx = self.page_table[seq_id][page_no]
        pool = self.device_pools[node] if tier == "device" else self.host_pool
        pool[idx] = data.to(pool.device, pool.dtype)

    def read_pages(self, seq_id: int) -> torch.Tensor:
        out = []
        for tier, node, idx in self.page_table[seq_id]:
            pool = self.device_pools[node] if tier == "device" else self.host_pool
            out.append(pool[idx])
        return torch.cat(out, dim=0)

    # ------------------------------------------------------------------ tier moves (batch descriptors)
    def _batch_copy(self, src_pool, dst_pool, src_idx, dst_idx, dst_node=None):
        """One per-node batch descriptor through the engine, falling back to
        the synchronous kernel when the offload path fails (QueueFull after
        backoff, engine error): a saturated fabric degrades to a slow swap,
        never a lost one.  Registered pools let the descriptor derive its
        src/dst nodes; ``dst_node`` homes the destination pool explicitly, so
        every per-node batch keeps its cross-node link charge.  Both paths
        write ``dst_pool`` in place and launch the CUDA kernel on CUDA
        pools."""
        if self.device is not None:
            try:
                return self.device.batch_copy_async(
                    src_pool, dst_pool, src_idx, dst_idx, producer="kv-pool",
                    node=dst_node,
                ).result()
            except Exception:  # noqa: BLE001  # dsalint: disable=DSA104 — counted fallback to the sync copy path
                self.stats.copy_fallbacks += 1
        return kops.batch_copy(src_pool, dst_pool, src_idx, dst_idx)

    def swap_out(self, seq_id: int) -> bool:
        """Device -> host: one batch descriptor PER SOURCE NODE.  Free-list
        pops are restored if any copy fails, so a raising batch copy leaks
        no pages (the pools and page table only commit after every copy
        succeeded)."""
        entries = self.page_table.get(seq_id, [])
        by_node: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for slot, (tier, node, p) in enumerate(entries):
            if tier == "device":
                by_node[node].append((slot, p))
        total = sum(len(g) for g in by_node.values())
        if not total:
            return True
        if len(self._free_host) < total:
            return False
        host_pages = [self._free_host.pop() for _ in range(total)]
        plan: List[Tuple[int, List[Tuple[int, int]], List[int]]] = []
        cursor = 0
        for node in sorted(by_node):
            group = by_node[node]
            plan.append((node, group, host_pages[cursor:cursor + len(group)]))
            cursor += len(group)
        try:
            new_host = self.host_pool
            for node, group, dst in plan:
                src_idx = torch.tensor([p for _, p in group], dtype=torch.int32)
                dst_idx = torch.tensor(dst, dtype=torch.int32)
                new_host = self._batch_copy(self.device_pools[node], new_host,
                                            src_idx, dst_idx,
                                            dst_node=self.host_node)
        except Exception:
            # restore the pops in reverse so the free list is byte-identical
            self._free_host.extend(reversed(host_pages))
            raise
        self._set_host_pool(new_host)
        for node, group, dst in plan:
            for (slot, p), hp in zip(group, dst):
                entries[slot] = ("host", self.host_node, hp)
                self._free_device[node].append(p)
        self.stats.swaps_out += 1
        self.stats.batch_copies += len(plan)
        self.stats.cross_node_swaps += sum(
            1 for n, _, _ in plan if n != self.host_node)
        self.stats.pages_moved += total
        self._count()
        return True

    def swap_in(self, seq_id: int, node: Optional[int] = None) -> bool:
        """Host -> device: one batch descriptor PER DESTINATION NODE, for
        scheduling a sequence.  ``node`` pins the landing node; otherwise
        pages land greedily on the freest nodes.  Same no-leak contract as
        ``swap_out``: pops restore on failure, state commits on success."""
        entries = self.page_table.get(seq_id, [])
        host = [(slot, p) for slot, (t, _n, p) in enumerate(entries) if t == "host"]
        if not host:
            return True
        candidates = ([self._check_node(node)] if node is not None
                      else sorted(range(self.topology.n_nodes),
                                  key=lambda n: -len(self._free_device[n])))
        if sum(len(self._free_device[n]) for n in candidates) < len(host):
            return False
        popped: Dict[int, List[int]] = defaultdict(list)
        plan: List[Tuple[int, List[Tuple[int, int]], List[int]]] = []
        cursor = 0
        for n in candidates:
            take = min(len(host) - cursor, len(self._free_device[n]))
            if not take:
                continue
            dst = [self._free_device[n].pop() for _ in range(take)]
            popped[n] = dst
            plan.append((n, host[cursor:cursor + take], dst))
            cursor += take
            if cursor == len(host):
                break
        try:
            new_pools: Dict[int, torch.Tensor] = {}
            for n, group, dst in plan:
                src_idx = torch.tensor([p for _, p in group], dtype=torch.int32)
                dst_idx = torch.tensor(dst, dtype=torch.int32)
                new_pools[n] = self._batch_copy(
                    self.host_pool, new_pools.get(n, self.device_pools[n]),
                    src_idx, dst_idx, dst_node=n)
        except Exception:
            for n, dst in popped.items():
                self._free_device[n].extend(reversed(dst))
            raise
        for n, pool in new_pools.items():
            self._set_device_pool(n, pool)
        for n, group, dst in plan:
            for (slot, p), dp in zip(group, dst):
                entries[slot] = ("device", n, dp)
                self._free_host.append(p)
        self.stats.swaps_in += 1
        self.stats.batch_copies += len(plan)
        self.stats.cross_node_swaps += sum(
            1 for n, _, _ in plan if n != self.host_node)
        self.stats.pages_moved += len(host)
        self._count()
        return True
