"""NUMA-node topology: the paper's §4 cross-socket analysis as a first-class
layer.

The paper shows DSA throughput collapses when the engine, the source, or the
destination sits on a remote socket: every cross-socket segment caps
bandwidth at the UPI link and adds its latency, so the guideline is "keep
the accelerator and BOTH buffers NUMA-local".  This module models that axis
for the GPU port (UPI -> NVLink between cards):

  Node      one NUMA domain: its engine instances and (optionally) its own
            memory-tier table overriding the global ``perfmodel.TIERS``.
  Link      the inter-node interconnect: a bandwidth cap plus added one-way
            latency, charged once per crossing segment.
  Topology  the fabric: N nodes + the link between them, with the hop
            arithmetic ``EngineModel.op_time`` charges cross-node transfers
            with.  ``Topology.single_node()`` is the default everywhere, so
            every pre-existing single-domain call site behaves identically.

Hop counting follows the paper's data path: the engine READS the source and
WRITES the destination, so a transfer crosses the link once per operand that
lives on a different node than the engine — remote source or remote
destination is 1 hop; an engine remote from both buffers (even co-located
ones) pays 2 crossings, the worst placement in the paper's Fig. 13 sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Link:
    """Inter-node interconnect (UPI / NVLink analogue): ``bw`` is the
    per-direction bandwidth cap shared by all crossings, ``lat_s`` the added
    one-way latency per crossing."""

    # NVLink between two H100 cards: 450 GB/s each way (NVIDIA H100 data
    # sheet; not measured, a peer copy needs two cards).  Below one card's
    # sustained copy rate, so a remote placement always caps.
    bw: float = 450e9
    lat_s: float = 0.0  # not measured: no peer on one card

    def __post_init__(self):
        if self.bw <= 0:
            raise ValueError(f"Link.bw must be > 0, got {self.bw}")
        if self.lat_s < 0:
            raise ValueError(f"Link.lat_s must be >= 0, got {self.lat_s}")


@dataclasses.dataclass(frozen=True)
class Node:
    """One NUMA domain: ``n_engines`` DSA-style instances plus an optional
    memory-tier override (entries merge over ``perfmodel.TIERS``, so a node
    can e.g. model slower local DRAM without redefining every tier)."""

    node_id: int
    n_engines: int = 1
    name: str = ""
    tiers: Optional[Dict[str, Dict[str, float]]] = None

    def __post_init__(self):
        if self.node_id < 0:
            raise ValueError(f"Node.node_id must be >= 0, got {self.node_id}")
        if self.n_engines < 1:
            raise ValueError(f"Node.n_engines must be >= 1, got {self.n_engines}")

    @property
    def label(self) -> str:
        return self.name or f"node{self.node_id}"


class Topology:
    """The device fabric: nodes and the link joining them.

    Node ids must be dense 0..N-1 (engines, pools, and telemetry index by
    them).  A 1-node topology never charges the link, which is what makes
    it a drop-in default for every legacy single-domain call site.
    """

    def __init__(self, nodes: Sequence[Node], link: Link = Link()):
        nodes = list(nodes)
        if not nodes:
            raise ValueError("Topology needs at least one Node")
        if sorted(n.node_id for n in nodes) != list(range(len(nodes))):
            raise ValueError(
                f"Node ids must be dense 0..{len(nodes) - 1}, "
                f"got {[n.node_id for n in nodes]}"
            )
        self.nodes: List[Node] = sorted(nodes, key=lambda n: n.node_id)
        self.link = link

    # ------------------------------------------------------------------ builders
    @staticmethod
    def single_node(n_engines: int = 1) -> "Topology":
        """The flat pre-topology world: one node, no link charges."""
        return Topology([Node(0, n_engines=n_engines)])

    @staticmethod
    def symmetric(n_nodes: int, engines_per_node: int = 1,
                  link: Link = Link()) -> "Topology":
        """N identical nodes over one link (dual-socket SPR analogue at
        ``n_nodes=2``)."""
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        return Topology(
            [Node(i, n_engines=engines_per_node) for i in range(n_nodes)], link
        )

    # ------------------------------------------------------------------ geometry
    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def node(self, node_id: int) -> Node:
        return self.nodes[node_id]

    def hops(self, engine_node: int, src_node: int, dst_node: int) -> int:
        """Link crossings for one transfer: the engine reads src and writes
        dst, so each operand on a foreign node costs one crossing."""
        return int(src_node != engine_node) + int(dst_node != engine_node)

    def link_charge(self, engine_node: int, src_node: int,
                    dst_node: int) -> Dict[str, object]:
        """kwargs for ``EngineModel.op_time``: the link and how many times
        this placement crosses it (empty dict when fully local)."""
        h = self.hops(engine_node, src_node, dst_node)
        if h == 0 or self.n_nodes == 1:
            return {}
        return {"link": self.link, "link_hops": h}

    def engine_nodes(self) -> List[int]:
        """Flat node-id list, one entry per engine instance, in build order
        (node-major) — how a Device assigns ``StreamEngine.node_id``."""
        out: List[int] = []
        for n in self.nodes:
            out.extend([n.node_id] * n.n_engines)
        return out

    def __repr__(self) -> str:
        shape = "+".join(str(n.n_engines) for n in self.nodes)
        return (f"Topology({self.n_nodes} nodes x [{shape}] engines, "
                f"link={self.link.bw / 1e9:.0f}GB/s +{self.link.lat_s * 1e6:.1f}us)")
