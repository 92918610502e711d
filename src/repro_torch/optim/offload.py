"""Optimizer-state offload to the host tier (paper G4: the engine is the
mover for cross-tier bulk data; CXL tier -> GPU host DRAM).

AdamW moments are read+written once per step; parking them in host memory
between steps frees 8 bytes/param of HBM at the cost of 2 transfers/step
through the streaming engine.  ``plan()`` does the paper-style napkin math
(G4 + the port's H100 tier constants) to decide whether the trade is
profitable for a given step time; ``offload()/fetch()`` execute the moves
via engine descriptors (on real hardware these are device<->host DMAs; here
the tier is simulated: the copies stay on the engine's device, the byte
accounting and timing model are real).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import tree as _tree
from repro_torch.core.descriptor import OpType, WorkDescriptor
from repro_torch.core.device import Device, Future
from repro_torch.core.perfmodel import DEFAULT_MODEL


@dataclasses.dataclass
class OffloadPlan:
    hbm_freed_bytes: int
    transfer_s_per_step: float
    profitable_below_step_s: float  # if step time exceeds this, offload hides

    def hides_under(self, step_time_s: float) -> bool:
        """True when the H2D prefetch of the moments fits under one step
        (G2: async always; the fetch overlaps the forward/backward)."""
        return step_time_s >= self.transfer_s_per_step


def _tree_nbytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in _tree.leaves(tree))


def plan(opt_state, fraction: float = 1.0, model=DEFAULT_MODEL) -> OffloadPlan:
    nbytes = int(_tree_nbytes(opt_state.m) + _tree_nbytes(opt_state.v))
    nbytes = int(nbytes * fraction)
    # one D2H after the update + one H2D before the next (async depth 32)
    t = model.op_time(nbytes, async_depth=32, src_tier="hbm", dst_tier="host") + \
        model.op_time(nbytes, async_depth=32, src_tier="host", dst_tier="hbm")
    return OffloadPlan(
        hbm_freed_bytes=nbytes,
        transfer_s_per_step=t,
        profitable_below_step_s=t,
    )


class MomentOffloader:
    """Round-trips the moment trees through the engine, leaf by leaf
    (each leaf is one descriptor; the whole tree is one batch descriptor).

    Moves are asynchronous: ``_move_tree_async`` returns a Future that
    resolves to the reassembled tree (``.then`` re-unflattens on retire),
    so the m-tree and v-tree round-trips overlap (G2: async always)."""

    def __init__(self, device: Device):
        self.device = device
        self.stats = {"offloads": 0, "fetches": 0, "bytes_moved": 0}

    def _move_tree_async(self, tree: Any) -> Future:
        leaves, treedef = _tree.flatten(tree)
        descs = [WorkDescriptor(op=OpType.MEMCPY, src=x) for x in leaves]
        self.stats["bytes_moved"] += sum(d.nbytes for d in descs)
        fut = self.device.batch_async(descs, producer="moment-offload")

        def reassemble(outs):
            if len(descs) == 1 and not isinstance(outs, list):
                outs = [outs]
            return _tree.unflatten(treedef, outs)

        return fut.then(reassemble)

    def _move_both(self, opt_state):
        fm = self._move_tree_async(opt_state.m)
        fv = self._move_tree_async(opt_state.v)  # in flight together
        # one set-wait retires both round-trips (completion subsystem): the
        # host parks under the device's wait policy instead of pumping fm
        # to completion before even looking at fv
        self.device.wait_all([fm, fv])
        return opt_state._replace(m=fm.result(), v=fv.result())

    def offload(self, opt_state):
        self.stats["offloads"] += 1
        return self._move_both(opt_state)

    def fetch(self, opt_state):
        self.stats["fetches"] += 1
        return self._move_both(opt_state)
