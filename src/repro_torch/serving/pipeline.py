"""Continuous-batching serving engine with the paper's DPDK-Vhost offload
pattern (§6.4) mapped onto LLM decode:

  virtqueue            -> request queue + fixed decode slots
  packet copy          -> KV page / prompt movement through the stream engine
  3-stage pipeline     -> (1) one ``device.wait_any`` pass over the in-flight
                          copy futures (timeout=0: a single UMWAIT-style
                          poll, no busy loop) and commit IN ORDER via the
                          reorder array;
                          (2) assemble + submit this iteration's batched
                          copy descriptors (one BatchDescriptor per burst,
                          G1: burst size ~32);
                          (3) run the decode step on the model while the
                          engine moves pages (G2: async always).
  reorder array        -> per-queue ring marking which in-flight copies
                          completed; commits stop at the first incomplete
                          entry so requests always admit in arrival order.
  DWQ-per-core binding -> one DWQ per server worker (G6).
  open-loop traffic    -> ``run_open_loop`` drives the server from a
                          ``TrafficGenerator`` on a virtual clock: arrivals
                          land whether or not the server keeps up, SLO
                          classes map onto the priority WQs, and overload is
                          shed at admission (watermarks/occupancy) or on
                          ``QueueFull`` backpressure — the paper's sustained
                          packet-arrival regime instead of a replayed list.

On the port, the model runs eagerly on its own device (``model.device``)
and the prompt bytes move through the engines' device (CUDA kernels on
CUDA); the decode step updates the batch cache in place (the reference
jits it with the cache donated).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import lockcheck as _lockcheck
from repro_torch.core import Device, OpType, QueueFull, WorkDescriptor, WQConfig
from repro_torch.obs.spans import stage
from repro_torch.serving.slo import DEFAULT_SLO_CLASSES, classes_by_name

#: default WQ provisioning for a serving device (paper Fig. 9 + G6): a small
#: high-priority dedicated WQ for latency-critical admission copies (steered
#: to cache so the prefill that consumes them reads warm lines, Fig. 12) and
#: a large low-priority shared WQ for bulk background traffic.
SERVING_WQ_CONFIGS = (
    WQConfig("latency", mode="dedicated", size=16, priority=12,
             traffic_class="to_cache"),
    WQConfig("bulk", mode="shared", size=48, priority=2,
             traffic_class="to_memory"),
)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    # NUMA home (paper §4): the node whose engines move this request's pages
    # and whose KV shard should hold them.  None = assigned at enqueue
    # (round-robin across the fabric) or left unset on a single-node device.
    home_node: Optional[int] = None
    # SLO class (serving/slo.py): picks the admission-copy WQ and the
    # admission priority.  The default keeps the pre-SLO behaviour — every
    # admission copy rides the high-priority latency WQ.
    slo: str = "latency"
    arrived_at: float = dataclasses.field(default_factory=time.perf_counter)
    # perf_counter stamps of the server's path: ``enqueue()``, the copy
    # burst accepted, the prefill started (the queue wait is enqueued ->
    # submitted, the copy wait submitted -> admitted)
    enqueued_at: Optional[float] = None
    submitted_at: Optional[float] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    # virtual-clock stamps (open-loop runs): arrival_s comes from the
    # traffic trace; the server stamps the other two from its ``now_s``
    arrival_s: Optional[float] = None
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    # device KV pages reserved at admission (0 = none / kv_pool disabled)
    kv_pages: int = 0
    output: List[int] = dataclasses.field(default_factory=list)


class ReorderArray:
    """In-order commit over out-of-order completions (paper Fig. 16a).
    Entries are Futures (anything with ``is_done()``).

    ``pop_completed`` is atomic AND reentrancy-guarded.  Under continuous
    admission a completion can be observed mid-drain — a future's
    ``is_done()`` pumps the engine, whose completion callback may re-enter
    the commit path while the outer drain is between its done-check and its
    pop.  The unguarded check-then-pop then commits the wrong entry: the
    inner call pops the head the outer call just checked, and the outer pop
    takes the NEXT (possibly incomplete) entry — a double/premature commit
    that re-admits a slot.  tests/test_serving.py pins the crafted
    completion order that reproduced this."""

    def __init__(self, size: int = 128):
        self.size = size
        self._entries: deque = deque()  # (tag, future, payload)
        self._lock = _lockcheck.checked_rlock("serving.reorder")
        self._draining = False

    def push(self, tag: int, future, payload: Any):
        with self._lock:
            self._entries.append((tag, future, payload))

    def pop_completed(self) -> List[Tuple[int, Any]]:
        """Commit the longest completed PREFIX (in-order semantics).  A
        reentrant call (completion callback firing inside ``is_done()``)
        returns [] — the outer drain owns the commit."""
        with self._lock:
            if self._draining:
                return []
            self._draining = True
            try:
                out: List[Tuple[int, Any]] = []
                while self._entries:
                    tag, fut, payload = self._entries[0]
                    if not fut.is_done():
                        break
                    self._entries.popleft()
                    out.append((tag, payload))
                return out
            finally:
                self._draining = False

    def pending_futures(self) -> List[Any]:
        """The in-flight entries' futures, head first — the wait set for
        ``device.wait_any``/``as_completed``."""
        with self._lock:
            return [fut for _, fut, _ in self._entries]

    def __len__(self):
        return len(self._entries)


class VhostStyleServer:
    """Greedy-decode continuous batching over a DecoderModel (anything with
    the serving interface and a ``device`` where its tensors live)."""

    def __init__(self, model, params, *, slots: int = 4, max_cache_len: int = 256,
                 device: Optional[Device] = None, burst: int = 32,
                 topology=None, observer=None, kv_pool=None,
                 slo_classes=None, admission=None, tracker=None):
        from repro_torch.launch.steps import make_decode_step

        if getattr(getattr(model, "cfg", None), "encoder", None) is not None:
            raise ValueError(
                f"{model.cfg.name} is an encoder-decoder: the server prefills "
                "prompt tokens only and has no frame embeddings to encode, as "
                "the JAX package's; drive it through prefill and decode_step")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_cache_len = max_cache_len
        if device is None:
            # one engine group per node: the topology's per-node engine
            # counts provision the fabric, and numa_local keeps each
            # request's copies on its home node (paper §4 guideline)
            device = Device(
                wq_configs=list(SERVING_WQ_CONFIGS), topology=topology,
                policy="numa_local" if topology is not None
                and topology.n_nodes > 1 else "round_robin",
            )
        elif topology is not None:
            raise ValueError("pass a pre-built device= OR a topology= to "
                             "provision one from, not both (the device "
                             "already fixes its fabric)")
        self.device = device
        self.topology = self.device.topology
        self._node_rr = 0  # round-robin home-node assignment at enqueue
        self.burst = burst
        # admission copies gate time-to-first-token: steer them to the
        # high-priority WQ when the device has one, else the default WQ
        self._copy_wq = "latency" if self.device.has_wq("latency") else None
        # SLO classes (serving/slo.py): per-request WQ mapping + admission
        # priority; registered with the device so submits carry slo= hints
        self._slo_classes = classes_by_name(slo_classes or DEFAULT_SLO_CLASSES)
        self.device.register_slo_classes(self._slo_classes.values())
        # optional PagedKVPool: admission reserves the prompt's device pages
        # before the copy burst, completion/shed releases them — the KV
        # occupancy is then a real admission signal and the no-leak contract
        # extends to the open-loop path
        self.kv_pool = kv_pool
        # optional slo.AdmissionController / slo.LatencyTracker, wired by
        # run_open_loop or the caller
        self.admission = admission
        self.tracker = tracker
        # virtual clock (seconds) for open-loop runs; run_open_loop advances it
        self.now_s: float = 0.0
        self.reorder = ReorderArray()
        self.queue: deque = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.lengths_target: Dict[int, int] = {}
        self.cache = model.init_cache(slots, max_cache_len)
        # each row's cache length as the card holds it, kept on the host
        # (a prefill sets it, every decode step adds one to every row), so
        # the slots a step's attention reads are counted with no wait
        self._n_meta = getattr(model, "n_meta", 0)
        self._lengths = np.zeros(slots, np.int64)
        self._decode = make_decode_step(model)
        self._free_slots = list(range(slots))[::-1]
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32, device=model.device)
        # where descriptor operands go: the engines' device
        self._copy_device = self.device.engines[0].device
        self._tag = 0
        self.metrics = {"decoded_tokens": 0, "admitted": 0, "completed": 0,
                        "copy_bursts": 0, "steps": 0, "shed": 0,
                        "shed_backpressure": 0,
                        "backpressure_events": 0, "kv_alloc_failures": 0,
                        "admitted_by_node": {}, "by_class": {}}
        # anything with .gauge(name, value) — normally an obs.Sampler; each
        # step() emits per-stage wall times and occupancy gauges so the
        # serving loop shows up in the same time series as the engines
        self.observer = observer

    # ------------------------------------------------------------------ API
    def enqueue(self, req: Request):
        """Admit to the waiting queue; on a multi-node fabric, unassigned
        requests get a home node round-robin so their copy bursts (and KV
        pages) stay NUMA-local to one node's engine group."""
        if req.home_node is None and self.topology.n_nodes > 1:
            req.home_node = self._node_rr % self.topology.n_nodes
            self._node_rr += 1
        req.enqueued_at = time.perf_counter()
        self.queue.append(req)

    # ------------------------------------------------------------------ stage 1: poll + in-order commit
    def _stage_poll_commit(self, block: bool = False):
        """One completion-subsystem pass over the in-flight copy futures.

        ``timeout=0`` makes ``wait_any`` a single wait-policy poll (no busy
        loop) so decode still overlaps the copies; ``block=True`` — used
        when draining with nothing else to run — parks the host on the HEAD
        future (in-order commit can't advance past it) under the device's
        wait policy, freeing the cycles the paper's Fig. 11 measures."""
        futs = self.reorder.pending_futures()
        if futs:
            self.device.wait_any(futs[:1] if block else futs,
                                 timeout=None if block else 0)
        for _, payload in self.reorder.pop_completed():
            slot, req = payload
            self._admit_now(slot, req)

    def _admit_now(self, slot: int, req: Request):
        """Prompt pages have landed: prefill this slot's cache region.
        Runs under the request's trace context (reorder commit is part of
        the request lifecycle: any descriptor the prefill path submits
        shares the request's trace id)."""
        req.admitted_at = time.perf_counter()
        if self.observer is not None:
            self.observer.gauge("serving.request.queue_wait_us",
                                (req.submitted_at - req.enqueued_at) * 1e6)
            self.observer.gauge("serving.request.copy_wait_us",
                                (req.admitted_at - req.submitted_at) * 1e6)
        with self._trace_request(req), stage("serve.admit", "prefill", req.req_id):
            self._admit_now_inner(slot, req)

    def _admit_now_inner(self, slot: int, req: Request):
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32))[None].to(self.model.device)
        with stage("serve.prefill", "prefill", req.req_id):
            cache1, logits, _ = self.model.prefill(self.params, {"tokens": prompt},
                                                   self.max_cache_len)
        # splice the single-sequence cache into the batch cache at `slot`
        with stage("serve.splice", "prefill", req.req_id):
            self.cache = _splice_cache(self.cache, cache1, slot)
        self._lengths[slot] = len(req.prompt) + self._n_meta
        tok = int(torch.argmax(logits[0]))
        req.output.append(tok)
        req.first_token_at = time.perf_counter()
        req.first_token_s = self.now_s
        self._tokens[slot, 0] = tok
        self.active[slot] = req
        self.metrics["admitted"] += 1
        self._class_metrics(req.slo)["admitted"] += 1
        if req.home_node is not None:
            by_node = self.metrics["admitted_by_node"]
            by_node[req.home_node] = by_node.get(req.home_node, 0) + 1

    # ------------------------------------------------------------------ bookkeeping helpers
    def _class_metrics(self, slo: str) -> Dict[str, int]:
        m = self.metrics["by_class"].get(slo)
        if m is None:
            m = self.metrics["by_class"][slo] = {
                "admitted": 0, "completed": 0, "shed": 0}
        return m

    def _wq_for(self, req: Request):
        """The admission-copy WQ for a request's SLO class — the PR 2
        priority-WQ mapping; falls back to the legacy latency/default WQ
        when the class (or its WQ) is not provisioned on this device."""
        cls = self._slo_classes.get(req.slo)
        if cls is not None and cls.wq is not None and self.device.has_wq(cls.wq):
            return cls.wq
        return self._copy_wq

    def _pop_next_request(self) -> Request:
        """Admission order: highest SLO-class priority first, FIFO within a
        class — latency traffic jumps the bulk backlog, never the reverse."""
        if len(self.queue) == 1 or not self._slo_classes:
            return self.queue.popleft()
        best_i, best_p = 0, -1
        for i, req in enumerate(self.queue):
            cls = self._slo_classes.get(req.slo)
            p = cls.priority if cls is not None else 0
            if p > best_p:
                best_i, best_p = i, p
        req = self.queue[best_i]
        del self.queue[best_i]
        return req

    def _trace_request(self, req: Request):
        """Request-scoped trace context: every descriptor submitted inside
        (admission copies, KV paging, continuations) shares one trace id —
        ``req<id>`` — so the trace tooling can group a request's lifecycle
        across SLO admission, KV paging, and reorder commit.  A no-op
        context when the device has no tracer."""
        tracer = getattr(self.device, "tracer", None)
        if tracer is None:
            return contextlib.nullcontext()
        return tracer.request(f"req{req.req_id}")

    def _release_kv(self, req: Request):
        if self.kv_pool is not None and req.kv_pages:
            with self._trace_request(req):
                self.kv_pool.free(req.req_id)
            req.kv_pages = 0

    def _shed_now(self, req: Request):
        """Drop an already-dequeued request (backpressure shed): release
        its KV reservation and account the drop per class."""
        self._release_kv(req)
        self.metrics["shed"] += 1
        self.metrics["shed_backpressure"] += 1
        self._class_metrics(req.slo)["shed"] += 1

    def _reserve_kv(self, req: Request) -> bool:
        """Reserve the prompt's device pages before moving its bytes (the
        admission copy lands in KV); False = no capacity right now."""
        if self.kv_pool is None or req.kv_pages:
            return True
        n_pages = max(1, math.ceil(len(req.prompt) / self.kv_pool.page_tokens))
        node = (req.home_node if self.topology.n_nodes > 1 else None)
        with self._trace_request(req):
            ok = self.kv_pool.alloc(req.req_id, n_pages, node=node)
        if not ok:
            self.metrics["kv_alloc_failures"] += 1
            return False
        req.kv_pages = n_pages
        return True

    # ------------------------------------------------------------------ stage 2: submit batched copies
    def _stage_submit_copies(self):
        while self._free_slots and self.queue:
            req = self._pop_next_request()
            if not self._reserve_kv(req):
                # KV pressure is backpressure too: shed-first classes drop,
                # protected classes wait at the head for pages to free
                if (self.admission is not None
                        and req.slo in self.admission.classes
                        and self.admission.on_backpressure(req.slo)):
                    self._shed_now(req)
                    continue
                self.queue.appendleft(req)
                break
            slot = self._free_slots.pop()
            # burst the prompt over as a batch descriptor (packet copy analogue)
            chunks = np.array_split(req.prompt, max(1, len(req.prompt) // 64))
            descs = [
                WorkDescriptor(op=OpType.MEMCPY,
                               src=torch.from_numpy(np.ascontiguousarray(c)).to(self._copy_device))
                for c in chunks[: self.burst]
            ]
            try:
                with self._trace_request(req):
                    fut = self.device.batch_async(descs, producer=f"slot{slot}",
                                                  wq=self._wq_for(req),
                                                  node=req.home_node)
            except QueueFull:
                # engine-side backpressure survived bounded backoff: give
                # the slot back, then either shed (shed-first classes) or
                # hold the request for the next step — never busy-loop
                self._free_slots.append(slot)
                self.metrics["backpressure_events"] += 1
                if (self.admission is not None
                        and req.slo in self.admission.classes
                        and self.admission.on_backpressure(req.slo)):
                    self._shed_now(req)
                    continue
                self.queue.appendleft(req)
                break
            req.submitted_at = time.perf_counter()
            self.reorder.push(self._tag, fut, (slot, req))
            self._tag += 1
            self.metrics["copy_bursts"] += 1

    # ------------------------------------------------------------------ stage 3: decode step
    def _stage_decode(self):
        if not self.active:
            return
        t0 = time.perf_counter()
        with stage("serve.decode.launch", "decode"):
            next_tokens, self.cache = self._decode(self.params, self.cache, self._tokens)
        if self.observer is not None:
            self.observer.gauge("serving.stage.decode_launch_us",
                                (time.perf_counter() - t0) * 1e6)
            # the slots a full cache's decode attention reads in each layer:
            # every row's [0, length], within the cache
            self.observer.gauge("serving.decode.live_slots", float(np.minimum(
                self._lengths + 1, self.max_cache_len + self._n_meta).sum()))
        self._lengths += 1
        self._tokens = next_tokens
        self.metrics["decoded_tokens"] += len(self.active)
        with stage("serve.decode.read", "decode"):
            toks = next_tokens[:, 0].tolist()  # one read of the step's tokens
        done_slots = []
        for slot, req in self.active.items():
            tok = toks[slot]
            req.output.append(tok)
            if len(req.output) >= req.max_new_tokens:
                req.done_at = time.perf_counter()
                req.done_s = self.now_s
                done_slots.append(slot)
        for slot in done_slots:
            req = self.active.pop(slot)
            self.metrics["completed"] += 1
            self._class_metrics(req.slo)["completed"] += 1
            self._release_kv(req)
            if self.tracker is not None and req.arrival_s is not None:
                self.tracker.record(req.slo, req.arrival_s,
                                    req.first_token_s, req.done_s)
            self._free_slots.append(slot)

    # ------------------------------------------------------------------ loop
    def step(self):
        with stage("serve.step"):
            # (1) completions -> in-order admit.  With decode work in flight OR
            # queued requests that stage 2 can still submit (a free slot
            # exists), the pass is non-blocking (timeout=0) so compute and new
            # copy bursts overlap the in-flight ones (G2); when neither stage
            # can make progress, park on the head copy under the device's wait
            # policy instead of spinning the loop.
            can_submit = bool(self.queue) and bool(self._free_slots)
            t0 = time.perf_counter()
            with stage("serve.poll"):
                self._stage_poll_commit(block=not self.active and not can_submit
                                        and len(self.reorder) > 0)
            t1 = time.perf_counter()
            with stage("serve.submit"):
                self._stage_submit_copies()  # (2) batch descriptors for new requests
            t2 = time.perf_counter()
            with stage("serve.decode", "decode"):
                self._stage_decode()  # (3) compute overlapped with copies
            t3 = time.perf_counter()
            self.metrics["steps"] += 1
            if self.observer is not None:
                obs = self.observer
                obs.gauge("serving.queue_depth", len(self.queue))
                obs.gauge("serving.active_slots", len(self.active))
                obs.gauge("serving.slot_occupancy", len(self.active) / self.slots)
                obs.gauge("serving.inflight_copies", len(self.reorder))
                obs.gauge("serving.stage.poll_us", (t1 - t0) * 1e6)
                obs.gauge("serving.stage.submit_us", (t2 - t1) * 1e6)
                obs.gauge("serving.stage.decode_us", (t3 - t2) * 1e6)
                # per-SLO-class gauges: queue depth now, admitted/shed to date —
                # the overload experiments read these next to the engine series
                queued = Counter(r.slo for r in self.queue)
                for name in self._slo_classes:
                    cm = self._class_metrics(name)
                    obs.gauge(f"serving.class.{name}.queue_depth",
                              queued.get(name, 0))
                    obs.gauge(f"serving.class.{name}.admitted", cm["admitted"])
                    obs.gauge(f"serving.class.{name}.shed", cm["shed"])

    def run_until_drained(self, max_steps: int = 10_000):
        steps = 0
        while (self.queue or self.active or len(self.reorder)) and steps < max_steps:
            self.step()
            steps += 1
        self.device.drain()
        return steps

    # ------------------------------------------------------------------ open loop
    def run_open_loop(self, traffic, horizon_s: float, *,
                      step_s: float = 0.01, vocab_size: int = 256,
                      drain: bool = True, max_steps: int = 1_000_000) -> dict:
        """Drive the server open-loop from a ``TrafficGenerator`` for
        ``horizon_s`` VIRTUAL seconds: arrivals land at their trace times
        whether or not the server keeps up (the paper's §6 sustained-load
        regime).  Each ``step()`` advances the virtual clock by ``step_s``.

        Admission runs through ``self.admission`` when set (watermarks,
        occupancy probes, backpressure sheds); latencies land in
        ``self.tracker`` when set.  ``drain=True`` keeps stepping past the
        horizon until all admitted work completes, so the accounting
        identity  generated == admitted + shed + in-flight  closes with
        in-flight == 0 — the overload soak test's conservation law.

        Returns a report: offered/sustained RPS, per-class latency summary,
        shed/admission counters, and the in-flight remainder."""
        if step_s <= 0:
            raise ValueError(f"step_s must be > 0, got {step_s}")
        events = traffic.trace(horizon_s)
        i = 0
        t = 0.0
        steps = 0
        generated = admitted = shed = 0
        # cumulative-counter baselines, so a server reused across runs
        # reports THIS run's deltas
        completed_0 = self.metrics["completed"]
        shed_0 = self.metrics["shed"]
        bp_shed_0 = self.metrics["shed_backpressure"]
        queued_by_class: Counter = Counter()
        while True:
            self.now_s = t
            while i < len(events) and events[i].arrival_s <= t:
                ev = events[i]
                i += 1
                generated += 1
                if self.admission is not None and ev.slo in self.admission.classes:
                    ok = self.admission.admit(ev.slo, queued_by_class[ev.slo])
                else:
                    ok = True
                if ok:
                    req = ev.materialize(vocab_size)
                    self.enqueue(req)
                    queued_by_class[ev.slo] += 1
                    admitted += 1
                else:
                    self.metrics["shed"] += 1
                    self._class_metrics(ev.slo)["shed"] += 1
                    shed += 1
            had_queued = len(self.queue)
            work = bool(self.queue or self.active or len(self.reorder))
            if i >= len(events) and not work:
                break
            if not drain and t >= horizon_s:
                break
            if steps >= max_steps:
                break
            self.step()
            steps += 1
            # dequeues (admits + backpressure sheds) shrink the per-class
            # waiting counts the admission watermark reads
            if len(self.queue) != had_queued:
                queued_by_class = Counter(r.slo for r in self.queue)
            t += step_s
        in_flight = len(self.queue) + len(self.reorder) + len(self.active)
        completed = self.metrics["completed"] - completed_0
        bp_shed = self.metrics["shed_backpressure"] - bp_shed_0
        report = {
            "horizon_s": horizon_s,
            "virtual_s": t,
            "steps": steps,
            "generated": generated,
            # enqueued minus later backpressure sheds: what the server
            # actually took responsibility for (== completed + in_flight)
            "admitted": admitted - bp_shed,
            "shed": self.metrics["shed"] - shed_0,
            "shed_backpressure": bp_shed,
            "completed": completed,
            "in_flight": in_flight,
            "offered_rps": traffic.offered_rps(),
            "sustained_rps": completed / max(t, step_s),
            "by_class": {k: dict(v) for k, v in self.metrics["by_class"].items()},
        }
        if self.tracker is not None:
            report["latency"] = self.tracker.summary()
            goodput = sum(self.tracker.within_slo(c)
                          for c in self.tracker.classes)
            report["goodput_rps"] = goodput / max(t, step_s)
        return report


def _splice_cache(batch_cache, one_cache, slot: int):
    """Write a batch-1 cache into row ``slot`` of the batch cache, in place.

    The batch axis of each leaf follows from where it sits in the cache:
    an unrolled segment is a list of per-layer caches ([B, ...]), a scanned
    segment stacks its units ([n, B, ...]), and a gemma3 period's
    ``locals`` stack once more inside the unit ([n, 5, B, ...]).  (The JAX
    package guesses the axis from the shapes and writes a period's locals
    along the layer axis.)"""
    for d, s in zip(batch_cache["segments"], one_cache["segments"]):
        _splice_leaves(d, s, 0 if isinstance(d, list) else 1, slot)
    batch_cache["lengths"][slot] = one_cache["lengths"][0]
    return batch_cache


def _splice_leaves(dst, src, axis: int, slot: int):
    """Row 0 of every leaf of ``src`` into row ``slot`` of ``dst``'s, along
    ``axis`` (one more inside a period's ``locals``)."""
    if isinstance(dst, dict):
        for k in dst:
            _splice_leaves(dst[k], src[k], axis + (k == "locals"), slot)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _splice_leaves(d, s, axis, slot)
    else:
        dst.select(axis, slot).copy_(src.select(axis, 0))
