"""The transform service: async queue -> buckets -> batched dispatch.

Port of ``repro/serve/service.py``.  One worker thread owns the device:
it pulls requests off the queue, groups them by transform
(:mod:`repro_torch.serve.batcher`), resolves plans through the
:mod:`repro_torch.serve.plan_cache`, stacks/pads the payloads, and runs
the batched transform.  Clients get ``concurrent.futures.Future``\\ s;
results materialize on the host so latency includes the card-to-host
copy.

The loop is continuous batching in the transform setting: while the
device runs one batch, the queue keeps filling, so the next batch forms
from whatever arrived meanwhile — occupancy rises with offered load
instead of being fixed at a static batch size.

    with TransformService(max_batch=8) as svc:        # on the card
        fut = svc.submit(field, problem="r2c")
        spectrum = fut.result().value

Without a mesh the service runs on ``device`` (the card unless the
caller passes ``device="cpu"``).  With a mesh it is an SPMD service over
the mesh's ranks: every rank builds it, in the same order, and starts
it; rank 0 is the only front end (``submit`` elsewhere raises), and its
worker makes every decision — bucket, plan build, retry, deadline, shed,
redispatch, quarantine, upgrade, stop.  It sends each dispatch to the
other ranks as a small control record over a gloo group of its own
(:class:`_Control`, made when the service is made), and every rank runs
the same ``PlanCache.get`` and batched transform in the same order:
rank 0 scatters each rank its block of the stacked batch and gathers the
result blocks back.  A fault decision that precedes a collective (an
injected ``serve.dispatch``, ``plan.build`` or ``plan.upgrade`` fault) is
made on rank 0 and broadcast at the site.  Each rank checks its output
block for NaN/Inf on the device and the ranks all-reduce the answer;
what counts toward quarantine is decided on rank 0 and sent as the
dispatch's outcome record.  A follower's ``stop()`` returns when rank
0's stop record arrives.

A kernel that does not build or launch (:class:`~repro_torch.kernels.
KernelError`) is not served around: it fails its batch with the error,
every pending request with it, and stops the service — on a mesh every
rank raises it at the same step (the plan cache and the batch each
settle failures with one all-reduce) and stops alike — and ``stop()``
raises it.  It never counts toward quarantine, so the ladder never
swaps in a plan that skips the card's kernels.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import KernelError
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import tracer as tracer_lib
from repro_torch.resil import inject as inject_lib
from repro_torch.serve.batcher import (Batcher, Bucket, padded_size,
                                       stack_and_pad)
from repro_torch.serve.plan_cache import PlanCache
from repro_torch.serve.request import (PRIORITY_NORMAL, ShedResult,
                                       TransformRequest, TransformResult,
                                       bucket_key, numpy_dtype)

_log = logging.getLogger("repro_torch.serve")


@dataclasses.dataclass
class _Pending:
    req: TransformRequest
    future: "object"  # concurrent.futures.Future[TransformResult]


class _Control:
    """The control channel of a meshed service: a gloo process group over
    every rank (``dist.new_group`` is collective over the world, so it is
    made when the service is made, on every rank in the same order), used
    by the service's worker thread alone.  Rank 0 leads.  Gloo even where
    the data runs on NCCL: object broadcasts and the host blocks of the
    payload travel as CPU tensors."""

    LEADER = 0

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()

    @property
    def leader(self) -> bool:
        return self.rank == self.LEADER

    def close(self) -> None:
        """Destroy the group (every rank, after the service stopped)."""
        if self.group is not None:
            dist.destroy_process_group(self.group)
            self.group = None

    def _broadcast(self, obj):
        box = [obj]
        dist.broadcast_object_list(box, src=self.LEADER, group=self.group)
        return box[0]

    def send(self, record: dict) -> None:
        """Rank 0: one record to every other rank."""
        self._broadcast(record)

    def recv(self) -> dict:
        """The other ranks: rank 0's next record."""
        return self._broadcast(None)

    def fire(self, site: str, key: str) -> None:
        """``inject.fire`` decided on rank 0 and raised on every rank."""
        hit = None
        if self.leader:
            try:
                inject_lib.fire(site, key)
            except inject_lib.InjectedFault as e:
                hit = (type(e).__name__, e.site, e.key, e.index)
        hit = self._broadcast(hit)
        if hit is not None:
            name, *args = hit
            raise getattr(inject_lib, name)(*args)

    def worst(self, code: int) -> int:
        """The largest of every rank's ``code``."""
        flag = torch.tensor([code], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        return int(flag.item())


    def scatter(self, host: Optional[np.ndarray], block: tuple, shape: tuple,
                dtype: torch.dtype) -> torch.Tensor:
        """Each rank's ``block`` (index ranges) of rank 0's host stack
        ``host`` (None elsewhere), as a host tensor of ``dtype``;
        ``shape`` is the stack's."""
        blocks = [None] * self.size
        dist.all_gather_object(blocks, block, group=self.group)
        if not self.leader:
            buf = torch.empty(_extent(block, shape), dtype=dtype)
            dist.recv(buf, src=self.LEADER, group=self.group)
            return buf
        works, mine = [], None
        for r, blk in enumerate(blocks):
            t = torch.from_numpy(np.ascontiguousarray(host[blk]))
            if r == self.rank:
                mine = t
            else:
                works.append(dist.isend(t, dst=r, group=self.group))
        for w in works:
            w.wait()
        return mine

    def gather(self, out: torch.Tensor, block: tuple,
               shape: tuple) -> Optional[np.ndarray]:
        """Every rank's result block ``out`` at ``block`` of the global
        ``shape``, assembled on rank 0 (None elsewhere)."""
        blocks = [None] * self.size
        dist.all_gather_object(blocks, block, group=self.group)
        local = out.detach().cpu().contiguous()
        if not self.leader:
            dist.send(local, dst=self.LEADER, group=self.group)
            return None
        host = np.empty(shape, dtype=numpy_dtype(local.dtype))
        host[block] = local.numpy()
        for r, blk in enumerate(blocks):
            if r == self.rank:
                continue
            buf = torch.empty(_extent(blk, shape), dtype=local.dtype)
            dist.recv(buf, src=r, group=self.group)
            host[blk] = buf.numpy()
        return host


def _extent(block: tuple, shape: tuple) -> tuple:
    return tuple(len(range(*s.indices(n))) for s, n in zip(block, shape))


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """``a`` as a host tensor, a view where torch can take one."""
    try:
        return torch.from_numpy(a)
    except (TypeError, ValueError):  # negative strides, foreign byte order
        return torch.from_numpy(np.ascontiguousarray(
            a, a.dtype.newbyteorder("=")))


class _Staging:
    """Two pinned host buffers of ``CHUNK`` bytes through which a meshless
    service on the card moves payloads to the card and results back, a
    chunk at a time.  Page-locked memory stays at ``2 * CHUNK`` whatever
    the batch (PyTorch's pinned allocator never returns a freed block to
    the system), and each chunk's host copy — cast and page faults
    included, spread over torch's intra-op threads — overlaps the other
    buffer's DMA.  Used by the service's worker alone, on its stream."""

    CHUNK = 64 << 20

    def __init__(self):
        self._bufs = [torch.empty(self.CHUNK, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(2)]
        self._done = [None, None]  # the event of each buffer's last DMA
        self._turn = 1             # the buffer upload used last

    def _pieces(self, n: int, dtype: torch.dtype):
        step = self.CHUNK // dtype.itemsize
        for c, lo in enumerate(range(0, n, step)):
            yield c % 2, lo, min(lo + step, n)

    def _wait(self, b: int) -> None:
        if self._done[b] is not None:
            self._done[b].synchronize()
            self._done[b] = None

    def _record(self, b: int) -> None:
        self._done[b] = torch.cuda.Event()
        self._done[b].record()

    def upload(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy host ``src`` (any strides) into the card's contiguous
        ``dst`` of the same shape, cast to ``dst``'s dtype: blocks of
        whole leading-axis slices, or slice by slice where one slice
        outgrows a chunk."""
        row = dst[0].numel() * dst.element_size()
        if dst.ndim > 1 and row > self.CHUNK:
            for s, d in zip(src, dst):
                self.upload(s, d)
            return
        step = self.CHUNK // row
        for lo in range(0, dst.shape[0], step):
            hi = min(lo + step, dst.shape[0])
            b = self._turn = 1 - self._turn
            self._wait(b)
            stage = self._bufs[b].view(dst.dtype)[:(hi - lo) * row
                                                  // dst.element_size()]
            stage = stage.view((hi - lo,) + tuple(dst.shape[1:]))
            stage.copy_(src[lo:hi])
            dst[lo:hi].copy_(stage, non_blocking=True)
            self._record(b)

    def download(self, src: torch.Tensor) -> torch.Tensor:
        """The card's contiguous ``src`` as a new host tensor."""
        out = torch.empty(src.shape, dtype=src.dtype)
        src, flat = src.contiguous().view(-1), out.view(-1)
        pieces = list(self._pieces(src.numel(), src.dtype))

        def fetch(i):
            b, lo, hi = pieces[i]
            self._wait(b)
            self._bufs[b].view(src.dtype)[:hi - lo].copy_(
                src[lo:hi], non_blocking=True)
            self._record(b)

        if pieces:
            fetch(0)
        for i, (b, lo, hi) in enumerate(pieces):
            if i + 1 < len(pieces):
                fetch(i + 1)  # the next chunk's DMA overlaps this copy
            self._wait(b)
            flat[lo:hi].copy_(self._bufs[b].view(src.dtype)[:hi - lo])
        return out


class TransformService:
    """Plan-cached, continuously batched spectral transform service."""

    def __init__(self, mesh=None, *, device=None, max_batch: int = 8,
                 max_wait_ms: float = 2.0,
                 cache: Optional[PlanCache] = None,
                 wisdom_path: Optional[str] = None,
                 max_plans: int = 16,
                 measure_after: Optional[int] = None,
                 tune_kw: Optional[dict] = None,
                 latency_window: int = 4096,
                 registry: Optional[metrics_lib.MetricsRegistry] = None,
                 max_queue: Optional[int] = None,
                 dispatch_retries: int = 2,
                 retry_backoff_s: float = 0.01,
                 nan_guard: bool = True,
                 quarantine_after: int = 3,
                 preemption=None):
        self.mesh = mesh
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        #: bounded-queue load shedding: when more than ``max_queue``
        #: requests are pending in the batcher, the least-important one
        #: (highest priority value, newest first) resolves with a typed
        #: ShedResult instead of waiting (None = unbounded)
        self.max_queue = max_queue
        self.dispatch_retries = dispatch_retries
        self.retry_backoff_s = retry_backoff_s
        self.nan_guard = nan_guard
        #: train.fault.PreemptionHandler (or None): when its flag flips
        #: (SIGTERM), the worker drains pending buckets and stops cleanly
        self.preemption = preemption
        # every serving number lives in the metrics registry
        # (repro_torch.obs); stats() below is a thin view over it.  Each
        # service owns its registry by default so two services never mix
        # counters; pass registry= to share one exposition endpoint.
        self.registry = registry if registry is not None \
            else metrics_lib.MetricsRegistry()
        self.cache = cache if cache is not None else PlanCache(
            mesh, device=device, wisdom_path=wisdom_path,
            max_plans=max_plans, measure_after=measure_after,
            tune_kw=tune_kw, registry=self.registry,
            quarantine_after=quarantine_after)
        self.device = self.cache.device
        #: the SPMD control channel (None without a mesh)
        self._control = None
        if mesh is not None:
            self._control = self.cache.control = _Control()
        self._queue: "queue.Queue" = queue.Queue()
        self._batcher = Batcher(max_batch, self.max_wait_s)
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._followers_stopped = False
        #: the kernel failure that stopped the service (raised by stop())
        self._error: Optional[BaseException] = None
        self._stream = None
        #: pinned staging of a meshless service on the card (made on start)
        self._staging = None
        self._lock = threading.Lock()
        del latency_window  # kept for API compat; quantiles come from
        #                     the registry's log-bucketed histogram
        self._m_submitted = self.registry.counter(
            "serve_requests_submitted", "requests accepted by submit()")
        self._m_requests = self.registry.counter(
            "serve_requests", "requests served successfully")
        self._m_batches = self.registry.counter(
            "serve_batches", "batched dispatches")
        self._m_real_rows = self.registry.counter(
            "serve_real_rows", "real rows across dispatched batches")
        self._m_padded_rows = self.registry.counter(
            "serve_padded_rows", "padded rows across dispatched batches")
        self._m_waste_rows = self.registry.counter(
            "serve_padding_waste_rows",
            "padded slots that carried no request (dead collective weight)")
        self._m_failures = self.registry.counter(
            "serve_failures", "requests resolved with ok=False")
        self._m_batch_hist = self.registry.histogram(
            "serve_batch_size", "real batch size per dispatch",
            bounds=range(1, max_batch + 1))
        self._m_latency = self.registry.histogram(
            "serve_latency_s", "submit-to-result seconds")
        self._m_queue_wait = self.registry.histogram(
            "serve_queue_wait_s", "submit-to-dispatch seconds")
        # resilience counters: every shed/retry/poison event is counted
        # exactly once so chaos gates can assert equality
        self._m_shed = self.registry.counter(
            "serve_shed_requests",
            "requests rejected by bounded-queue load shedding")
        self._m_deadline = self.registry.counter(
            "serve_deadline_misses",
            "requests whose dispatch deadline passed before their batch")
        self._m_retries = self.registry.counter(
            "serve_dispatch_retries",
            "transient dispatch faults retried with backoff")
        self._m_poisoned = self.registry.counter(
            "serve_poisoned_requests",
            "requests isolated for non-finite payloads")
        self._m_redispatch = self.registry.counter(
            "serve_poison_redispatches",
            "healthy batch-mates re-dispatched individually after a "
            "poisoned co-batched dispatch")
        self._m_nan_outputs = self.registry.counter(
            "serve_nan_outputs",
            "dispatches producing non-finite output from finite input")
        self._m_preempt = self.registry.counter(
            "serve_preemption_drains",
            "graceful drains triggered by the preemption handler")
        # the reference's name; it stays 0 here, where no upgrade runs
        # on a thread of its own (see PlanCache)
        self._m_leaked = self.registry.counter(
            "serve_leaked_upgrade_threads",
            "upgrade threads still alive after stop()'s join timeout")

    @property
    def _leader(self) -> bool:
        return self._control is None or self._control.leader

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "TransformService":
        """Start the worker (on a mesh: on every rank; rank 0's takes
        requests, the others run the dispatches rank 0 sends them)."""
        with self._lock:
            if self._running:
                return self
            if self._error is not None:
                raise RuntimeError("the service stopped on a kernel "
                                   "failure") from self._error
            self._running = True
            self._followers_stopped = False
        if self.preemption is not None and self._leader:
            self.preemption.install()  # SIGTERM -> flag; worker drains
        if self.device.type == "cuda":
            # the worker launches on the caller's current stream
            self._stream = torch.cuda.current_stream(self.device)
            if self._control is None and self._staging is None:
                with torch.cuda.device(self.device):
                    self._staging = _Staging()
        self._worker = threading.Thread(
            target=self._run if self._leader else self._follow,
            daemon=True, name="transform-service")
        self._worker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker; ``drain=True`` serves everything already
        queued first (in-flight futures never dangle).  On a mesh, rank
        0's stop ends every rank's service; another rank's ``stop()``
        returns when rank 0's stop record has arrived.  Raises the
        kernel failure that stopped the service, if one did."""
        with self._lock:
            was_running, self._running = self._running, False
        if not was_running or not self._leader:
            # a follower, or already stopped (drained for preemption, or
            # a kernel failed): wait for the worker to finish
            if self._worker is not None:
                self._worker.join()
                self._worker = None
            self._staging = None
            self._raise_error()
            return
        self._queue.put(None)  # wake the worker
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is None:
            with self._device_scope():
                try:
                    if drain:
                        self._drain_all()
                    else:
                        self._fail_pending("service stopped")
                except KernelError as e:
                    self._fail_all(e)
            self._stop_followers()
        self._staging = None  # its pinned chunks go back to torch's cache
        self._raise_error()

    def close(self) -> None:
        """Stop, then (on a mesh, on every rank) destroy the control
        group.  Call it before ``destroy_process_group``."""
        try:
            self.stop()
        finally:
            if self._control is not None:
                self._control.close()

    def _raise_error(self) -> None:
        if self._error is not None:
            raise self._error

    def _fail_all(self, err: BaseException) -> None:
        """A kernel failed (on a mesh: on some rank, and every rank knows):
        stop taking requests and fail every pending one with ``err``."""
        with self._lock:
            self._running = False
            self._error = err
        # the followers stop at the same dispatch, on their own
        self._followers_stopped = True
        _log.error("transform service stopped: %s: %s",
                   type(err).__name__, err)
        if not self._leader:
            return
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not False:
                item.future.set_exception(err)
        for bucket in self._batcher.pop_all():
            for p in bucket.requests:
                p.future.set_exception(err)

    def _stop_followers(self) -> None:
        if self._control is not None and not self._followers_stopped:
            self._followers_stopped = True
            self._control.send({"op": "stop"})

    def __enter__(self) -> "TransformService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @contextlib.contextmanager
    def _device_scope(self):
        """The worker's device and stream: a thread starts on the card's
        default device and stream, not the caller's."""
        if self.device.type != "cuda":
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            yield

    # -- client API ---------------------------------------------------------
    def submit(self, x, *, problem: str = "c2c", direction: str = "forward",
               h=None, shape=None, dtype=None,
               priority: int = PRIORITY_NORMAL,
               deadline_s: Optional[float] = None):
        """Enqueue one transform; returns a Future[TransformResult].

        Payloads are host arrays (the wire format); validation happens
        here, synchronously, so a malformed request raises at the call
        site instead of poisoning a batch.  ``priority`` and
        ``deadline_s`` are the request-lifecycle knobs: priority decides
        who sheds first under a bounded queue and which ready bucket
        dispatches first; a passed deadline resolves the future with a
        typed :class:`~repro_torch.serve.request.ShedResult` instead of
        running stale work.  On a mesh, rank 0 alone takes requests."""
        if not self._leader:
            raise RuntimeError(
                f"rank {self._control.rank} is not the service's front "
                "end: submit on rank 0 of the mesh (the other ranks run "
                "the dispatches rank 0 sends them)")
        req = TransformRequest(
            x=np.asarray(x), problem=problem, direction=direction,
            h=None if h is None else np.asarray(h), shape=shape,
            dtype=np.complex64 if dtype is None else dtype,
            priority=priority, deadline_s=deadline_s)
        req.validate_payload()
        fut = concurrent.futures.Future()
        # check-and-enqueue under the lifecycle lock: stop() flips
        # _running under the same lock, so no request can slip in after
        # _fail_pending has swept the queue (its future would never
        # resolve and the caller would hang on fut.result()).
        with self._lock:
            if not self._running:
                if self._error is not None:
                    raise RuntimeError("the service stopped on a kernel "
                                       "failure") from self._error
                raise RuntimeError("service not started (use `with "
                                   "service:` or service.start())")
            self._queue.put(_Pending(req, fut))
        self._m_submitted.inc()
        tracer_lib.get_tracer().instant(
            "request:submit", "queue",
            {"req_id": req.req_id, "problem": req.problem,
             "direction": req.direction})
        return fut

    def transform(self, x, **kw) -> np.ndarray:
        """Synchronous convenience: submit, wait, unwrap (raises on a
        failed request)."""
        res = self.submit(x, **kw).result()
        if not res.ok:
            raise RuntimeError(f"transform failed: {res.error}")
        return res.value

    # -- worker -------------------------------------------------------------
    def _run(self) -> None:
        try:
            with self._device_scope():
                self._serve()
        except KernelError as e:
            self._fail_all(e)

    def _serve(self) -> None:
        while True:
            if (self.preemption is not None
                    and self.preemption.preemption_requested):
                self._preempt_drain()
                return
            deadline = self._batcher.next_deadline()
            timeout = 0.05 if deadline is None else min(deadline, 0.05)
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                item = False  # timeout tick: check wait budgets below
            if item is None:
                return  # stop() sentinel; stop() handles the remainder
            if item is not False:
                self._batcher.add(self._bucket_key(item.req), item)
                self._shed_overflow()
            for bucket in self._batcher.pop_ready():
                self._dispatch(bucket)

    def _follow(self) -> None:
        """A follower's worker: run rank 0's records until its stop."""
        try:
            with self._device_scope():
                while True:
                    rec = self._control.recv()
                    if rec["op"] == "stop":
                        return
                    self._follow_dispatch(rec)
        except KernelError as e:
            self._fail_all(e)

    def _shed_overflow(self) -> None:
        """Bounded-queue load shedding: evict the least-important pending
        request (see ``Batcher.shed_lowest``) until back under
        ``max_queue``.  Evicted futures resolve immediately with a typed
        ShedResult — a shed request can never hang."""
        if self.max_queue is None:
            return
        while self._batcher.pending > self.max_queue:
            item = self._batcher.shed_lowest()
            if item is None:
                return
            self._m_shed.inc()
            tracer_lib.get_tracer().instant(
                "request:shed", "queue",
                {"req_id": item.req.req_id, "priority": item.req.priority})
            item.future.set_result(ShedResult(
                req_id=item.req.req_id, value=None, ok=False,
                error=f"shed: queue full (max_queue={self.max_queue})",
                shed_reason="queue-full", t_submit=item.req.t_submit))

    def _preempt_drain(self) -> None:
        """Preemption (SIGTERM): flip to not-running so new submits are
        refused, then serve everything already pending — a preempted
        service finishes its work, it does not drop it."""
        with self._lock:
            self._running = False
        self._m_preempt.inc()
        tracer_lib.get_tracer().instant("service:preempt-drain", "queue")
        self._drain_all()
        self._stop_followers()

    def _bucket_key(self, req: TransformRequest) -> str:
        # token_for (not key_for): once a plan is built the bucket key
        # carries its pipeline token, so requests never co-batch across
        # an upgrade that swapped in a different (e.g. searched) pipeline
        return bucket_key(req, self.cache.token_for(
            req.shape, req.dtype, req.plan_problem))

    def _drain_all(self) -> None:
        """Serve every queued/pending request (shutdown, tests)."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not False:
                self._batcher.add(self._bucket_key(item.req), item)
        # buckets here can exceed max_batch (leftover partial bucket plus
        # late arrivals); chunk them, since padded_size rejects oversize
        # and stop(drain=True) promises every queued request is served
        for bucket in self._batcher.pop_all():
            reqs = bucket.requests
            for i in range(0, len(reqs), self.max_batch):
                self._dispatch(Bucket(bucket.key,
                                      reqs[i:i + self.max_batch]))

    def _fail_pending(self, msg: str) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and item is not False:
                item.future.set_result(TransformResult(
                    req_id=item.req.req_id, value=None, ok=False, error=msg))
        for bucket in self._batcher.pop_all():
            for p in bucket.requests:
                p.future.set_result(TransformResult(
                    req_id=p.req.req_id, value=None, ok=False, error=msg))

    # -- dispatch -----------------------------------------------------------
    def _dispatch(self, bucket, _isolate: bool = True) -> None:
        tracer = tracer_lib.get_tracer()
        t_dispatch = time.monotonic()
        # deadline enforcement: a request whose dispatch deadline passed
        # while it queued resolves typed and never runs (stale work is
        # dead weight for every batch-mate's collective)
        pendings = []
        for p in bucket.requests:
            if p.req.expired(t_dispatch):
                self._m_deadline.inc()
                tracer.instant("request:deadline-miss", "queue",
                               {"req_id": p.req.req_id,
                                "deadline_s": p.req.deadline_s})
                p.future.set_result(ShedResult(
                    req_id=p.req.req_id, value=None, ok=False,
                    error=f"deadline exceeded ({p.req.deadline_s}s)",
                    shed_reason="deadline", t_submit=p.req.t_submit))
            else:
                pendings.append(p)
        if not pendings:
            return
        req0 = pendings[0].req
        n = len(pendings)
        # retroactive queue-wait spans: started on the client thread at
        # submit (req.t_submit is on the same monotonic clock), ended now
        for p in pendings:
            tracer.complete("request:queue", "queue", p.req.t_submit,
                            t_dispatch, {"req_id": p.req.req_id,
                                         "reason": bucket.reason})
            self._m_queue_wait.observe(t_dispatch - p.req.t_submit)
        rec = {"op": "dispatch", "shape": req0.shape,
               "dtype": req0.dtype.name, "problem": req0.plan_problem,
               "direction": req0.direction, "filtered": req0.h is not None,
               "n": n, "padded": padded_size(n, self.max_batch),
               "bucket": bucket.key}
        if self._control is not None:
            self._control.send(rec)
        cp = out = err = None
        try:
            with tracer.span("batch:dispatch", "queue", n=n,
                             reason=bucket.reason, bucket=bucket.key):
                cp = self.cache.get(req0.shape, req0.dtype,
                                    req0.plan_problem)
                out, finite = self._run_batch(cp, rec, pendings)
        except Exception as e:  # resolve futures, never kill the worker
            err = e
        if isinstance(err, KernelError):  # ... unless a kernel failed
            # (every rank raised it: see PlanCache._settle, _settle_batch)
            for p in pendings:
                if not p.future.done():
                    p.future.set_exception(err)
            raise err
        nonfinite = err is None and not finite
        poisoned = ([p for p in pendings if not p.req.payload_finite()]
                    if nonfinite else [])
        # a failed dispatch, or non-finite output from finite input,
        # counts toward quarantine: quarantine_after consecutive failures
        # re-route the bucket to the next degradation-ladder rung
        # (repro_torch.resil.degrade) — on every rank alike
        report = (cp.key if cp is not None
                  and (err is not None or (nonfinite and not poisoned))
                  else None)
        if self._control is not None:
            self._control.send({"op": "outcome", "report": report})
        if err is not None:
            msg = f"{type(err).__name__}: {err}"
            self._m_failures.inc(n)
            if report is not None:
                self.cache.report_dispatch_failure(report)
            for p in pendings:
                if not p.future.done():
                    p.future.set_result(TransformResult(
                        req_id=p.req.req_id, value=None, ok=False,
                        error=msg))
            return
        if nonfinite:
            self._handle_nonfinite(cp, bucket, pendings, poisoned,
                                   t_dispatch, _isolate)
            return
        t_done = time.monotonic()
        padded = rec["padded"]
        for i, p in enumerate(pendings):
            p.future.set_result(TransformResult(
                req_id=p.req.req_id, value=out[i],
                latency_s=t_done - p.req.t_submit, batch_size=n,
                padded_size=padded, plan_state=cp.state,
                plan_key=cp.key, t_submit=p.req.t_submit,
                t_dispatch=t_dispatch, t_done=t_done))
        self._m_requests.inc(n)
        self._m_batches.inc()
        self._m_real_rows.inc(n)
        self._m_padded_rows.inc(padded)
        self._m_waste_rows.inc(padded - n)
        self._m_batch_hist.observe(n)
        for p in pendings:
            self._m_latency.observe(t_done - p.req.t_submit)

    def _follow_dispatch(self, rec: dict) -> None:
        """Run one of rank 0's dispatches on this rank: the same
        ``cache.get`` and batched transform, then rank 0's outcome."""
        err = None
        try:
            cp = self.cache.get(rec["shape"], rec["dtype"], rec["problem"])
            self._run_batch(cp, rec, None)
        except Exception as e:
            # rank 0 failed alike (its fault decisions are broadcast, and
            # a plan refused here is refused there); its outcome follows
            err = e
            _log.debug("dispatch failed on rank %d", self._control.rank,
                       exc_info=True)
        if isinstance(err, KernelError):
            raise err
        out = self._control.recv()
        if out["report"] is not None:
            self.cache.report_dispatch_failure(out["report"])

    def _fire_dispatch(self, key: str) -> None:
        if self._control is None:
            inject_lib.fire("serve.dispatch", key)
        else:
            self._control.fire("serve.dispatch", key)

    def _run_batch(self, cp, rec: dict, pendings) -> tuple:
        """Execute with retry-with-backoff for *transient* dispatch
        faults (typed ``resil.TransientFault`` — real device errors are
        not transient-classifiable and fail straight through)."""
        attempt = 0
        while True:
            try:
                self._fire_dispatch(rec["bucket"])
                return self._execute(cp.plan, rec, pendings)
            except inject_lib.TransientFault:
                if attempt >= self.dispatch_retries:
                    raise
                if self._leader:
                    self._m_retries.inc()
                    tracer_lib.get_tracer().instant(
                        "batch:retry", "queue",
                        {"bucket": rec["bucket"], "attempt": attempt})
                    if self.retry_backoff_s:
                        time.sleep(self.retry_backoff_s * (2 ** attempt))
                attempt += 1

    def _handle_nonfinite(self, cp, bucket, pendings, poisoned, t_dispatch,
                          isolate: bool) -> None:
        """A dispatch produced NaN/Inf rows.  If any *input* was
        non-finite, this is payload poisoning: the poisoned requests
        resolve as typed failures and every healthy batch-mate
        re-dispatches individually — one bad request must not corrupt
        its neighbors (shared collectives make row-level containment
        unverifiable).  All-finite inputs mean the *plan* produced
        garbage: every request fails typed and the failure has counted
        toward the plan's quarantine."""
        if not poisoned:
            self._m_nan_outputs.inc()
            self._m_failures.inc(len(pendings))
            self.cache.report_dispatch_failure(cp.key)
            for p in pendings:
                p.future.set_result(TransformResult(
                    req_id=p.req.req_id, value=None, ok=False,
                    error="non-finite output from finite input (plan "
                          "poisoned; counted toward quarantine)",
                    plan_key=cp.key, t_submit=p.req.t_submit,
                    t_dispatch=t_dispatch))
            return
        bad = {id(p) for p in poisoned}
        self._m_poisoned.inc(len(poisoned))
        self._m_failures.inc(len(poisoned))
        for p in poisoned:
            tracer_lib.get_tracer().instant(
                "request:poisoned", "queue", {"req_id": p.req.req_id})
            p.future.set_result(TransformResult(
                req_id=p.req.req_id, value=None, ok=False,
                error="poisoned payload: non-finite input",
                plan_key=cp.key, t_submit=p.req.t_submit,
                t_dispatch=t_dispatch))
        healthy = [p for p in pendings if id(p) not in bad]
        if not healthy:
            return
        if not isolate:  # already a 1-request redispatch; don't recurse
            for p in healthy:
                p.future.set_result(TransformResult(
                    req_id=p.req.req_id, value=None, ok=False,
                    error="non-finite output on isolated redispatch",
                    plan_key=cp.key, t_submit=p.req.t_submit,
                    t_dispatch=t_dispatch))
            return
        self._m_redispatch.inc(len(healthy))
        for i, p in enumerate(healthy):
            try:
                self._dispatch(Bucket(bucket.key, [p], reason="redispatch"),
                               _isolate=False)
            except KernelError as e:
                for q in healthy[i + 1:]:
                    q.future.set_exception(e)
                raise

    def _execute(self, plan, rec: dict, pendings) -> tuple:
        """Stack, pad, place, run the batched transform, fetch to host;
        returns (the host batch on rank 0 — its real rows at least —,
        whether its real rows are finite).

        ``pendings`` holds the requests on rank 0 (None on the other
        ranks of a mesh, which get their blocks from rank 0 and send
        their result blocks back).  The NaN guard reduces on the device,
        before the fetch: a scan of the fetched host batch costs about a
        third of a second a GiB.  On a mesh one all-reduce then settles
        the batch on every rank — finite, non-finite, or failed here or
        on another rank (a kernel that fails on one rank after the last
        collective fails the batch on every rank alike).
        Phase spans (h2d -> compute -> d2h) are emitted when tracing is
        enabled; the compute span then ends in a
        ``torch.cuda.synchronize`` so the d2h span times only the fetch.
        With the no-op tracer nothing else is synchronized."""
        tracer = tracer_lib.get_tracer()
        padded, forward = rec["padded"], rec["direction"] == "forward"
        in_dtype = plan.input_dtype if forward else plan.dtype
        with tracer.span("batch:h2d", "h2d/d2h", rows=padded):
            xd = self._place(
                plan, None if pendings is None
                else [p.req.x for p in pendings], padded, in_dtype,
                plan.batched_sharding("input" if forward else "output"),
                plan.shape if forward else plan.spectrum_shape)
            hd = None
            if rec["filtered"]:
                hd = self._place(
                    plan, None if pendings is None
                    else [p.req.h for p in pendings], padded, plan.dtype,
                    plan.batched_sharding("output"), plan.spectrum_shape)
            if tracer.enabled and xd.is_cuda:
                torch.cuda.synchronize(xd.device)
        finite, err = True, None
        try:
            with tracer.span("batch:compute", "fft", rows=padded,
                             direction=rec["direction"],
                             problem=rec["problem"]):
                if hd is not None:
                    out = plan.forward_filtered_batched(xd, hd)
                elif forward:
                    out = plan.forward_batched(xd)
                else:
                    out = plan.inverse_batched(xd)
                if tracer.enabled and out.is_cuda:
                    torch.cuda.synchronize(out.device)
            if self.nan_guard:
                finite = bool(torch.isfinite(out[:rec["n"]]).all())
        except Exception as e:
            if self._control is None:
                raise
            err = e
        if self._control is not None:
            finite = self._settle_batch(err, finite)
        with tracer.span("batch:d2h", "h2d/d2h", rows=rec["n"]):
            if self._control is None:
                real = out[:rec["n"]]
                if self._staging is not None:
                    return self._staging.download(real).numpy(), finite
                return real.cpu().numpy(), finite
            return self._control.gather(
                out, plan.batched_sharding("output" if forward else "input"),
                (padded,) + (plan.spectrum_shape if forward
                             else plan.shape)), finite

    def _settle_batch(self, err: Optional[BaseException],
                      finite: bool) -> bool:
        """One all-reduce over the ranks: whether every rank's block is
        finite; raises on every rank when the batch failed on any — the
        rank's own error where it struck."""
        code = (3 if isinstance(err, KernelError) else 2 if err is not None
                else 0 if finite else 1)
        worst = self._control.worst(code)
        if worst >= 2:
            if err is not None:
                raise err
            kind = KernelError if worst == 3 else RuntimeError
            raise kind("the batch failed on another rank")
        return worst == 0

    def _place(self, plan, arrays, padded: int, dtype: torch.dtype, block,
               shape: tuple) -> torch.Tensor:
        """This rank's block of the zero-padded stack of ``arrays`` (rank
        0's payloads) on ``plan.device``.  Meshless on the card each
        payload goes to its row through the pinned staging: no host
        stack is made."""
        full = (padded,) + tuple(shape)
        if self._control is None:
            if self._staging is None:
                host = torch.empty(full, dtype=dtype)
                stack_and_pad(arrays, padded, out=host.numpy())
                return host.to(plan.device)
            dev = torch.empty(full, dtype=dtype, device=plan.device)
            dev[len(arrays):].zero_()
            for row, a in zip(dev, arrays):
                self._staging.upload(_host_tensor(a), row)
            return dev
        host = None
        if arrays is not None:
            host = np.empty(full, dtype=numpy_dtype(dtype))
            stack_and_pad(arrays, padded, out=host)
        return self._control.scatter(host, block, full, dtype).to(
            plan.device)

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        """A dict view over the metrics registry (the reference's shape,
        kept for callers); new code should read ``service.registry``
        directly (``snapshot()`` / ``to_prometheus()``)."""
        n_requests = int(self._m_requests.value)
        n_batches = int(self._m_batches.value)
        real_rows = int(self._m_real_rows.value)
        padded_rows = int(self._m_padded_rows.value)

        # exact batch-size histogram back out of the explicit-bounds
        # buckets (cumulative -> per-size counts keyed by int size)
        batch_hist = {}
        prev = 0
        for edge, cum in self._m_batch_hist.buckets()[:-1]:
            if cum > prev:
                batch_hist[int(edge)] = cum - prev
            prev = cum

        def q(p):
            v = self._m_latency.quantile(p)
            return None if v is None else v * 1e3

        return {
            "requests": n_requests,
            "batches": n_batches,
            "mean_batch": (n_requests / n_batches if n_batches else 0.0),
            "real_rows": real_rows,
            "padded_rows": padded_rows,
            "padding_waste_rows": int(self._m_waste_rows.value),
            "occupancy": (real_rows / padded_rows if padded_rows else 0.0),
            "batch_hist": batch_hist,
            "pending": self._batcher.pending + self._queue.qsize(),
            "latency_ms": {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)},
            "plan_cache": self.cache.snapshot(),
        }
