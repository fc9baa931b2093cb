"""Serving engine: a micro-batching request runner.

Counterpart of ``adaptive_classifier_tpu/serving.py``, the same host
engine.  ``BatchingClassifierServer`` runs ``num_workers`` (default 2)
worker threads that drain one request queue, group single requests into
batches of up to ``max_batch_size`` (waiting at most ``max_wait_ms`` for
more), run each batch through the classifier's batched device pipeline
(``predict_batch``, which pads it to the batch buckets {1, 8, 64, chunk}),
and resolve every request's future.

- **priorities**: ``submit_predict(..., priority=1)`` jumps the queue;
  FIFO order holds within a priority level.
- **deadlines and shedding**: a request whose ``deadline_ms`` passes while
  it is queued resolves to ``DeadlineExceeded`` before it takes a batch
  slot; at ``max_queue_depth`` new work resolves to ``ServerOverloaded`` at
  admission, so the queue cannot grow without bound.
- **multi-tenancy**: ``MultiTenantServer`` serves several classifiers on
  one device behind one queue; a batch never mixes models.
- **predict modes**: ``regular`` (``predict_batch``), ``robust``,
  ``strategic`` and ``dual``; without strategic mode, which is not ported,
  the last three answer as ``predict`` does.

While one worker waits on the device, another collects, tokenizes and
fans out results.  Every worker launches on the device's current stream,
so the device runs the batches in the order they were queued, and a
device-cache row is written before any later batch gathers it.  A
reader-writer lock keeps the classifier single-writer: predict batches
hold it shared and run concurrently, ``add_examples`` holds it
exclusively.  A worker's exception resolves the futures of its batch.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)


class ServerOverloaded(RuntimeError):
    """Raised into a request's future when the queue is at max_queue_depth."""


class DeadlineExceeded(TimeoutError):
    """Raised into a request's future when its deadline passed while queued."""


@dataclass
class _Request:
    kind: str                       # "predict" | "add"
    model: str                      # tenant name ("default" for single-model)
    texts: List[str]
    labels: Optional[List[str]]
    k: int
    priority: int = 0               # higher = served sooner
    deadline: Optional[float] = None  # time.monotonic() cutoff
    mode: str = "regular"           # "regular"|"dual"|"strategic"|"robust"
    future: "Future" = field(default_factory=Future)

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic()) > self.deadline)


#: prediction modes → batched classifier entry points (batches never mix
#: modes; the strategic forms require enable_strategic_mode)
_PREDICT_MODES = ("regular", "dual", "strategic", "robust")


class _PriorityChannel:
    """Priority-then-FIFO blocking channel with a depth cap.

    ``queue.PriorityQueue`` plus the bookkeeping the server needs:
    monotonic sequence numbers keep FIFO order inside a priority level,
    and ``put`` is non-blocking — admission control happens here.
    """

    def __init__(self, maxsize: int = 0):
        self._heap: list = []
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._seq = itertools.count()
        self.maxsize = maxsize

    def put(self, req: Optional[_Request]) -> bool:
        """False if shed at admission (full); sentinels are never shed."""
        with self._lock:
            if (req is not None and self.maxsize > 0
                    and len(self._heap) >= self.maxsize):
                return False
            prio = 0 if req is None else req.priority
            # max-heap on priority via negation; sentinel sorts last within
            # its level (drains after queued work)
            heapq.heappush(self._heap, (-prio, next(self._seq), req))
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Optional[_Request]:
        """Blocks; raises queue.Empty on timeout."""
        with self._not_empty:
            if not self._heap and not self._not_empty.wait_for(
                    lambda: bool(self._heap), timeout=timeout):
                raise queue.Empty
            return heapq.heappop(self._heap)[2]

    def qsize(self) -> int:
        with self._lock:
            return len(self._heap)


class _RWLock:
    """Reader-writer lock with writer preference.

    Predict batches hold it shared (the classifier's predict pipeline is
    read-only and thread-safe); ``add_examples`` holds it exclusively —
    the single-WRITER model (memory.py), not single-threaded serving.
    A waiting writer blocks new readers so continual-learning requests
    cannot starve under sustained predict load.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class BatchingClassifierServer:
    """Micro-batching front end over an AdaptiveClassifier.

    >>> server = BatchingClassifierServer(clf, max_batch_size=64, max_wait_ms=2)
    >>> server.start()
    >>> fut = server.submit_predict("some text", k=3)
    >>> fut.result()
    [("label", 0.93), ...]
    """

    def __init__(self, classifier=None, max_batch_size: int = 64,
                 max_wait_ms: float = 2.0, max_queue_depth: int = 0,
                 classifiers: Optional[Dict[str, object]] = None,
                 num_workers: int = 2):
        if classifiers is None:
            if classifier is None:
                raise ValueError("need a classifier (or classifiers=...)")
            classifiers = {"default": classifier}
        elif classifier is not None:
            raise ValueError("pass classifier or classifiers, not both")
        self.classifiers = dict(classifiers)
        self.classifier = next(iter(self.classifiers.values()))
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self._chan = _PriorityChannel(maxsize=max_queue_depth)
        self._pending = 0               # admitted, not yet resolved
        self._pending_lock = threading.Lock()
        self._drained = threading.Condition(self._pending_lock)
        self.num_workers = max(1, int(num_workers))
        self._workers: List[threading.Thread] = []
        self._rw = _RWLock()            # predict=shared, add=exclusive
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self.requests_shed = 0          # admission-control rejections
        self.requests_expired = 0       # deadline drops

    # -- lifecycle ------------------------------------------------------
    def start(self):
        if self._workers:
            return
        self._stop.clear()
        self._workers = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"ac-serving-{i}")
            for i in range(self.num_workers)
        ]
        for w in self._workers:
            w.start()

    def stop(self, drain: bool = True):
        if not self._workers:
            return
        if drain:
            with self._drained:
                self._drained.wait_for(lambda: self._pending == 0)
        self._stop.set()
        for _ in self._workers:
            self._chan.put(None)  # wake blocked workers
        for w in self._workers:
            w.join(timeout=10)
        self._workers = []

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- submission -----------------------------------------------------
    def _admit(self, req: _Request) -> "Future":
        with self._pending_lock:
            self._pending += 1
        if not self._chan.put(req):
            self.requests_shed += 1
            self._done(1)
            req.future.set_exception(ServerOverloaded(
                f"queue at max depth {self._chan.maxsize}"))
        return req.future

    def _done(self, n: int = 1):
        with self._drained:
            self._pending -= n
            if self._pending == 0:
                self._drained.notify_all()

    def submit_predict(self, text: str, k: int = 5, priority: int = 0,
                       deadline_ms: Optional[float] = None,
                       model: str = "default",
                       mode: str = "regular") -> "Future":
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        if model not in self.classifiers:
            f: Future = Future()
            f.set_exception(KeyError(f"unknown model {model!r}"))
            return f
        if mode not in _PREDICT_MODES:
            f = Future()
            f.set_exception(ValueError(
                f"unknown mode {mode!r} (use one of {_PREDICT_MODES})"))
            return f
        return self._admit(_Request("predict", model, [text], None, k,
                                    priority=priority, deadline=deadline,
                                    mode=mode))

    def predict(self, text: str, k: int = 5, timeout: Optional[float] = None,
                priority: int = 0, deadline_ms: Optional[float] = None,
                model: str = "default", mode: str = "regular"):
        return self.submit_predict(
            text, k, priority=priority, deadline_ms=deadline_ms, model=model,
            mode=mode,
        ).result(timeout=timeout)

    def submit_add_examples(self, texts: List[str], labels: List[str],
                            model: str = "default") -> "Future":
        if model not in self.classifiers:
            f: Future = Future()
            f.set_exception(KeyError(f"unknown model {model!r}"))
            return f
        return self._admit(_Request("add", model, list(texts), list(labels), 0))

    # -- worker ---------------------------------------------------------
    def _take(self, held: List[Optional[_Request]],
              timeout: Optional[float]) -> Optional[_Request]:
        """Next request from this worker's holdover or the channel; expired
        ones resolve to DeadlineExceeded immediately and are never
        returned."""
        while True:
            if held[0] is not None:
                req, held[0] = held[0], None
            else:
                req = self._chan.get(timeout=timeout)  # may raise queue.Empty
            if req is not None and req.expired():
                with self._stats_lock:
                    self.requests_expired += 1
                req.future.set_exception(DeadlineExceeded("deadline exceeded in queue"))
                self._done(1)
                continue
            return req

    def _collect(self, held: List[Optional[_Request]]) -> List[_Request]:
        """Wait for one request, then coalesce more until the batch fills
        or max_wait elapses.  Batches never mix kinds or models (training
        acts as a barrier — single-writer model); the odd one out goes to
        this worker's holdover slot for its next batch."""
        try:
            # bounded first take so every worker re-checks _stop even if
            # another worker consumed its wake-up sentinel
            first = self._take(held, timeout=0.25)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        if first.kind != "predict":
            return batch
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._take(held, timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            if (nxt.kind != "predict" or nxt.model != first.model
                    or nxt.mode != first.mode):
                held[0] = nxt
                break
            batch.append(nxt)
        return batch

    def _run(self):
        held: List[Optional[_Request]] = [None]  # this worker's holdover
        while not self._stop.is_set():
            batch = self._collect(held)
            if not batch:
                continue
            try:
                clf = self.classifiers[batch[0].model]
                if batch[0].kind == "add":
                    req = batch[0]
                    self._rw.acquire_write()   # training is a barrier
                    try:
                        clf.add_examples(req.texts, req.labels)
                        req.future.set_result(True)
                    except Exception as e:
                        req.future.set_exception(e)
                    finally:
                        self._rw.release_write()
                        self._done(1)
                    continue

                texts = [r.texts[0] for r in batch]
                k = max(r.k for r in batch)
                mode = batch[0].mode
                self._rw.acquire_read()        # predicts run concurrently
                try:
                    if mode == "robust":
                        results = clf.predict_robust_batch(texts, k=k)
                    elif mode == "strategic":
                        results = clf.predict_strategic_batch(texts, k=k)
                    elif mode == "dual":
                        # predict()'s strategic-mode semantics, batched
                        results = (clf._predict_dual_batch(texts, k=k)
                                   if clf.strategic_mode
                                   else clf._predict_regular_batch(texts, k))
                    else:
                        results = clf.predict_batch(
                            texts, k=k, batch_size=self.max_batch_size
                        )
                    for r, res in zip(batch, results):
                        r.future.set_result(res[: r.k])
                except Exception as e:
                    for r in batch:
                        if not r.future.done():
                            r.future.set_exception(e)
                finally:
                    self._rw.release_read()
                    self._done(len(batch))
                with self._stats_lock:
                    self.batches_run += 1
                    self.requests_served += len(batch)
            except Exception:  # pragma: no cover — keep the worker alive
                logger.exception("serving worker error")

    # -- introspection --------------------------------------------------
    def stats(self) -> dict:
        return {
            "batches_run": self.batches_run,
            "requests_served": self.requests_served,
            "requests_shed": self.requests_shed,
            "requests_expired": self.requests_expired,
            "mean_batch_size": (
                self.requests_served / self.batches_run if self.batches_run else 0.0
            ),
            "queue_depth": self._chan.qsize(),
            "models": sorted(self.classifiers),
        }


class MultiTenantServer(BatchingClassifierServer):
    """Several classifiers on one device behind one scheduler.

    >>> server = MultiTenantServer({"intent": clf_a, "sentiment": clf_b})
    >>> server.start()
    >>> server.submit_predict("hello", model="sentiment").result()

    Scheduling is priority-then-FIFO across tenants; a device batch never
    mixes models (each tenant's memory/head are separate device buffers),
    so interleaved traffic costs one batch boundary per model switch —
    sustained per-tenant streams batch as well as a dedicated server.
    """

    def __init__(self, classifiers: Dict[str, object], **kwargs):
        if not classifiers:
            raise ValueError("MultiTenantServer needs at least one classifier")
        super().__init__(classifiers=classifiers, **kwargs)

    def add_model(self, name: str, classifier) -> None:
        """Register a tenant (safe while serving: dict writes are atomic,
        and the worker only reads entries for requests already admitted)."""
        if name in self.classifiers:
            raise ValueError(f"model {name!r} already registered")
        self.classifiers[name] = classifier
