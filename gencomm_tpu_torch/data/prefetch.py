"""Batch producers off the training thread.

Counterpart of ``gencomm_tpu/data/prefetch.py``: ``prefetch_iter`` runs the
host side of the pipeline (sampling, labels, the C++ pillar decoration,
which releases the GIL) on one producer thread through a bounded queue,
two deep by default, so batch N + 1 is built while the card runs step N;
``multi_worker_iter`` shards it over worker processes, like a
``DataLoader``'s ``num_workers``. Workers do host work only and return
numpy batches; they start with the ``spawn`` method, never ``fork``, since
the parent may hold CUDA and threads. The host-to-device copy stays on the
caller's thread.
"""

from __future__ import annotations

import queue
import threading


class PrefetchIterator:
    """Iterate ``src`` on a background thread through a bounded queue.

    Exceptions (StopIteration included) raised by the producer are raised
    again in the consumer. ``close()`` (also called on deletion and at the
    end) stops the producer promptly even if the queue is full."""

    _DONE = object()

    def __init__(self, src, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce,
                                        args=(iter(src),), daemon=True)
        self._thread.start()

    def _produce(self, it):
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._put_forever((self._DONE, None))
        except BaseException as exc:  # handed to the consumer, raised there
            self._put_forever((self._DONE, exc))

    def _put_forever(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is self._DONE:
            self.close()
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        return item

    def close(self):
        self._stop.set()

    def __del__(self):
        self.close()


def prefetch_iter(src, depth: int = 2) -> PrefetchIterator:
    return PrefetchIterator(src, depth=depth)


_WORKER_DONE = "__worker_done__"


def _worker(make_iter, w, q):
    """A worker process: put every batch of ``make_iter(w)`` on ``q``."""
    try:
        for batch in make_iter(w):
            q.put(batch)
    finally:
        q.put(_WORKER_DONE)


class MultiWorkerIterator:
    """Batches from ``num_workers`` spawned processes, in arrival order.
    ``make_iter(worker_id)`` is called inside each worker and returns its
    iterator of batches; it is sent to the worker by pickle, so it must be
    a module-level function or a ``functools.partial`` of one."""

    def __init__(self, make_iter, num_workers: int = 2, depth: int = 2):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._q = ctx.Queue(maxsize=max(1, num_workers * depth))
        self._procs = []
        self._live = num_workers
        for w in range(num_workers):
            p = ctx.Process(target=_worker, args=(make_iter, w, self._q),
                            daemon=True)
            p.start()
            self._procs.append(p)

    def __iter__(self):
        return self

    def __next__(self):
        while self._live > 0:
            item = self._q.get()
            if isinstance(item, str) and item == _WORKER_DONE:
                self._live -= 1
                continue
            return item
        self.close()
        raise StopIteration

    def close(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=2.0)
        self._procs = []

    def __del__(self):
        self.close()


def multi_worker_iter(make_iter, num_workers: int,
                      depth: int = 2) -> MultiWorkerIterator:
    return MultiWorkerIterator(make_iter, num_workers, depth)
