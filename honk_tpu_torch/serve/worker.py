"""One long-lived thread that runs every device job of its owner, in order.

The HTTP server answers each connection on a new thread, and PyTorch's
first device calls on a new thread cost milliseconds of host time (the
per-thread setup of cuDNN and cuBLAS), so the serving objects do none of
their device work on the caller's thread: ``run(fn, *args)`` queues the
job for the worker and blocks until it is done, returning its result or
raising its exception. A job started from the worker itself runs inline,
so nested device work cannot deadlock on the queue.

A job must not wait for anything that only another job can produce, and
must not take a lock that a caller holds while it waits in ``run``.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class DeviceWorker:
    """A daemon thread with a job queue; ``run`` hands it a call and waits for the result."""

    def __init__(self, name: str):
        self._jobs: "queue.SimpleQueue[tuple | None]" = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    @property
    def ident(self) -> int | None:
        """The worker thread's ident."""
        return self._thread.ident

    def run(self, fn: Callable[..., Any], *args: Any, **kwargs: Any) -> Any:
        """``fn(*args, **kwargs)`` on the worker thread; blocks until it returns or raises."""
        if threading.current_thread() is self._thread:
            return fn(*args, **kwargs)
        if not self._thread.is_alive():
            raise RuntimeError(f"the device worker {self._thread.name!r} has stopped")
        done = threading.Event()
        box: list = []
        self._jobs.put((fn, args, kwargs, box, done))
        done.wait()
        ok, value = box[0]
        if not ok:
            raise value
        return value

    def _loop(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, args, kwargs, box, done = job
            try:
                box.append((True, fn(*args, **kwargs)))
            except BaseException as e:  # handed to the caller, which raises it
                box.append((False, e))
            finally:
                del fn, args, kwargs
                done.set()

    def close(self, timeout: float = 60.0) -> None:
        """Stop the thread after the jobs already queued."""
        if self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join(timeout)
