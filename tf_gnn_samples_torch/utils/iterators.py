"""Host-side prefetch of minibatches (counterpart of
tf_gnn_samples_tpu/utils/iterators.py): a background thread packs and pads
the next batches (numpy work) while the card runs the current step; queue
depth 5, as the reference's dpu_utils ThreadedIterator."""

import queue
import threading
from typing import Iterable, Iterator


class ThreadedIterator(Iterator):
    """Background-thread prefetch with clean early abandonment.

    A consumer that stops iterating early (a training step that raises
    mid-epoch) calls `close()`, also called on context-manager exit and by
    __del__: the worker then stops at its next put, so neither the thread
    nor the rest of the inner pipeline outlives the epoch. An exception of
    the inner iterator is raised in the consumer at the point where it
    occurred in the sequence."""

    _SENTINEL = object()

    def __init__(self, inner: Iterable, max_queue_size: int = 5):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max_queue_size)
        self._error = None
        self._closed = threading.Event()

        def put(item) -> bool:
            # Bounded puts that re-check the closed flag, so that an
            # abandoned consumer cannot strand the worker on a full queue.
            while not self._closed.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in inner:
                    if not put(item):
                        return
            except BaseException as e:  # handed to the consumer thread
                self._error = e
            finally:
                put(self._SENTINEL)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the worker; safe to call more than once."""
        self._closed.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item
