"""Launch counts of the kernel wrappers, kept right from any thread.

Each wrapper adds to its count (a function attribute such as
``extend_batch.launches``) where it launches its kernel, through
``bump``.  Worker threads launch at the same time (the aligner's
prefetch thread, hybrid's device share, and one thread a replica under
``dist.sharding.DataParallel``), and ``fn.launches += 1`` is a load, an
add and a store that another thread can come between; so every count
moves under one lock.

Inside a ``DataParallel`` part the thread also has its replica's tally
(``tallying``): ``bump`` adds there too, under the key
``"<function>.<count>"``, so that two replicas on one card can be told
apart.
"""

from __future__ import annotations

import contextlib
import threading

LOCK = threading.Lock()
_local = threading.local()


def bump(fn, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to ``fn.<attr>``, and to the calling thread's replica
    tally where it has one."""
    if not n:
        return
    with LOCK:
        setattr(fn, attr, getattr(fn, attr) + n)
        tally = getattr(_local, "tally", None)
        if tally is not None:
            key = f"{fn.__name__}.{attr}"
            tally[key] = tally.get(key, 0) + n


def add(tally: dict, key: str, n: int) -> None:
    """Add ``n`` to ``tally[key]`` under the counts' lock."""
    with LOCK:
        tally[key] = tally.get(key, 0) + n


@contextlib.contextmanager
def tallying(tally: dict):
    """Within the block, this thread's ``bump``s also go to ``tally``."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield
    finally:
        _local.tally = prev
