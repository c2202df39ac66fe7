"""Host->device feed pipeline: threaded prefetch + async device_put.

Reference analogue: none — the reference is a synchronous single-thread
read loop (SURVEY.md §2.2 "Pipeline parallelism: No"). The accelerator
equivalent (SURVEY.md §7.1.5): the C++ reader/packer parses and 2-bit
packs the next batches on a background thread while the device runs the
current batch; `jax.device_put` is dispatched eagerly so the transfer
overlaps compute. Bounded queue depth keeps memory flat for arbitrarily
long streams (the streaming contract: reads are never stored).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Tuple

import numpy as np


_SENTINEL = object()


def prefetch_batches(batches: Iterable, depth: int = 2,
                     to_device: bool = True) -> Iterator:
    """Wrap a (bases, lens) batch iterator with a reader thread and an
    optional eager device_put, `depth` batches ahead."""
    import jax

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    err: list = []

    def worker():
        try:
            for item in batches:
                if to_device:
                    bases, lens = item
                    # lens stays host-side: the pipeline's metrics read
                    # it per batch without a device round trip
                    item = (jax.device_put(np.asarray(bases)),
                            np.asarray(lens))
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True,
                         name="faucet-io-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        yield item
    t.join()
    if err:
        raise err[0]
