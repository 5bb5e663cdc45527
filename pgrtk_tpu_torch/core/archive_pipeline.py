"""Asynchronous archive input pipeline — the port's copy of
pgrtk_tpu/core/archive_pipeline.py.

The reference decodes AGC archives on a dedicated reader thread pool in
1024-contig chunks with thread-local archive handles, keeping the
sketching workers fed (pgr-db/src/agc_io.rs:201-333).  This is the
equivalent for the index build: a ThreadPoolExecutor whose workers each
hold their OWN archive handle (the native readers are not shared across
threads, like the reference's thread_local AGCFile), decoding a bounded
window of chunks ahead of the consumer.  The C++ decode releases the
GIL, so readers overlap the sketch.

Memory is bounded by prefetch * chunk_contigs decoded contigs; order is
preserved (chunks yield in submission order).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

Record = Tuple[Optional[str], str, bytes]  # (sample/source, ctg, bases)


def stream_archive(path: str, chunk_contigs: int = 1024, nthreads: int = 4,
                   prefetch: int = 4) -> Iterator[List[Record]]:
    """Yield (sample, ctg, seq) records from a .pga or .agc archive in
    chunks of `chunk_contigs`, in the archive's order, decoded up to
    `prefetch` chunks ahead of the consumer by `nthreads` readers."""
    from .agc import open_archive

    head = open_archive(path)
    jobs: List[List[Tuple[str, str]]] = []
    cur: List[Tuple[str, str]] = []
    for sample in head.list_samples():
        for ctg, _ln in head.list_ctgs(sample):
            cur.append((sample, ctg))
            if len(cur) >= chunk_contigs:
                jobs.append(cur)
                cur = []
    if cur:
        jobs.append(cur)

    if len(jobs) <= 1 or nthreads <= 1:
        # one chunk or one reader: decode on the handle already open
        for job in jobs:
            yield [(s, c, head.get_seq(s, c)) for s, c in job]
        return

    local = threading.local()

    def decode(job: List[Tuple[str, str]]) -> List[Record]:
        handle = getattr(local, "archive", None)
        if handle is None:
            # one handle per reader thread (agc_io.rs:218 thread_local)
            handle = open_archive(path)
            local.archive = handle
        return [(s, c, handle.get_seq(s, c)) for s, c in job]

    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        it = iter(jobs)
        inflight = [pool.submit(decode, job)
                    for _, job in zip(range(max(1, prefetch)), it)]
        while inflight:
            fut = inflight.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                inflight.append(pool.submit(decode, nxt))
            yield fut.result()
