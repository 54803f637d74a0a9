"""Hybrid dynamic chunk scheduler: device + native-CPU workers over one queue.

Parity: the reference's dynamic chunked multi-GPU+CPU load balancer
(`gpu_perman64_*_multigpucpu_chunks`, gpu_exact_dense.cu:776-896): the
Gray-code range is over-decomposed into work units; `gpu_num+1` OpenMP
threads pull unit ids from a shared counter under `#pragma omp critical`,
with thread `gpu_num` running the OpenMP CPU kernel.  Redesign:

* one Python worker thread drives the (possibly mesh-sharded) device
  engine, an optional second drives the native C++ OpenMP engine
  (native/perman_cpu.cpp: sup_perman_dense_chunks) — both pull unit ids
  from a lock-protected counter (the GIL is released inside both device
  execution and the ctypes call, so the workers genuinely overlap);
* per-unit progress logs mirror "ChunkID k is DONE by kernel i in t"
  (gpu_exact_dense.cu:876);
* each finished unit is journaled to an optional checkpoint file, so a
  killed run resumes by replaying the journal and skipping finished units
  (the reference has no checkpointing; its chunked scheduler is already
  shaped for it — SURVEY.md §5);
* a unit that raises is retried (up to 3 attempts); a unit that exhausts
  its retries on one worker kind is handed back to the queue for the
  OTHER kind (a persistent device-side error still completes on the CPU
  worker), and the run only fails once every participating kind has
  rejected it — failure detection and recovery the reference lacks (it
  exit(1)s);
* the reference's manual static distribution (hard-coded 3/8,3/8,1/8,1/8
  fractions for a heterogeneous box,
  gpu_exact_dense.cu:941-968) is subsumed: dynamic pulling gives every
  worker exactly the fraction it can sustain, with no hand tuning.

Exactness: unit partials are raw Gray-term sums over the row-scaled
matrix; for integer matrices every partial is exactly representable, so
the final float64 sum is independent of which worker computed what.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops import gray
from ..utils import trace


@dataclass
class HybridStats:
    units_total: int = 0
    units_device: int = 0
    units_cpu: int = 0
    units_resumed: int = 0
    retries: int = 0
    handoffs: int = 0   # units that exhausted retries on one worker kind
    #                     and completed on the other


def _journal_key(a_s: np.ndarray, r: int, ids_blocks: np.ndarray,
                 num_shards: int) -> str:
    """Checkpoint identity.  The journal records (start, count) BLOCK
    ranges whose meaning depends on the full ids_blocks layout (lanes,
    pruned chunk list, shard padding), so the key must pin all of it:
    resuming with the same (n, r) but different lanes / pruning flags /
    mesh would otherwise replay partial sums against a differently-shaped
    block array and silently produce a wrong permanent."""
    h = hashlib.sha256(np.ascontiguousarray(a_s).tobytes()).hexdigest()[:16]
    hb = hashlib.sha256(
        np.ascontiguousarray(ids_blocks, dtype=np.int32).tobytes()
    ).hexdigest()[:16]
    B, lanes = ids_blocks.shape
    return f"{a_s.shape[0]}:{r}:{lanes}:{B}:{num_shards}:{h}:{hb}"


class _Journal:
    """Append-only checkpoint of (block range -> raw partial sum)."""

    def __init__(self, path: Optional[str], key: str):
        self.path = path
        self.key = key
        self.done: dict[tuple, float] = {}
        self._f = None
        if not path:
            return
        if os.path.exists(path):
            try:
                with open(path) as f:
                    head = json.loads(f.readline())
                    if head.get("key") == key:
                        for line in f:
                            rec = json.loads(line)
                            self.done[(int(rec["start"]),
                                       int(rec["count"]))] = \
                                float(rec["value"])
                    else:
                        trace.log(f"checkpoint {path}: key mismatch, "
                                  "starting fresh", level=1)
            except (ValueError, OSError, KeyError) as e:
                trace.log(f"checkpoint {path}: unreadable ({e}), "
                          "starting fresh", level=1)
                self.done = {}
        mode = "a" if self.done else "w"
        self._f = open(path, mode)
        if mode == "w":
            self._f.write(json.dumps({"key": key}) + "\n")
            self._f.flush()

    def record(self, start: int, count: int, value: float, by: str,
               dt: float) -> None:
        if self._f is None:
            return
        self._f.write(json.dumps({"start": start, "count": count,
                                  "value": value, "by": by,
                                  "t": round(dt, 4)}) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def compute_partials_hybrid(
        a_s: np.ndarray, ids_blocks: np.ndarray, x0_pair, cols_pair,
        plan: "gray.RyserPlan", *,
        df: bool, exact_storage: bool, mesh=None, kahan: bool = False,
        interpret: bool = False,
        threads: int = 16, cpu_helper: bool = True,
        checkpoint_path: Optional[str] = None,
        unit_blocks: Optional[int] = None):
    """Dynamic-chunked partial-sum computation.

    Returns (total, HybridStats).  `total` is the raw sum of Gray terms
    (no (4*(n&1)-2) factor, no 2**E unscaling) — same convention as
    parallel.sharding.compute_partials.
    """
    from .sharding import compute_partials

    B = ids_blocks.shape[0]
    num_shards = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    if unit_blocks is None:
        # over-decompose ~8 units per worker, but keep units shard-aligned
        workers = 2 if cpu_helper else 1
        unit_blocks = max(num_shards, B // max(1, 8 * workers))
    unit_blocks = -(-max(unit_blocks, num_shards) // num_shards) * num_shards
    # the CPU worker pulls FINER units so a slow CPU grab near the end
    # cannot stall the finish (a coarse CPU unit can idle the device
    # for seconds in the tail)
    cpu_blocks = max(num_shards, unit_blocks // 8)

    journal = _Journal(checkpoint_path,
                       _journal_key(a_s, plan.r, ids_blocks, num_shards))
    covered = np.zeros(B, dtype=bool)
    resumed_total = 0.0
    for (start, count), value in journal.done.items():
        covered[start:start + count] = True
        resumed_total += value
    stats = HybridStats(units_resumed=len(journal.done))
    stats.units_total = len(journal.done)

    lock = threading.Lock()
    pos = [0]
    results: dict[int, float] = {}
    failures: list[tuple[int, str, BaseException]] = []
    # blocks a worker KIND has exhausted its retries on; the unit returns
    # to the queue for the OTHER kind (e.g. a persistent device-side error
    # still completes on the CPU worker) and the run only fails if every
    # participating kind rejected it
    banned = {"device": np.zeros(B, dtype=bool),
              "cpu": np.zeros(B, dtype=bool)}
    alive = {"device": False, "cpu": False}

    def pull(k: int, kind: str) -> Optional[tuple[int, int]]:
        """Next run of up to k uncovered contiguous blocks this worker
        kind is allowed to take."""
        ban = banned[kind]
        with lock:
            # pos[0] is a kind-independent lower bound on the first
            # uncovered block; advance it past fully-covered prefix
            p = pos[0]
            while p < B and covered[p]:
                p += 1
            pos[0] = p
            while p < B and (covered[p] or ban[p]):
                p += 1
            if p >= B:
                return None
            start = p
            while p < B and not covered[p] and not ban[p] \
                    and p - start < k:
                p += 1
            covered[start:p] = True        # claimed
            return start, p

    def release(start: int, end: int, kind: str,
                err: BaseException) -> None:
        """Exhausted retries on `kind`: hand the unit back to the queue,
        banned for this kind only."""
        with lock:
            covered[start:end] = False
            banned[kind][start:end] = True
            failures.append((start, kind, err))
            pos[0] = min(pos[0], start)

    def run_device_unit(start: int, end: int) -> float:
        blk = ids_blocks[start:end]
        # pad every unit to the same (unit_blocks, L) shape: one compiled
        # kernel serves the whole run (sentinel -1 lanes contribute 0)
        pad = unit_blocks - len(blk)
        if pad:
            blk = np.concatenate(
                [blk, np.full((pad, blk.shape[1]), -1, np.int32)])
        out = compute_partials(blk, x0_pair, cols_pair, plan, df=df,
                               exact_storage=exact_storage, mesh=mesh,
                               kahan=kahan, interpret=interpret)
        return float(out.sum(dtype=np.float64))

    def run_cpu_unit(start: int, end: int) -> float:
        from ..bindings.native import perman_dense_chunks
        ids = ids_blocks[start:end].ravel()
        ids = ids[ids >= 0].astype(np.int64)
        if len(ids) == 0:
            return 0.0
        return perman_dense_chunks(a_s, ids, plan.r, threads)

    def worker(kind: str, fn, k: int):
        # alive[kind] was set True before the thread started (setting it
        # here would race the other worker's liveness check)
        other = "cpu" if kind == "device" else "device"
        try:
            _worker_loop(kind, other, fn, k)
        finally:
            alive[kind] = False

    def _worker_loop(kind: str, other: str, fn, k: int):
        while True:
            item = pull(k, kind)
            if item is None:
                with lock:
                    uncov = ~covered
                    if not uncov.any() or not alive[other]:
                        return
                    # blocks banned for BOTH kinds can never complete;
                    # don't wait on those (the final check reports them)
                    if np.all(banned["device"][uncov] & banned["cpu"][uncov]):
                        return
                # the other worker is still running and may hand units
                # back to this kind; wait for it
                time.sleep(0.02)
                continue
            start, end = item
            t0 = time.perf_counter()
            value = None
            for attempt in range(3):
                try:
                    value = fn(start, end)
                    break
                except Exception as e:          # noqa: BLE001 — retried
                    with lock:
                        stats.retries += 1
                    trace.log(f"blocks [{start},{end}) failed on {kind} "
                              f"(attempt {attempt + 1}): {e}", level=1)
                    err = e
            if value is None:
                # hand the unit back for the other worker kind; this
                # worker keeps pulling the rest of the queue
                trace.log(f"blocks [{start},{end}) exhausted retries on "
                          f"{kind}; returned to queue for {other}",
                          level=1)
                release(start, end, kind, err)
                continue
            dt = time.perf_counter() - t0
            with lock:
                results[start] = value
                stats.units_total += 1
                if kind == "device":
                    stats.units_device += 1
                else:
                    stats.units_cpu += 1
                if banned[other][start:end].any():
                    stats.handoffs += 1
                journal.record(start, end - start, value, kind, dt)
            trace.log(f"blocks [{start},{end}) DONE by {kind} "
                      f"in {dt:.4f}s", level=2)

    device_thread = threading.Thread(
        target=worker, args=("device", run_device_unit, unit_blocks),
        name="hybrid-device")
    threads_list = [("device", device_thread)]
    if cpu_helper:
        from ..bindings.native import native_available
        if native_available():
            threads_list.append(("cpu", threading.Thread(
                target=worker, args=("cpu", run_cpu_unit, cpu_blocks),
                name="hybrid-cpu")))
        else:
            trace.log("hybrid: native CPU engine unavailable, "
                      "running device-only", level=1)
    for kind, _ in threads_list:
        alive[kind] = True
    for _, t in threads_list:
        t.start()
    for _, t in threads_list:
        t.join()
    journal.close()

    if not covered.all():
        # blocks rejected by every participating worker kind
        if failures:
            start, kind, err = failures[0]
            raise RuntimeError(
                f"hybrid scheduler: blocks at {start} failed on {kind} "
                f"worker after retries: {err}") from err
        raise RuntimeError("hybrid scheduler: blocks never completed")
    total = resumed_total + float(np.sum(np.fromiter(
        (results[s] for s in sorted(results)), dtype=np.float64)))
    return total, stats
