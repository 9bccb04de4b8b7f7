"""Start the ranks of a ``torch.distributed`` program on this host.

The JAX package drives every device from one process; the port's parallel
layer runs one process per rank (SPMD). :func:`launch` starts them with
the ``spawn`` start method, joins them through a ``file://`` rendezvous in
a temporary directory (no TCP port to pick), runs ``fn(*args)`` in each
and returns the ranks' results.

Backends are explicit: 'nccl' needs one card per rank (NCCL refuses two
ranks on one device) and raises otherwise; 'gloo' runs on the CPU, or with
ranks that share cards (rank r computes on card r mod the card count). A
rank that fails fails the launch: the other ranks are stopped, and the
failed rank's traceback is raised.
"""

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# seconds a launch may take to return every rank's result, and each
# collective of its process group
TIMEOUT_S = 600


def _rank_main(rank, world_size, backend, device, rendezvous, fn, args,
               results, received):
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{rendezvous}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, result))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    # tensors in a result are shared from this process's memory: it stays
    # until the parent has them
    received.wait(TIMEOUT_S)


def launch(fn, world_size, backend, args=(), device="cuda"):
    """Run ``fn(*args)`` in ``world_size`` rank processes; returns the
    list of their results by rank.

    Args:
        fn: a module-level function (the ranks import it by name), run
            after ``init_process_group``; its result must pickle (its
            tensors are shared with the parent, each rank lives until the
            parent has every result).
        backend: 'gloo' or 'nccl'.
        device: 'cuda' (the default) or 'cpu'; with 'cuda' each rank
            sets its card (rank r: card r mod the card count) before
            joining.

    The whole launch, and each collective, may take ``TIMEOUT_S`` seconds.
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend '{backend}'")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device '{device}'")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl":
        if world_size > cards:
            raise ValueError(
                f"nccl needs one card per rank: {world_size} ranks, "
                f"{cards} cards (use backend='gloo' for ranks that share "
                "a card)")
        if device != "cuda":
            raise ValueError("the nccl backend runs on CUDA cards: pass "
                             "device='cuda'")
    if device == "cuda" and not cards:
        raise RuntimeError("device='cuda' was requested but there is no "
                           "CUDA card; pass device='cpu'")
    context = multiprocessing.get_context("spawn")
    results, received = context.Queue(), context.Event()
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [context.Process(
            target=_rank_main,
            args=(rank, world_size, backend, device, rendezvous, fn,
                  tuple(args), results, received), daemon=True)
            for rank in range(world_size)]
        try:
            for proc in procs:
                proc.start()
            return _collect(procs, results)
        finally:
            received.set()
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                proc.join()


def _collect(procs, results):
    """Every rank's result, in rank order; raises at the first failure,
    a rank that died without a word, or the deadline."""
    got = {}
    deadline = time.monotonic() + TIMEOUT_S
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [i for i, p in enumerate(procs)
                    if i not in got and p.exitcode is not None]
            if dead:
                # its result may still be in flight through the queue
                try:
                    rank, ok, payload = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks {sorted(set(range(len(procs))) - set(got))} "
                    f"gave no result within {TIMEOUT_S} s") from None
            else:
                continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        got[rank] = payload
    return [got[rank] for rank in range(len(procs))]
