"""Sequence-parallel convolution: the time axis split over ranks
(counterpart of convopeq_tpu/parallel/time_parallel.py).

A single very long stream (an offline mastering job) can be split along
time: each rank convolves its chunk with the whole NUC, and the
convolution tail that spills past the chunk goes to the successor ranks
in ceil(spill / chunk) rounds, round k sending each rank's k-th spill
chunk to rank + k (the JAX package's `lax.ppermute`; here point-to-point
isend / irecv pairs).  The halo-exchange recipe of mesh-parallel stencils
applied to partitioned convolution.

Exactness: the same linear convolution truncated to N as the unsharded
`nuc_convolve`: every tail contribution lands on the right successor
chunk.  Cost: each rank convolves chunk + spill samples, then sends and
receives up to `rounds` chunk-sized payloads; efficient when chunk >=
the IR's reach (one round), else prefer the stream axis.
(The reference's NUC tail layers' deferred cross-block contributions,
src/MKLNonUniformConvolver.cpp:1497-1545, re-expressed across ranks.)
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.nuc import NUCState, nuc_convolve


def spill_rounds(state: NUCState, chunk: int) -> int:
    """Halo rounds for chunks of `chunk` samples: the operator's forward
    reach over the chunk.  The circular per-partition spectrum filter
    spreads each partition kernel over its full 2P window, so a layer
    reaches offset + (num_parts + 1) * P, beyond the IR's length."""
    spill = max(lp.offset + (lp.num_parts + 1) * lp.part_size
                for lp in state.plan.layers)
    return -(-spill // chunk)


def time_parallel_nuc_convolve(x, state: NUCState, group=None):
    """Convolve x (..., N) with a prepared NUCState, N split over the
    ranks of `group` (N divisible by their number).  Every rank passes
    the whole x and gets the whole (..., N) output, equal to
    `nuc_convolve(x, state)`; it convolves only its own chunk."""
    n = x.shape[-1]
    d = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n % d:
        raise ValueError(f"time axis ({n}) must divide the ranks ({d})")
    chunk = n // d
    rounds = spill_rounds(state, chunk)
    xl = x[..., rank * chunk:(rank + 1) * chunk]
    # the local chunk convolved with the whole NUC; the output past the
    # chunk is this rank's contribution to its successors
    yf = nuc_convolve(F.pad(xl, (0, rounds * chunk)), state)
    y = yf[..., :chunk]
    for k in range(1, rounds + 1):
        reqs = []
        if rank + k < d:
            reqs.append(dist.isend(
                yf[..., k * chunk:(k + 1) * chunk].contiguous(),
                dst=dist.get_global_rank(group, rank + k)
                if group is not None else rank + k, group=group))
        if rank - k >= 0:
            recv = torch.empty_like(y)
            reqs.append(dist.irecv(
                recv, src=dist.get_global_rank(group, rank - k)
                if group is not None else rank - k, group=group))
        for r in reqs:
            r.wait()
        if rank - k >= 0:
            y = y + recv
    parts = [torch.empty_like(y) for _ in range(d)]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim=-1)
