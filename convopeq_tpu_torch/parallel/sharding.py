"""Stream parallelism over torch.distributed (counterpart of
convopeq_tpu/parallel/sharding.py).

The reference scales by multithreading inside one process; the signal
chain has no cross-stream dependency, so the scaling axis is the stream
batch split over ranks.  Each rank runs its contiguous slice of the
stream axis with the prepared state (IR spectra, EQ coefficients)
replicated, the analog of the RCU-published RuntimeState: there is no
collective on the data path, only one gather of the outputs at the end.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def stream_slice(n_streams: int, world: int, rank: int) -> slice:
    """The contiguous streams of `rank`: chunks of ceil(n / world), the
    last ones shorter or empty."""
    chunk = -(-n_streams // world)
    return slice(min(rank * chunk, n_streams),
                 min((rank + 1) * chunk, n_streams))


def shard_streams(x, group=None):
    """This rank's slice of x (S, ...) along the stream axis."""
    return x[stream_slice(x.shape[0], dist.get_world_size(group),
                          dist.get_rank(group))]


def gather_streams(y_local, n_streams: int, group=None):
    """The (S, ...) outputs of every rank's slice, on every rank: one
    all_gather of equal-sized chunks (padded with zeros, cut after)."""
    world = dist.get_world_size(group)
    chunk = -(-n_streams // world)
    pad = torch.zeros((chunk,) + tuple(y_local.shape[1:]),
                      dtype=y_local.dtype, device=y_local.device)
    pad[:y_local.shape[0]] = y_local
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat(parts)[:n_streams]


def sharded_chain(fn, group=None):
    """fn(x, state) run stream-parallel: each rank applies fn to its slice
    of x (S, ...) with the replicated `state`, and every rank returns the
    gathered (S, ...) output."""
    def run(x, state):
        return gather_streams(fn(shard_streams(x, group), state),
                              x.shape[0], group)
    return run
