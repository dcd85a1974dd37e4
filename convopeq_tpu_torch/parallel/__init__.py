"""Multi-device parallelism over torch.distributed (counterpart of
convopeq_tpu/parallel/): the stream axis split over ranks (sharding.py),
the time axis split over ranks with tail halos passed to successors
(time_parallel.py), and a dry run of both over CPU gloo processes
(dryrun.py)."""
