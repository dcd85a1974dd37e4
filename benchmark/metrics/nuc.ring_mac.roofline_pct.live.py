"""Share of its roofline that the NUC layers' ring MAC reaches: the
least time of the bytes and operations its spans count, over their
stream time (nuc.ring_mac_ms.live).

Each "nuc.L<p>.mac" span counts the partitions it sums and their bins.
The counts must follow the plan's schedule, block by block: the
immediate layer (the block's partition) sums its whole ring every
block; a tail layer of P partitions firing every `ratio` blocks sums
min(ppc, P - j0) partitions on slot s = step mod ratio, with
ppc = ceil((P - 1) / ratio) and j0 = 1 + s ppc, into its partial sum,
and on its fire adds the newest frame's one partition.  Bytes: each
channel's FDL partitions, the two channels' spectra and the output
once, and a tail layer's partial sum read once; 8 operations a complex
multiply-add and 2 an add into the partial sum."""
from benchmark import roofline as rl
from benchmark import spans


def schedule(step: int, layers):
    """[(span name, partitions, bins, adds into a partial sum)] of one
    block of the plan `layers` [(p, P, ratio)], in the step's order."""
    out = []
    for p, P, ratio in layers:
        name = f"nuc.L{p}.mac"
        if ratio == 1:
            out.append((name, P, p + 1, 0))
            continue
        slot = step % ratio
        ppc = -(-(P - 1) // ratio) if P > 1 else 0
        j0 = 1 + slot * ppc
        j1 = min(j0 + ppc, P)
        if j0 < j1:
            out.append((name, j1 - j0, p + 1, 1))
        if slot == ratio - 1:
            out.append((name, 1, p + 1, 1))
    return out


def read(ctx):
    got = spans.units(ctx)
    if got is None:
        return None
    pairs, _ = got
    C, item = ctx["live"]["C"], ctx["item"]
    want = []
    for r, _, _ in pairs:
        if r.name == "step":
            if 2 * r.counts["streams"] != C:
                return None
            want += schedule(r.counts["step"], ctx["live"]["layers"])
    macs = [r for r, _, _ in pairs if spans.is_mac(r.name)]
    if [(r.name, r.counts.get("partitions"), r.counts.get("bins"))
            for r in macs] != [w[:3] for w in want]:
        return None
    least = sum(rl.least_s((C * (P + 1 + acc) + 2 * P) * bins * 2 * item,
                           C * bins * (8 * P + 2 * acc), item)
                for _, P, bins, acc in want)
    ms = sum(r.stream_ms for r in macs)
    return None if ms <= 0.0 else 100.0 * least / (ms / 1e3)
