"""The collectives' yardstick: the least bytes a collective moves into one
rank, and the link's peak, frozen here.

Peak: NVLink 4 on an H100 SXM, 18 links of 25 GB/s a direction, 450 GB/s
into a card (NVIDIA H100 data sheet: 900 GB/s both directions).  The
least bytes a rank of W receives: (W - 1) / W of an all-gather's output
(every other rank's rows), and (W - 1) / W of an all-reduce's buffer (the
other ranks' share of it, as a reduce-scatter alone would take it).  The
second is a floor below what any algorithm takes (a ring receives 2 (W -
1) / W, NVLS's switch reduction about the whole buffer), so no algorithm
reads above the peak.
"""

from __future__ import annotations

LINK_BYTES_PER_S = 450e9


def least_seconds(world: int, all_reduce_bytes: float,
                  all_gather_bytes: float) -> float:
    """The least time at the link's peak of what a rank of `world`
    receives over all-reduces of `all_reduce_bytes` buffers and
    all-gathers of `all_gather_bytes` outputs."""
    return ((world - 1) / world * (all_reduce_bytes + all_gather_bytes)
            / LINK_BYTES_PER_S)
