"""The work of one ``rx_deliver`` launch, as the reference's ``account``
defines it: each of the launch's B message planes ``[F, C, C]`` (bool)
read once and its delivery plane written once, the crashed mask
``[F, C]`` and the packed link-blocked plane ``[F, C, ceil(C/8)]`` read
once, and the counter vector ``[F, 14]`` (int32) read and written once.
A tick makes six launches in the order 2b (two planes), 2a, 1b, vote,
1a, batch."""
from __future__ import annotations

#: The H100 SXM's HBM3 bandwidth (NVIDIA data sheet), bytes per second.
PEAK_BYTES_PER_S = 3.35e12
#: Planes of each launch of a tick, in launch order.
PLANES_PER_LAUNCH = (2, 1, 1, 1, 1, 1)
COUNTERS = 14


def launch_bytes(members: int, c: int, planes: int) -> int:
    per_member = (2 * planes * c * c + c + c * (-(-c // 8))
                  + 2 * 4 * COUNTERS)
    return members * per_member


def least_seconds(members: int, c: int, planes: int) -> float:
    return launch_bytes(members, c, planes) / PEAK_BYTES_PER_S
