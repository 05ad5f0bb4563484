"""The kinds of fault a traffic mix names, one module for each, found by
the key of the mix (``traffic.generate``). A module
``traffic/kinds/<kind>.py`` has one function, ``draw(spec, n, rng)``:
from the mix's value ``spec``, the ``n`` nodes and the member's
generator ``rng``, the entries of the member's description that the
kind sets (a list entry adds to the list the description has).
"""
from __future__ import annotations


def count(share: float, n: int) -> int:
    """The number of nodes a share of ``n`` gives: at least one, and not
    every node."""
    got = int(round(share * n))
    if not 1 <= got < n:
        raise ValueError(f"share {share} of {n} nodes gives {got}")
    return got
