"""A test-only kind of fault, ``crash_block``: ``{"share": s, "tick":
t}``: ``round(s * n)`` consecutive slots from a drawn one on (wrapping
round) fail-stop at tick ``t``. The description keeps the block as drawn,
under a key of its own, which only the test-only engine and reference
model."""
from portbench.traffic.kinds import count


def draw(spec: dict, n: int, rng) -> dict:
    return {"crash_block": {"start": int(rng.integers(0, n)),
                            "count": count(spec["share"], n),
                            "tick": int(spec["tick"])}}
