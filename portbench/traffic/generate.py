"""The one generator of the benchmark's fault traffic.

A traffic mix is a data file ``traffic/<name>.json``; its keys name the
faults every member of a fleet gets, each drawn from the run's seed and
the member's index, so that every seed gives the same amount of work:

- ``crash``: ``{"share": s, "tick": t}``: ``round(s * n)`` distinct
  nodes fail-stop at tick ``t``;
- ``ingress_partition``: ``{"share": s, "start": t, "period": p}``:
  ``round(s * n)`` distinct nodes receive nothing from any other node
  from tick ``t`` on, in the off-phases of a flip-flop of period ``p``
  ticks (``0``: for good); what they send still arrives;
- ``contested``: ``{"camps": [lo, hi], "tick": [lo, hi], "delay": [lo,
  hi], "coordinator_delay": d}``: at one tick every node proposes
  removing the victim of its camp (``lo..hi`` camps, each node's camp and
  each camp's victim drawn), with a fallback timer of its own delay; one
  drawn node's timer fires first, ``d`` ticks after the proposes, and
  every other's at least five ticks later, so one classic round decides.

A member is a plain description, the same one the program under test and
the reference are handed: ``{"seed", "crashes": [[slot, tick], ...],
"windows": [{"src", "dst", "start", "end", "period", "two_way"}],
"proposes": {"tick", "victims", "camp", "delay"}}`` (``camp`` and
``delay`` one entry a node).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
NEVER = 2**31 - 1
KINDS = ("crash", "ingress_partition", "contested")


def load(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    traffic = json.loads(path.read_text())
    unknown = set(traffic) - set(KINDS) - {"name", "note"}
    if unknown:
        raise ValueError(f"traffic {name!r}: unknown keys {sorted(unknown)}")
    return traffic


def _count(share: float, n: int) -> int:
    count = int(round(share * n))
    if not 1 <= count < n:
        raise ValueError(f"share {share} of {n} nodes gives {count}")
    return count


def member(traffic: dict, n: int, seed: int, index: int) -> dict:
    """The description of member ``index`` of a fleet under ``seed``."""
    rng = np.random.default_rng([seed % 2**64, index])
    desc = {"seed": int(rng.integers(0, 2**31 - 1)), "crashes": [],
            "windows": [], "proposes": None}
    if "crash" in traffic:
        spec = traffic["crash"]
        slots = np.sort(rng.choice(n, _count(spec["share"], n),
                                   replace=False))
        desc["crashes"] = [[int(s), int(spec["tick"])] for s in slots]
    if "ingress_partition" in traffic:
        spec = traffic["ingress_partition"]
        cut = np.sort(rng.choice(n, _count(spec["share"], n), replace=False))
        rest = np.setdiff1d(np.arange(n), cut)
        desc["windows"].append({
            "src": rest.tolist(), "dst": cut.tolist(),
            "start": int(spec["start"]), "end": NEVER,
            "period": int(spec.get("period", 0)), "two_way": False})
    if "contested" in traffic:
        spec = traffic["contested"]
        camps = int(rng.integers(spec["camps"][0], spec["camps"][1] + 1))
        delay = rng.integers(spec["delay"][0], spec["delay"][1] + 1, size=n)
        delay[int(rng.integers(0, n))] = spec["coordinator_delay"]
        if spec["delay"][0] < spec["coordinator_delay"] + 5:
            raise ValueError("contested: every other timer must fire at "
                             "least five ticks after the coordinator's")
        desc["proposes"] = {
            "tick": int(rng.integers(spec["tick"][0], spec["tick"][1] + 1)),
            "victims": np.sort(rng.choice(n, camps, replace=False)).tolist(),
            "camp": rng.integers(0, camps, size=n), "delay": delay}
    return desc


def fleet(traffic: dict, n: int, members: int, seed: int) -> list:
    """Every member's description; the same seed gives the same list."""
    return [member(traffic, n, seed, i) for i in range(members)]
