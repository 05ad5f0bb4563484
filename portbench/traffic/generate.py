"""The one generator of the benchmark's fault traffic.

A traffic mix is a data file ``traffic/<name>.json``. Each of its keys
but ``name`` and ``note`` names a kind of fault, the module
``traffic/kinds/<kind>.py``, and holds that kind's parameters; each
member of a fleet draws every kind the file names, in the file's key
order, from the run's seed and the member's index, so that every seed
gives the same amount of work.

A member is a plain description, the same one the program under test and
the reference are handed: ``{"seed", "crashes": [[slot, tick], ...],
"windows": [{"src", "dst", "start", "end", "period", "two_way"}],
"proposes": {"tick", "victims", "camp", "delay"}}`` (``camp`` and
``delay`` one entry a node), with whatever entries further kinds set.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
#: The keys of a traffic mix that name no kind.
NOTES = ("name", "note")


def kind(name: str):
    """The module of the kind of fault ``name``; ``ValueError`` where
    there is none."""
    module = f"portbench.traffic.kinds.{name}"
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", name):
        raise ValueError(f"no kind of fault {name!r}")
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as err:
        if err.name != module:
            raise
        raise ValueError(f"no kind of fault {name!r} ({module})") from None


def load(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    traffic = json.loads(path.read_text())
    unknown = []
    for key in traffic:
        if key not in NOTES:
            try:
                kind(key)
            except ValueError:
                unknown.append(key)
    if unknown:
        raise ValueError(f"traffic {name!r}: unknown keys {sorted(unknown)}")
    return traffic


def member(traffic: dict, n: int, seed: int, index: int) -> dict:
    """The description of member ``index`` of a fleet under ``seed``."""
    rng = np.random.default_rng([seed % 2**64, index])
    desc = {"seed": int(rng.integers(0, 2**31 - 1)), "crashes": [],
            "windows": [], "proposes": None}
    for key, spec in traffic.items():
        if key in NOTES:
            continue
        for entry, value in kind(key).draw(spec, n, rng).items():
            if isinstance(desc.get(entry), list):
                value = desc[entry] + value
            desc[entry] = value
    return desc


def fleet(traffic: dict, n: int, members: int, seed: int) -> list:
    """Every member's description; the same seed gives the same list."""
    return [member(traffic, n, seed, i) for i in range(members)]
