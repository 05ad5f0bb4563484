"""Plain references of the program's engines, one module for each
``engine`` a configuration names, found by that name
(``run.reference_of``). A module ``reference/<engine>.py`` gives
``universe(config, device)`` (what every member of a fleet shares),
``simulate(config, desc, ticks, universe)`` (one member's outputs, in the
form its engine module's ``outputs`` gives) and ``member_summary(out)``
(the summary of those outputs), and imports nothing of the program. A
description that needs what a reference does not model is refused with
``OutOfScope``, never answered wrongly.
"""
from __future__ import annotations


class OutOfScope(RuntimeError):
    """The run needs what the reference does not model."""


def refuse_unmodelled(desc: dict, modelled, who: str) -> None:
    """``OutOfScope`` for any key of ``desc`` outside ``modelled`` whose
    value is not empty (``None`` or an empty list, tuple or dict)."""
    for key, value in desc.items():
        empty = value is None or (isinstance(value, (list, tuple, dict))
                                  and not value)
        if key not in modelled and not empty:
            raise OutOfScope(f"the {who} reference does not model {key}")
