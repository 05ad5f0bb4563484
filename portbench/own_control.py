"""The control a reference declares for its own engine, run through a
cell's whole harness.

    python3 portbench/own_control.py --workload <cell> --seeds 1 2 3 \
        [--seconds s]

``control.py``'s control breaks the timing guarantees every engine
shares (the failure detector's threshold, the classic round's length).
A deployment whose traffic runs neither needs a control of its own: its
reference module (``reference/<engine>.py``) then gives
``control(config)``, the configuration with one of that deployment's
guarantees broken. Here the reference, under that configuration and with
``control.py``'s breaks as well, takes the program's place; each run
must come out ``correct: false``. The script prints one JSON line per
seed (``fault`` is ``declared``) and exits 1 if any comes out correct,
2 if the cell's reference declares no control.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import control, run  # noqa: E402


class DeclaredControl(control.ControlFleet):
    """``control.ControlFleet`` with the reference's own break too."""

    def __init__(self, config, descs, ticks, device):
        super().__init__(config, descs, ticks, device)
        self.config = self.model.control(self.config)


def declares(config: dict) -> bool:
    return hasattr(run.reference_of(config), "control")


@contextlib.contextmanager
def declared():
    """Within the block, ``control.py``'s control is the declared one."""
    plain = control.ControlFleet
    control.ControlFleet = DeclaredControl
    try:
        yield
    finally:
        control.ControlFleet = plain


def check(cell: str, seed: int, seconds: float, dev, workload=None,
          config=None, traffic=None) -> dict:
    """One run of ``cell`` with the declared control: its checks."""
    with declared():
        res = control.check(cell, seed, "control", seconds, dev, workload,
                            config, traffic)
    return dict(res, fault="declared")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    workload, config, traffic = run.load_cell(args.workload)
    if not declares(config):
        print(f"own_control: the {config['engine']} reference declares no "
              "control", file=sys.stderr)
        return 2
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    caught = True
    for seed in args.seeds:
        res = check(args.workload, seed, args.seconds, dev, workload, config,
                    traffic)
        caught &= not res["correct"]
        print(json.dumps(res), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
