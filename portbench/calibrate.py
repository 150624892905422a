"""Readings that the cells' limits are set from, on the card at the cells'
sizes (the benchmark's own runs never run this):

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 [--seconds S] [--what program,control,faults]

For each seed, one JSON line per reading: ``program`` (the sound program
after a window of ``--seconds``), ``control`` (the plain reference at TF32 in
the program's place) and each fault of the cell's driver (its ``FAULTS``)
planted in the port (after a window of ``--seconds``). Each line holds the compared numbers
(``gaps``) and the cell's current limits.
"""

import argparse
import json
import sys

from . import manifest as mf
from .trace import Tracer


def readings(name: str, seed: int, seconds: float, what):
    """Yield {"seed", "reading", "gaps"} for one seed, on the card."""
    cfg, traffic, spec = mf.cell_files(mf.load_manifest(), name)
    drv = mf.driver(spec["driver"])

    def sound_session():
        return drv.Session(cfg, traffic, spec, seed, "cuda", Tracer())

    if "program" in what or "control" in what:
        s = sound_session()
        if "program" in what:
            s.window(seconds)
            s.release()
            gaps, failed = s.check(spec["limits"])
            yield {"seed": seed, "reading": "program", "gaps": gaps, "failed": failed}
        if "control" in what:
            yield {"seed": seed, "reading": "control", "gaps": s.control()}
        del s
    if "faults" in what:
        for f, plant in drv.FAULTS.items():
            with plant():
                s = sound_session()
                s.window(seconds)
                s.release()
                gaps, failed = s.check(spec["limits"])
            yield {"seed": seed, "reading": f, "gaps": gaps, "failed": failed}
            del s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--what", default="program,control,faults")
    args = ap.parse_args(argv)
    import torch

    from . import card

    card.require(1)
    torch.set_num_threads(1)
    spec = mf.cell_spec(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for r in readings(args.workload, seed, args.seconds, args.what.split(",")):
            r["limits"] = spec["limits"]
            print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
