"""Readings that set a cell's limits: for each seed, one run of the cell
at its own size (one unit, not timed), and the check's numbers of the
program and of what is put in its place: ``control``, the reference one
precision lower than the recipe states, and, for a train cell, ``half``,
the reference trained on half of each batch. The benchmark's own runs do
not run this. Usage::

    python3 -m bench_port.control --workload <cell> --seeds 11,12,13 [--out readings.jsonl]
        [--fault unchanged_state|half_batch|no_exchange|perturbed_answer|refiner_short|no_blur]

``--fault`` plants that fault in the program first and reads the program
alone. Each seed's readings
are a JSON line on standard output (and in ``--out``)."""
from __future__ import annotations

import argparse
import json
import os
import sys

from bench_port import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    cell = run.find_cell(args.workload)
    variants = ("program", "control") + (("half",) if cell["mix"]["entry"] == "train" else ())
    if args.fault:  # a planted fault is read on the program alone
        variants = ("program",)
    out = open(os.path.abspath(args.out), "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell["chips"] > 1:
            res = run.run_ranks(args.workload, seed, 0.0, False, cell["chips"],
                                variants=variants, fault=args.fault)
        else:
            res = run.run_cell(args.workload, seed, 0.0, False, variants=variants,
                               fault=args.fault)
        line = json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                           "readings": res["readings"], "details": res["details"],
                           "metrics": res["result"]["metrics"],
                           "memory_peak_bytes": res["result"]["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
