#!/usr/bin/env python3
"""The control of a cell's ``correct``: the plain reference put in the
program's place, computed one precision below the configuration's (TF32
products for float32 with TF32 off), judged by the same comparison and
limits as a benchmark run.  It has to come out not correct.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...]

One JSON line a seed: each number, its limit, and whether the control
passed it; exits 0 when the control failed a number on every seed.  It
runs at the cell's own size on one card: the whole spectrum once, then
each rank's blocks of it and of its inverse in turn, a number being the
largest over the ranks, as in a run.  The benchmark's own runs never
run this.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_answers(reference, config: dict, traffic, seed: int, device):
    """The answers the reference gives in TF32, in the program's place:
    ``answers(rank)`` for each rank of the cell."""
    from perfbench.harness import check, fields
    import torch
    shape = tuple(config["grid"])
    dtype = traffic.input_dtype(getattr(torch, config["dtype"]))
    arith = reference.Arith("tf32", device)

    def source(x0, x1):
        return fields.planes(seed, shape, dtype, x0, x1, device)
    if traffic.step == ("poisson_solve",):
        u = reference.poisson(source, shape, arith, traffic.box)
        return lambda rank: {"solution": u}
    # the whole spectrum, then each rank's blocks of it and of its inverse
    y = reference.spectrum(source, shape, tuple(slice(0, n) for n in shape),
                           arith)

    def answers(rank):
        where = check.blocks(reference, config, traffic, rank)
        x2 = reference.transform(lambda a, b: y[a:b], shape, where["input"],
                                 +1, arith)
        return {"spectrum": y[where["output"]], "field": x2}
    return answers


def run(bench, workload: str, seeds, device) -> list:
    from perfbench.harness import check
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    reference = bench.reference(config["reference"])
    limits = bench.limits(workload)
    ranks = math.prod(config["mesh"]["shape"]) if config.get("mesh") else 1
    out = []
    for seed in seeds:
        t = time.perf_counter()
        answers, worst = control_answers(reference, config, traffic, seed,
                                         device), {}
        for rank in range(ranks):
            got = check.numbers(reference, config, traffic, seed, rank,
                                answers(rank), None, device)
            for k, v in got.items():
                worst[k] = max(v, worst.get(k, 0.0))
        del answers
        row = {"workload": workload, "seed": seed,
               "checks": {k: {"value": v, "limit": limits[k],
                              "passed": v <= limits[k]}
                          for k, v in worst.items()},
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from perfbench.harness.spec import Bench
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rows = run(Bench(ROOT), args.workload, args.seeds, device)
    # the control has to fail one of the cell's numbers on every seed
    return 0 if all(any(not c["passed"] for c in r["checks"].values())
                    for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
