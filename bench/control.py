"""Readings of the check's numbers, for setting their limits: the program's
and the control's, over many seeds, in one process.

    python3 bench/control.py --workload <cell> --seeds 11,12,13 [--device cuda]

For each seed the mix's grids are made as a run makes them; of each request,
``grids_per_request`` grids (over the unit sets in turn) are answered by

* the program, through ``sweep`` as the window calls it, and
* the control: the plain reference computed in bfloat16, the precision below
  the float32 the configuration states,

and as many answers as a run's check samples, drawn from the seed as it draws them, are
compared with the float32 reference.  Prints one JSON line a seed:
``{"seed", "program": [trials, values], "control": [trials, values],
"answers"}``.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def readings(cell: str, seed: int, *, device: str = "cuda", n_laser=None, n_ring=None,
             control_dtype=None) -> dict:
    import numpy as np
    import torch

    import generator
    import harness
    from reference import model as ref
    from repro_torch.core.sampling import UnitSamples
    from repro_torch.core.sweep import sweep

    control_dtype = control_dtype or torch.bfloat16
    c = harness.resolve_cell(ROOT, cell)
    traffic = generator.build(c.traffic, c.config, seed, n_laser=n_laser, n_ring=n_ring)
    cfg = harness.program_config(c.config)
    dep = ref.Deployment.from_config(c.config)
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    m = int(traffic.check["points_per_grid"])
    prog = [0, 0]
    ctrl = [0, 0]
    answers = 0
    for req in traffic.requests:
        for j in range(int(traffic.check["grids_per_request"])):
            u = j % len(traffic.unit_sets)
            us = traffic.unit_sets[u]
            units = UnitSamples(*(torch.from_numpy(a).to(device) for a in us))
            host = harness.to_host(sweep(harness.sweep_request(cfg, units, req)).data)
            picks = harness.pick(rng, req, host, m)
            want = harness.expected(dep, c.config, req, us, picks, dtype=torch.float32,
                                    device=device)
            got = harness.expected(dep, c.config, req, us, picks, dtype=control_dtype,
                                   device=device)
            for acc, answer in ((prog, harness.program_answers(req, host, picks)), (ctrl, got)):
                t, v = harness.mismatches(want, answer)
                acc[0] += t
                acc[1] += v
            answers += len(picks)
    return {"cell": cell, "seed": seed, "program": prog, "control": ctrl, "answers": answers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="check readings of the program and the control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, device=args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
