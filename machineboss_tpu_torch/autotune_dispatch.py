"""Measure the single-pair engines' crossover points and write the
dispatch table's row for this device.

Counterpart of the JAX package's scripts/autotune_dispatch.py: the same
grid, the same seeded machines and the same engines, timed on the card.
CompiledMachine._strategy routes a 1D single pair to the log-depth
"assoc" product or the sequential "scan" by the row of its device type;
this tool measures that row, so the thresholds come from the device, not
from a guess.

  1D: S in (4, 16, 64, 128) x L in (128, 512, 2048, 8192), a seeded
      random generator each S: dp1d.forward_1d_scan vs
      dp1d.forward_1d_assoc;
  2D: S in (4, 16, 64) x L in (16, 64, 256), testmachines'
      build_random_transducer: dp2d.forward_2d ("rows") vs
      wavefront_fast.forward_2d_wavefront_fast on the pair as a batch of
      one.

Each time is the minimum of 3 calls after one warm call, taken between
two synchronisations of the device around the whole call. The output
keeps the JAX schema, {"backends": {"<device type>": row}}, merged into
an existing file; the row also names the card, its power limit and the
torch and CUDA versions, which readers ignore.

Run on the card (some 10 min; re-run after a change to dp1d, dp2d or
wavefront_fast, and commit the new dispatch_table_cuda.json):

    python -m machineboss_tpu_torch.autotune_dispatch

--device cpu measures the CPU; --out names another file; --grid S_LIST
L_LIST (comma-separated) replaces both grids, e.g. --grid 4 16,32.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ONE_D_GRID = ((4, 16, 64, 128), (128, 512, 2048, 8192))
TWO_D_GRID = ((4, 16, 64), (16, 64, 256))
REPS = 3


def table_path(device_type):
    """dispatch_table_<device type>.json beside dispatch.py."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dispatch_table_%s.json" % device_type)


def _time(fn, device, reps=REPS):
    """Seconds of the fastest of `reps` calls after one warm call, the
    device synchronised before and after each."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    fn()
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def _generator(S, rng):
    """The JAX script's random S-state generator, drawn from `rng`."""
    from .core.machine import Machine
    return Machine.from_json({"state": [
        {"id": "S%d" % s, "trans": [
            {"out": c, "to": int(rng.randint(0, S)),
             "weight": round(float(rng.uniform(0.1, 0.5)), 4)}
            for c in "ACGT"] + [{"to": S, "weight": 0.05}]}
        for s in range(S)] + [{"id": "End", "trans": []}]})


def _lowered(machine):
    from .core.eval import EvaluatedMachine
    from .ops.lowering import LoweredMachine
    ev = EvaluatedMachine(machine, machine.get_param_defs(True))
    return LoweredMachine(ev, dtype=np.float32)


def _on(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            for x in arrays]


def derive(one_d, two_d):
    """The row's thresholds: per S the smallest L at which assoc won
    (keys as strings), and whether the wavefront won most 2D cells."""
    assoc_min_l = {}
    for row in one_d:
        if row["winner"] == "assoc":
            s = str(row["S"])
            assoc_min_l[s] = min(assoc_min_l.get(s, 10**9), row["L"])
    wave_wins = [r["winner"] == "wavefront" for r in two_d]
    return {"assoc_min_L_by_S": assoc_min_l,
            "wavefront_2d": sum(wave_wins) > len(wave_wins) // 2}


def _card(device):
    """The card's name and power limit as nvidia-smi gives them, and the
    versions; None where there is no card."""
    info = {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_name": None, "nvidia_smi": None}
    if device.type != "cuda":
        return info
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    info["device_name"] = torch.cuda.get_device_name(index)
    info["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return info


def measure(device, grid=None):
    """The row for `device`: both grids timed, the thresholds derived.
    `grid` is {"one_d": (S values, L values), "two_d": (...)}, or one
    (S values, L values) pair for both."""
    from .ops import dp1d, dp2d
    from .ops.wavefront_fast import forward_2d_wavefront_fast
    from .testmachines import build_random_transducer
    grid = grid or {"one_d": ONE_D_GRID, "two_d": TWO_D_GRID}
    if not isinstance(grid, dict):
        grid = {"one_d": grid, "two_d": grid}
    rng = np.random.RandomState(0)
    row = {"backend": device.type, "one_d": [], "two_d": [],
           **_card(device)}

    # ---- 1D: assoc (log-depth product of transfer matrices) vs scan
    for S in grid["one_d"][0]:
        lm = _lowered(_generator(S, rng))
        trans, closure = _on(lm.emit_matrices_1d(output_side=True), device)
        for L in grid["one_d"][1]:
            toks = torch.from_numpy(rng.randint(0, 4, L)).to(device)
            t_scan = _time(lambda: dp1d.forward_1d_scan(
                trans, closure, toks, L), device)
            t_assoc = _time(lambda: dp1d.forward_1d_assoc(
                trans, closure, toks, L), device)
            win = "assoc" if t_assoc < t_scan else "scan"
            row["one_d"].append({"S": S, "L": L, "scan_s": t_scan,
                                 "assoc_s": t_assoc, "winner": win})
            print("1D S=%d L=%d scan %.4fs assoc %.4fs -> %s"
                  % (S, L, t_scan, t_assoc, win), flush=True)

    # ---- 2D single pair: row scan vs the torch wavefront
    for S in grid["two_d"][0]:
        lm = _lowered(build_random_transducer(S, list("ACGT")))
        a_diag, a_left, a_up, closure = _on(lm.matrices_2d(), device)
        for L in grid["two_d"][1]:
            it = torch.from_numpy(rng.randint(0, 4, L)).to(device)
            ot = torch.from_numpy(rng.randint(0, 4, L)).to(device)
            lens = torch.full((1,), L, dtype=torch.long, device=device)
            t_rows = _time(lambda: dp2d.forward_2d(
                a_diag, a_left, a_up, closure, it, ot, L, L), device)
            t_wave = _time(lambda: forward_2d_wavefront_fast(
                a_diag, a_left, a_up, closure, it[None], ot[None], lens,
                lens), device)
            win = "wavefront" if t_wave < t_rows else "rows"
            row["two_d"].append({"S": S, "L": L, "rows_s": t_rows,
                                 "wavefront_s": t_wave, "winner": win})
            print("2D S=%d L=%d rows %.4fs wave %.4fs -> %s"
                  % (S, L, t_rows, t_wave, win), flush=True)

    row["derived"] = derive(row["one_d"], row["two_d"])
    return row


def write_row(out, row):
    """Merge `row` into the table at `out` under its backend (a legacy
    single-backend file's row is kept), as the JAX script does."""
    doc = {"backends": {}}
    if os.path.exists(out):
        try:
            with open(out) as f:
                prev = json.load(f)
            if "backends" in prev:
                doc = prev
            elif "backend" in prev:
                doc["backends"][prev["backend"]] = {
                    k: v for k, v in prev.items() if k != "backend"}
        except (OSError, ValueError):
            pass
    doc["backends"][row["backend"]] = row
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return doc


def main(device=None, out=None, grid=None):
    """Measure `device` (None: the card, raising without CUDA) and merge
    its row into `out` (None: dispatch_table_<device type>.json beside
    dispatch.py). Returns the written document."""
    from .utils.device import resolve_device
    dev = resolve_device(device)
    out = table_path(dev.type) if out is None else str(out)
    row = measure(dev, grid)
    doc = write_row(out, row)
    print("wrote %s backend %s" % (out, dev.type), flush=True)
    return doc


def cli(argv=None):
    ap = argparse.ArgumentParser(
        description="Time the single-pair engines and write the dispatch "
                    "table's row for this device.")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None,
                    help="table file (default dispatch_table_<device "
                         "type>.json beside dispatch.py)")
    ap.add_argument("--grid", nargs=2, metavar=("S_LIST", "L_LIST"),
                    help="comma-separated S and L values for both grids")
    args = ap.parse_args(argv)
    main(args.device, args.out,
         [[int(x) for x in v.split(",")] for v in args.grid]
         if args.grid else None)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
