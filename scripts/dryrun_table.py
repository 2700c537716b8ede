#!/usr/bin/env python3
"""Print the dry-run matrix's records as a markdown table, one row a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python3 scripts/dryrun_table.py [experiments/dryrun_torch]

    python3 scripts/dryrun_table.py DIR --against PARENT_DIR [--reference REF_DIR]

Reads every <arch>__<shape>__<mesh>.json that `repro_torch.launch.dryrun`
wrote (a cell that failed wrote none: its FAIL line is in the run's
output) and prints, a cell a row: the seconds (the fake run, and the cell
with its probes), FLOPs and peak bytes a device (argument + temp +
output), the dominant roofline term at the H100's constants, the
collectives by kind (all-gather / all-reduce / reduce-scatter / all-to-all
/ collective-permute counts), whether the probe's extrapolation equals the
direct count, and the views run replicated; then the sums of seconds,
and the cells' seconds again, an arch a row (a cell without a record
reads FAIL).

With `--against`, it compares DIR's cells with another run's (a parent
commit's records) instead, a cell a row: FLOPs a device (now against
then), peak GB a device and wire GB (probe-corrected where the record has
its probes) then / now, and with `--reference` the same cell of the JAX
package's `python -m repro.launch.dryrun` records beside them, and the
all-to-alls now; then the cells whose FLOPs differ and the largest rises
of peak and wire.
"""
import argparse
import glob
import json
import os
import sys

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def _load(root: str) -> dict:
    """(arch, shape, mesh) -> record, for every record under `root`."""
    records = {}
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        records[(r["arch"], r["shape"], r["mesh"])] = r
    return records


def _peak(r) -> float:
    mem = r["per_device"]
    return mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]


def _wire(r) -> float:
    return (r["probe"] or r["collectives"])["wire_bytes"]


def compare(now: dict, then: dict, ref: dict) -> None:
    """Print DIR's cells against the parent's and the reference's."""
    def cell(r, fn, scale=1e9):
        return "-" if r is None else f"{fn(r) / scale:.4g}"

    print("| arch | shape | mesh | flops/dev now (then) | peak GB then / now / ref "
          "| wire GB then / now / ref | all-to-all now |")
    print("|---|---|---|---|---|---|---|")
    flops_differ, peak_up, wire_up = [], [], []
    for key in sorted(now):
        r, p, x = now[key], then.get(key), ref.get(key)
        flops = r["per_device"]["flops"]
        if p is not None and p["per_device"]["flops"] != flops:
            flops_differ.append((key, flops / p["per_device"]["flops"]))
        if p is not None:
            peak_up.append((_peak(r) / _peak(p) - 1, key))
            wire_up.append((_wire(r) / _wire(p) - 1 if _wire(p) else 0.0, key))
        same = "" if p is None or p["per_device"]["flops"] == flops else (
            f" ({p['per_device']['flops']:.4e})")
        print(f"| {key[0]} | {key[1]} | {key[2]} | {flops:.4e}{same} | "
              f"{cell(p, _peak)} / {cell(r, _peak)} / {cell(x, _peak)} | "
              f"{cell(p, _wire)} / {cell(r, _wire)} / {cell(x, _wire)} | "
              f"{r['collectives']['count_by_type']['all-to-all']} |")
    print(f"\n{len(now)} cells, {sum(k in then for k in now)} with a parent record; FLOPs "
          f"differ in {len(flops_differ)}: "
          + ", ".join(f"{' '.join(k)} x{ratio:.4f}" for k, ratio in flops_differ))
    for name, rises in (("peak", peak_up), ("wire", wire_up)):
        if rises:
            top, key = max(rises)
            print(f"largest {name} rise: {100 * top:+.3f} % at {' '.join(key)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default="experiments/dryrun_torch")
    ap.add_argument("--against", help="a parent run's records: compare with them")
    ap.add_argument("--reference", help="the JAX package's dry-run records")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    root = args.root
    if args.against:
        now = _load(root)
        if not now:
            print(f"no records under {root}", file=sys.stderr)
            return 1
        compare(now, _load(args.against), _load(args.reference) if args.reference else {})
        return 0
    records = list(_load(root).values())
    if not records:
        print(f"no records under {root}", file=sys.stderr)
        return 1
    print("| arch | shape | mesh | run s | cell s | flops/dev | peak GB/dev | dominant "
          "| ag / ar / rs / a2a / cp | probe = direct | replicated views |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    cells = {}  # (arch, shape, mesh) -> the cell's seconds with its probes
    for r in records:
        mem, counts, probe = r["per_device"], r["collectives"]["count_by_type"], r["probe"]
        peak = (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]) / 1e9
        cell_s = cells[(r["arch"], r["shape"], r["mesh"])] = r.get("total_s", r["compile_s"])
        same = "-" if probe is None else ("yes" if probe["flops_matches_direct"] else "NO")
        print(f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compile_s']:.1f} | "
              f"{cell_s:.1f} | {mem['flops']:.3e} | {peak:.2f} | {r['roofline']['dominant']} | "
              f"{' / '.join(str(counts[k]) for k in KINDS)} | {same} | "
              f"{len(r.get('replicated_views', []))} |")
    run_s = sum(r["compile_s"] for r in records)
    print(f"\n{len(records)} cells; fake runs {run_s:.1f} s, cells with probes "
          f"{sum(cells.values()):.1f} s")
    shapes = sorted({k[1] for k in cells})
    print("\n| arch | " + " | ".join(f"{s} s (single / multi)" for s in shapes) + " |")
    print("|---|" + "---|" * len(shapes))
    for arch in sorted({k[0] for k in cells}):
        row = [" / ".join(f"{cells[(arch, s, m)]:.1f}" if (arch, s, m) in cells else "FAIL"
                          for m in ("single", "multi")) for s in shapes]
        print(f"| {arch} | " + " | ".join(row) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
