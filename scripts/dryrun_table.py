#!/usr/bin/env python3
"""Print the dry-run matrix's records as a markdown table, one row a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python3 scripts/dryrun_table.py [experiments/dryrun_torch]

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
"""
import glob
import json
import os
import sys

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0] if argv else "experiments/dryrun_torch"
    records = []
    for path in sorted(glob.glob(os.path.join(root, "*.json"))):
        with open(path) as f:
            records.append(json.load(f))
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
