"""The dry-run and roofline tables from the port's dry-run artifacts
(``repro.roofline.report``'s tables; "compile s" becomes "trace s",
since nothing compiles).

  PYTHONPATH=src python -m repro_torch.roofline.report [--dir benchmarks/artifacts/torch_dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "benchmarks", "artifacts", "torch_dryrun")


def load(art_dir: str):
    arts = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            arts.append(json.load(f))
    return arts


def fmt_bytes(b: float) -> str:
    return f"{b/2**30:.1f}"


def dryrun_table(arts) -> str:
    """Trace time, memory and the collective schedule, both meshes."""
    rows = ["| arch | shape | mesh | trace s | HBM GiB/dev | colls "
            "(AG/AR/RS/A2A/CP per step) | coll GiB/dev |",
            "|---|---|---|---|---|---|---|"]
    for a in arts:
        if a.get("fl_mode"):
            continue
        p = a["parsed"]
        cc = p.get("collective_counts", {})
        counts = "/".join(str(int(cc.get(k, 0))) for k in
                          ("all-gather", "all-reduce", "reduce-scatter",
                           "all-to-all", "collective-permute"))
        rows.append(
            f"| {a['arch']} | {a['shape']} | {a['mesh']} "
            f"| {a['trace_s']:.1f} "
            f"| {fmt_bytes(a['memory']['per_device_total'])} "
            f"| {counts} "
            f"| {p['collective_bytes_per_device']/2**30:.2f} |")
    return "\n".join(rows)


def roofline_table(arts, mesh: str = "16x16") -> str:
    """The three terms, the dominant one and usefulness, one pod."""
    rows = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | MODEL_GFLOPs | useful | next lever |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in arts:
        if a.get("fl_mode") or a["mesh"] != mesh:
            continue
        r = a["roofline"]
        rows.append(
            f"| {a['arch']} | {a['shape']} "
            f"| {r['compute_s']:.4f} | {r['memory_s']:.4f} "
            f"| {r['collective_s']:.4f} | **{r['dominant']}** "
            f"| {r['model_flops']/1e9:.0f} "
            f"| {min(r['usefulness'], 99.0):.2f} "
            f"| {a['suggestion'].split(':')[0]} |")
    return "\n".join(rows)


def fl_table(arts) -> str:
    rows = ["| mode | collective GiB/dev | collective s | memory s |",
            "|---|---|---|---|"]
    for a in arts:
        if not a.get("fl_mode"):
            continue
        r, p = a["roofline"], a["parsed"]
        name = ("baseline (full all-reduce)" if a.get("fl_baseline")
                else "FAIR-k (rho=0.1 blocks)")
        rows.append(f"| {name} | {p['collective_bytes_per_device']/2**30:.3f} "
                    f"| {r['collective_s']:.4f} | {r['memory_s']:.4f} |")
    return "\n".join(rows)


def sort_key(a):
    return (a["arch"], SHAPE_ORDER.index(a["shape"])
            if a["shape"] in SHAPE_ORDER else 9, a["mesh"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.abspath(ART_DIR))
    args = ap.parse_args(argv)
    arts = sorted(load(args.dir), key=sort_key)
    print("# The port's dry run and roofline (H100 SXM data-sheet "
          "estimates per rank and step; `python -m "
          "repro_torch.roofline.report`)\n")
    print("## Dry-run\n")
    print(dryrun_table(arts))
    print("\n## Roofline (single pod, 16x16 = 256 H100s)\n")
    print(roofline_table(arts))
    print("\n## FL-OAC (paper technique at scale, 256 clients)\n")
    print(fl_table(arts))


if __name__ == "__main__":
    main()
