"""Roofline table — reads the dry-run artifacts written by
``repro_torch.launch.dryrun`` and summarizes the three-term H100 roofline
per (arch x shape x mesh) (``benchmarks/roofline_table.py`` for the port).
Run the dry-run sweep first (fake tensors: on the CPU with ``--device
cpu``, or on the card):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --device cpu
  PYTHONPATH=src python -m benchmarks.torch_run --only roofline
"""

import glob
import json
import os

ART = os.path.join(os.path.dirname(__file__), "artifacts", "torch_dryrun")


def load_artifacts(art_dir: str = ART):
    out = {}
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            out[os.path.basename(path)[:-5]] = json.load(f)
    return out


def run(fast: bool = True, device=None, art_dir: str = ART):
    """Rows ``(roofline/<tag>, trace µs, terms)`` and the roofline per tag;
    ``fast`` and ``device`` are the registry's arguments (the table reads
    artifacts and runs nothing)."""
    arts = load_artifacts(art_dir)
    rows, detail = [], {}
    for tag, art in arts.items():
        r = art.get("roofline", {})
        if not r:
            continue
        dom = r["dominant"]
        rows.append((
            f"roofline/{tag}",
            art.get("trace_s", 0.0) * 1e6,
            f"dom={dom};step_ms={r['step_time_s']*1e3:.2f};"
            f"comp_ms={r['compute_s']*1e3:.2f};mem_ms={r['memory_s']*1e3:.2f};"
            f"coll_ms={r['collective_s']*1e3:.2f};"
            f"useful={r['usefulness']:.2f};"
            f"hbm_gb={art['memory']['per_device_total']/2**30:.1f}",
        ))
        detail[tag] = r
    if not rows:
        rows.append(("roofline/no_artifacts", 0.0,
                     "run repro_torch.launch.dryrun first"))
    return rows, detail
