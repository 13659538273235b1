"""The frozen yardstick: the card's data-sheet peaks, the model FLOPs of
a round (6 · active parameters · tokens, no recompute) and the bytes a
kernel call must move (each input read once, each output written once).
Copied from ``repro_torch.roofline.analysis`` / ``configs.base`` and the
kernel table's bounds, so that a later change to the port cannot move
what is measured.  A family this file does not count is counted by its
configuration's reference module (``active_params``), which lies with
the benchmark too."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# the statistics row fairk_update writes: two counts and two histograms
STATS_FLOATS = 2 + 128 + 128


def param_count(m: Dict[str, Any]) -> int:
    """Parameters of a dense, VLM or Mamba-2 decoder, norms excluded."""
    d, v = m["d_model"], m["vocab"]
    total = v * d * (1 if m.get("tie_embeddings") else 2)
    if m["family"] in ("dense", "vlm"):
        hd = m.get("head_dim") or d // m["n_heads"]
        qkv = d * (m["n_heads"] + 2 * m["n_kv_heads"]) * hd
        if m.get("qkv_bias"):
            qkv += (m["n_heads"] + 2 * m["n_kv_heads"]) * hd
        layer = qkv + m["n_heads"] * hd * d + 3 * d * m["d_ff"]
    elif m["family"] == "ssm":
        d_in = m["ssm_expand"] * d
        gn = m["ssm_groups"] * m["ssm_state"]
        h = d_in // m["ssm_head_dim"]
        layer = (d * (2 * d_in + 2 * gn + h) + m["ssm_conv"] * (d_in + 2 * gn)
                 + d_in * d + 3 * h + d_in)
    else:
        raise ValueError(f"no parameter count for family {m['family']!r}")
    return total + m["n_layers"] * layer


# the families ``param_count`` counts
COUNTED = ("dense", "vlm", "ssm")


def model_flops(m: Dict[str, Any], tokens: int,
                active_params: Optional[Callable[[Dict[str, Any]], int]]
                = None) -> Optional[float]:
    """6 · N · tokens: a training round's useful FLOPs.  N is
    ``active_params(m)`` where the configuration's reference module
    defines it (the parameters one token uses, norms excluded, experts
    counted at ``experts_per_token``), else ``param_count(m)`` for the
    families it counts; None for any other family."""
    if active_params is not None:
        n = active_params(m)
    elif m["family"] in COUNTED:
        n = param_count(m)
    else:
        return None
    return 6.0 * n * tokens


def fairk_update_bytes(d: int, residual: bool, fresh: bool) -> int:
    """One fused FAIR-k pass over ``d`` float32 coordinates: reads g,
    g_prev, age (and the residual, the fresh values), writes g_t, age'
    (and the residual) and the statistics row; the two thresholds."""
    reads = 3 + residual + fresh
    writes = 2 + residual
    return 4 * d * (reads + writes) + 4 * STATS_FLOATS + 8


def sign_mv_bytes(rows: int, d: int, noise: bool) -> int:
    """The (rows, d) float32 vote and the noise read, signs and energy
    written."""
    return 4 * d * (rows + noise) + 8 * d


def roofline_pct(n_bytes: float, seconds_per_call: float) -> float:
    """The least time the bytes take at the memory rate over the time a
    call took, in percent."""
    return 100.0 * (n_bytes / HBM_BYTES_PER_S) / seconds_per_call
