"""Packed server state: constants, the statistics-histogram spec and the
warm-start threshold state (the subset of ``repro.core.packing`` that the
FL round on the packed backend needs).

The FL trainer lays its flat ``(d,)`` server vector out as a single-leaf
packed layout with ``lane=1`` (``d_valid == d_packed == d``, no pads).
The multi-leaf lane-aligned layout with interior pads belongs to the
launch path and is not ported yet (ROADMAP Queue 1).  The threshold
estimators take the adaptive controller's traced split as a 0-d tensor.

Padding protocol (kept by the kernels): pad coordinates carry
``age = PAD_AGE`` (-1); real ages are >= 0, so ``age < 0`` marks a pad
everywhere downstream — never selected, age passed through, weight zero
in the histograms.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Tensor = torch.Tensor

PAD_AGE = -1.0
# staleness clip applied by every age update (int8 server state headroom)
AGE_CAP = 120.0
LANE = 256

# count of full read passes over the gradient buffer a run makes (the
# fused kernel is the only one on the packed round)
G_READS = 0

# --- in-kernel selection statistics: histogram spec --------------------
# magnitude histogram: |score| on quarter-octave log2 bins, 2^-24 .. 2^8;
# age histogram: the post-update age on unit bins (ages <= AGE_CAP < 128).
# Both sample every ``hist_stride(d)``-th coordinate (global positions).
STATS_MAG_BINS = 128
STATS_AGE_BINS = 128
MAG_BINS_PER_OCT = 4.0
MAG_LO_OCT = -24.0
STATS_SAMPLE_CAP = 1 << 15


class PackedLayout:
    """Static packed layout over leaves of the given sizes: each leaf
    starts at a multiple of ``lane`` and pads to it, so ``d_packed`` counts
    the buffer and ``d_valid`` the real coordinates the budgets draw on.
    The FL trainer uses one leaf with ``lane=1``."""

    def __init__(self, sizes: Sequence[int], lane: int = LANE):
        self.lane = lane
        self.d_valid = sum(int(n) for n in sizes)
        self.d_packed = sum(-(-int(n) // lane) * lane for n in sizes)


def hist_stride(d: int) -> int:
    """Power-of-two sample stride <= LANE for a d-coordinate buffer."""
    stride = 1
    while stride < LANE and d // (2 * stride) >= STATS_SAMPLE_CAP:
        stride *= 2
    return stride


def mag_bin(mag: Tensor) -> Tensor:
    """f32 magnitude -> f32 bin index in [0, STATS_MAG_BINS) (log2(0) =
    -inf lands in bin 0; a NaN magnitude stays NaN and falls in no bin)."""
    raw = torch.floor(MAG_BINS_PER_OCT * torch.log2(mag)
                      - MAG_BINS_PER_OCT * MAG_LO_OCT)
    return torch.clamp(raw, 0.0, STATS_MAG_BINS - 1)


def age_bin(age: Tensor) -> Tensor:
    """f32 age -> f32 unit bin index (exact for integer ages <= AGE_CAP)."""
    return torch.clamp(torch.floor(age), 0.0, STATS_AGE_BINS - 1)


def advance_age_hist(age_hist: Tensor) -> Tensor:
    """Every bin moves up by one (the post-update histogram of a round that
    refreshed nothing); the top bin folds onto itself."""
    out = torch.zeros_like(age_hist)
    out[1:] = age_hist[:-1]
    out[-1] += age_hist[-1]
    return out


def _tail_cut(hist: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Where the top-``target`` mass of ``hist`` ends: (bin index, fraction
    of that bin taken from its top, in [0, 1])."""
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    suffix_next = torch.cat([suffix[1:], suffix.new_zeros(1)])
    bstar = torch.clamp((suffix >= target).to(torch.float32).sum() - 1.0,
                        0.0, hist.shape[0] - 1).to(torch.int64)
    # take(), not [bstar]: indexing with a 0-d tensor reads it back to the
    # host
    need = target - suffix_next.take(bstar)
    frac = torch.clamp(need / torch.clamp(hist.take(bstar), min=1.0), 0.0,
                       1.0)
    return bstar, frac


def _hist_theta_m(mag_hist: Tensor, rho_m: float) -> Tensor:
    """θ_M from the magnitude histogram (log-linear inside the cut bin;
    empty histogram -> 0)."""
    total_m = mag_hist.sum()
    b, frac = _tail_cut(mag_hist, rho_m * total_m)
    log2_lo = ((b.to(torch.float32) + MAG_LO_OCT * MAG_BINS_PER_OCT)
               / MAG_BINS_PER_OCT)
    theta = torch.exp2(log2_lo + (1.0 - frac) / MAG_BINS_PER_OCT)
    return torch.where(total_m > 0.0, theta, torch.zeros_like(theta))


def _hist_theta_a(age_hist: Tensor, rho_a: float) -> Tensor:
    """θ_A from the age histogram (linear inside the unit atom; empty
    histogram -> 0)."""
    total_a = age_hist.sum()
    b, frac = _tail_cut(age_hist, rho_a * total_a)
    theta = b.to(torch.float32) + 1.0 - frac
    return torch.where(total_a > 0.0, theta, torch.zeros_like(theta))


def hist_thresholds(mag_hist: Tensor, age_hist: Tensor, *, rho: float,
                    k_m_frac) -> Tuple[Tensor, Tensor]:
    """(θ_M, θ_A) from the in-kernel histograms: θ_M cuts the top
    ρ·k_m_frac of the magnitude mass, θ_A the top ρ_A = (ρ − ρ_M)/(1 − ρ_M)
    of the age mass.  An empty histogram (the first round) gives θ = 0 for
    an active stage — a full refresh; a degenerate stage gives θ = inf.
    ``k_m_frac`` is a float, or a 0-d float32 tensor (the adaptive
    controller's traced split): then the degenerate-stage short-circuits
    are ``where``s on data and nothing is read back to the host."""
    device = mag_hist.device
    if not isinstance(k_m_frac, Tensor):
        rho_m = rho * k_m_frac
        rho_a = (rho - rho_m) / max(1.0 - rho_m, 1e-6)
        inf = torch.full((), float("inf"), device=device)
        theta_m = _hist_theta_m(mag_hist, rho_m) if rho_m > 0.0 else inf
        theta_a = _hist_theta_a(age_hist, rho_a) if rho_a > 0.0 else inf
        return theta_m, theta_a
    rho_m = rho * k_m_frac.to(torch.float32)
    rho_a = (rho - rho_m) / torch.clamp(1.0 - rho_m, min=1e-6)
    theta_m = torch.where(rho_m > 0.0, _hist_theta_m(mag_hist, rho_m),
                          float("inf"))
    theta_a = torch.where(rho_a > 0.0, _hist_theta_a(age_hist, rho_a),
                          float("inf"))
    return theta_m, theta_a


# --- warm-start threshold state -----------------------------------------

def init_threshold_state(device) -> Dict[str, Tensor]:
    """theta_m / theta_a: last round's thresholds; n_sel_m / n_sel: its
    counts; init: 0 until a round ran; streak: consecutive on-track
    rounds; mag_hist / age_hist: last round's kernel histograms."""
    def z():
        return torch.zeros((), dtype=torch.float32, device=device)
    return {"theta_m": z(), "theta_a": z(), "n_sel_m": z(), "n_sel": z(),
            "init": z(), "streak": z(),
            "mag_hist": torch.zeros(STATS_MAG_BINS, dtype=torch.float32,
                                    device=device),
            "age_hist": torch.zeros(STATS_AGE_BINS, dtype=torch.float32,
                                    device=device)}


def warm_corrected_thresholds(ts: Dict[str, Tensor], *, k: int, k_m,
                              alpha: float = 0.5, clip: float = 2.0,
                              max_age_step: float = 0.5
                              ) -> Tuple[Tensor, Tensor]:
    """Budget-tracking correction of the carried thresholds: θ_M moves by
    ``(n_m / k_m) ** alpha`` clipped to [1/clip, clip]; θ_A moves
    additively by at most ``max_age_step`` scaled by the relative budget
    error of the age stage.  Degenerate stages (k_m = 0 or k_a = 0) give
    θ = inf; an infinite carried θ passes through.  ``k_m`` is an int, or
    a 0-d tensor (the traced split): then the same corrections with the
    degenerate stages as ``where``s on data."""
    device = ts["theta_m"].device
    if isinstance(k_m, Tensor):
        k_m_f = k_m.to(torch.float32)
        k_a_f = k - k_m_f
        f_m = torch.clamp((torch.clamp(ts["n_sel_m"], min=1.0)
                           / torch.clamp(k_m_f, min=1.0)) ** alpha,
                          1.0 / clip, clip)
        theta_m = torch.where(
            k_m_f > 0.0,
            torch.where(torch.isinf(ts["theta_m"]), ts["theta_m"],
                        ts["theta_m"] * f_m), float("inf"))
        n_a = ts["n_sel"] - ts["n_sel_m"]
        step = torch.clamp((n_a - k_a_f) / torch.clamp(k_a_f, min=1.0),
                           -1.0, 1.0) * max_age_step
        theta_a = torch.where(
            k_a_f > 0.0,
            torch.where(torch.isinf(ts["theta_a"]), ts["theta_a"],
                        ts["theta_a"] + step), float("inf"))
        return theta_m.to(torch.float32), theta_a.to(torch.float32)
    inf = torch.full((), float("inf"), device=device)
    k_a = k - k_m
    if k_m > 0:
        f_m = torch.clamp((torch.clamp(ts["n_sel_m"], min=1.0) / k_m)
                          ** alpha, 1.0 / clip, clip)
        theta_m = torch.where(torch.isinf(ts["theta_m"]), ts["theta_m"],
                              ts["theta_m"] * f_m)
    else:
        theta_m = inf
    if k_a > 0:
        n_a = ts["n_sel"] - ts["n_sel_m"]
        step = torch.clamp((n_a - k_a) / k_a, -1.0, 1.0) * max_age_step
        theta_a = torch.where(torch.isinf(ts["theta_a"]), ts["theta_a"],
                              ts["theta_a"] + step)
    else:
        theta_a = inf
    return theta_m.to(torch.float32), theta_a.to(torch.float32)
