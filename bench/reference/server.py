"""The edge server's round in plain float32: the packed layout, the
FAIR-k selection with the thresholds the port carries from round to
round, the stale merge and the ages (Eqs. 8 and 10), the error-feedback
residual, the one-bit vote with channel noise, and AdamW.

What the port states and this follows (``repro_torch.core.packing`` /
``engine`` docstrings):

* the tree is packed leaf by leaf in flattening order, each leaf padded
  to a multiple of 256 coordinates; pads carry age -1 and are never
  selected;
* budgets ``k = max(2, round(ρ·d_valid))``, ``k_M = round(k_m_frac·k)``;
  the magnitude stage takes ``|score| >= θ_M``, the age stage ``age +
  jitter >= θ_A`` of the rest, the jitter the Knuth hash of the packed
  position (``(i · 2654435761 mod 2^32) mod 2^24 / 2^24``);
* θ_M and θ_A cut the top ρ_M = (k/d_valid)·(k_M/k) of last round's
  histogram of |score| (quarter-octave log2 bins from 2^-24, 128 bins,
  log-linear inside the cut bin) and the top ρ_A = (ρ − ρ_M)/(1 − ρ_M) of
  its histogram of post-round ages (unit bins, linear inside the cut
  bin); both histograms sample every ``stride``-th packed position, the
  stride the largest power of two <= 256 with d/(2·stride) >= 2^15; an
  empty histogram (the first round) gives θ = 0, a full refresh;
* the warm-corrected thresholds (``packing.warm_corrected_thresholds``,
  the trust gates of ``engine``): θ_M' = θ_M · clip(√(max(n_M, 1)/k_M),
  1/2, 2) and θ_A' = θ_A + clip((n_A − k_A)/k_A, −1, 1)/2 from last
  round's thresholds and counts (n_M the magnitude stage's, n_A = n − n_M
  the age stage's); they replace the histogram cuts in a round whose
  predecessor selected within 25% of k (on track) and whose carried
  streak is 3 or more.  The streak counts on-track rounds in a row whose
  prediction agreed with the thresholds used (θ_A within 0.75, θ_M
  within a factor 1.25); the first round has none.  So with the full
  refresh of round 1, rounds 6 on are warm where the counts stay on
  track.  Divisions by k_M and k_A are products with their float32
  reciprocals, the square root is taken in float64 and rounded once, and
  the counts are exact and rounded to float32, as the port states;
* one-bit (``one_bit``): the vote ``sign(score)`` plus ``noise_std·z``,
  re-signed, is what a selected coordinate receives; ``z`` is the port's
  draw stream for the step seed (a generator seeded from
  ``SeedSequence([step seed, 0, 0])``), the same numbers for both sides;
* error feedback: ``score = g + residual``, the residual afterwards
  ``score − mask·sent``;
* the carried gradient is kept in bfloat16 and the ages in int8; the
  optimizer takes the merged gradient unpacked.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from bench.reference.precision import rounded

Tensor = torch.Tensor
LANE = 256
AGE_CAP = 120.0
MAG_BINS = AGE_BINS = 128
MAG_LO_OCT = -24.0
BINS_PER_OCT = 4.0
SAMPLE_CAP = 1 << 15
SUPPORTED = {"rho", "k_m_frac", "noise_std", "one_bit", "error_feedback"}
WARM_ALPHA, WARM_CLIP, WARM_TOL, WARM_STREAK, WARM_AGE_STEP = \
    0.5, 2.0, 0.25, 3, 0.5


class Layout:
    """Offsets of the leaves (sizes from ``shapes``) in the packed
    buffer."""

    def __init__(self, shapes: Sequence[Sequence[int]]):
        self.sizes = [int(np.prod(s)) for s in shapes]
        self.shapes = [tuple(s) for s in shapes]
        self.offsets, off = [], 0
        for n in self.sizes:
            self.offsets.append(off)
            off += -(-n // LANE) * LANE
        self.d_packed, self.d_valid = off, sum(self.sizes)

    def valid(self, device) -> Tensor:
        v = torch.zeros(self.d_packed, dtype=torch.bool, device=device)
        for o, n in zip(self.offsets, self.sizes):
            v[o:o + n] = True
        return v

    def pack(self, leaves: Sequence[Tensor]) -> Tensor:
        out = torch.zeros(self.d_packed, dtype=torch.float32,
                          device=leaves[0].device)
        for o, n, x in zip(self.offsets, self.sizes, leaves):
            out[o:o + n] = x.reshape(-1)
        return out

    def unpack(self, flat: Tensor) -> List[Tensor]:
        return [flat[o:o + n].view(s) for o, n, s in
                zip(self.offsets, self.sizes, self.shapes)]


def jitter(n: int, device) -> Tensor:
    i = torch.arange(n, dtype=torch.int64, device=device)
    return ((i * 2654435761) % (1 << 32) % (1 << 24)).to(torch.float32) \
        / float(1 << 24)


def hist_stride(d: int) -> int:
    stride = 1
    while stride < LANE and d // (2 * stride) >= SAMPLE_CAP:
        stride *= 2
    return stride


def _cut(hist: Tensor, target: Tensor):
    """(bin, fraction of it from its top) where the top ``target`` of the
    histogram's mass ends."""
    above = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    b = int(((above >= target).sum() - 1).clamp(0, hist.shape[0] - 1))
    rest = above[b + 1] if b + 1 < hist.shape[0] else hist.new_zeros(())
    frac = ((target - rest) / hist[b].clamp(min=1.0)).clamp(0.0, 1.0)
    return b, frac


def noise_stream(step_seed: int, n: int, device) -> Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([step_seed, 0, 0])
                        .generate_state(1, np.uint64)[0]))
    return torch.randn(n, generator=gen, device=device)


class Server:
    """The carried server state and one round of it."""

    def __init__(self, layout: Layout, oac: Dict[str, Any], device):
        unknown = set(oac) - SUPPORTED
        if unknown:
            raise ValueError(f"the reference server does not model "
                             f"{sorted(unknown)}")
        if oac.get("noise_std", 0.0) > 0 and not oac.get("one_bit"):
            raise ValueError("the reference server models channel noise "
                             "on the one-bit vote only")
        self.lay, self.oac = layout, oac
        d = layout.d_packed
        self.valid = layout.valid(device)
        self.g = torch.zeros(d, dtype=torch.bfloat16, device=device)
        self.age = torch.where(self.valid, 0.0, -1.0)
        self.res = (torch.zeros(d, device=device)
                    if oac.get("error_feedback") else None)
        self.mag_hist = torch.zeros(MAG_BINS, device=device)
        self.age_hist = torch.zeros(AGE_BINS, device=device)
        self.jitter = jitter(d, device)
        self.rounds = self.warm_rounds = 0
        k = max(2, round(oac["rho"] * layout.d_valid))
        k_m = int(round(oac.get("k_m_frac", 0.75) * k))
        if not 0 < k_m < k:
            raise ValueError("the reference server models two live stages")
        self.k, self.k_m = k, k_m
        # last round's thresholds and counts, and the streak (float32, as
        # the port carries them); None before the first round
        self.carried = None
        rho = k / layout.d_valid
        self.rho_m = rho * (k_m / k)
        self.rho_a = (rho - self.rho_m) / max(1.0 - self.rho_m, 1e-6)

    def thresholds(self):
        """(θ_M, θ_A) from last round's histograms (0 before any)."""
        zero = torch.zeros((), device=self.age.device)
        tm = ta = zero
        if self.mag_hist.sum() > 0:
            b, frac = _cut(self.mag_hist,
                           self.rho_m * self.mag_hist.sum())
            tm = torch.exp2((b + MAG_LO_OCT * BINS_PER_OCT) / BINS_PER_OCT
                            + (1.0 - frac) / BINS_PER_OCT)
        if self.age_hist.sum() > 0:
            b, frac = _cut(self.age_hist,
                           self.rho_a * self.age_hist.sum())
            ta = b + 1.0 - frac
        return tm, ta

    def predicted(self):
        """The warm-corrected (θ_M, θ_A) from last round's carried state."""
        c = self.carried
        f32 = torch.float32
        rk_m = float(np.float32(1.0) / np.float32(self.k_m))
        rk_a = float(np.float32(1.0) / np.float32(self.k - self.k_m))
        ratio = c["n_sel_m"].clamp(min=1.0) * rk_m
        f_m = torch.sqrt(ratio.to(torch.float64)).to(f32).clamp(
            1.0 / WARM_CLIP, WARM_CLIP)
        n_a = c["n_sel"] - c["n_sel_m"]
        step = ((n_a - (self.k - self.k_m)) * rk_a).clamp(-1.0, 1.0) \
            * WARM_AGE_STEP
        return c["theta_m"] * f_m, c["theta_a"] + step

    def select_thresholds(self):
        """(θ_M, θ_A, streak') of this round: the histogram cuts, or the
        warm-corrected ones once the trust gates hold."""
        tm, ta = self.thresholds()
        c = self.carried
        zero = torch.zeros((), device=self.age.device)
        if c is None:
            return tm, ta, zero
        ptm, pta = self.predicted()
        on_track = bool((c["n_sel"] - self.k).abs() <= WARM_TOL * self.k)
        if on_track and float(c["streak"]) >= WARM_STREAK:
            tm, ta = ptm, pta
            self.warm_rounds += 1
        tol = 1.0 + WARM_TOL
        agree = bool(((ta - pta).abs() <= 0.75)
                     & (ptm <= tm * tol) & (ptm * tol >= tm))
        return tm, ta, (c["streak"] + 1.0 if on_track and agree else zero)

    def round(self, g: Tensor, step_seed: int, prec: str = "float32"
              ) -> Tensor:
        """The packed gradient ``g`` (float32) -> the merged gradient."""
        oac = self.oac
        g = rounded(g, prec)
        score = g if self.res is None else g + rounded(self.res, prec)
        sent = score
        if oac.get("one_bit"):
            vote = torch.where(score >= 0, 1.0, -1.0)
            if oac.get("noise_std", 0.0) > 0:
                vote = vote + oac["noise_std"] * noise_stream(
                    step_seed, g.shape[0], g.device)
            sent = torch.where(vote >= 0, 1.0, -1.0)
        tm, ta, streak = self.select_thresholds()
        mag = score.abs()
        sel_m = self.valid & (mag >= tm)
        sel = sel_m | (self.valid & (self.age + self.jitter >= ta))
        g_t = torch.where(sel, sent, self.g.to(torch.float32))
        age = torch.where(sel, 0.0, (self.age + 1.0).clamp(max=AGE_CAP))
        self.age = torch.where(self.valid, age, self.age)
        if self.res is not None:
            self.res = torch.where(self.valid, score - sel * sent, self.res)
        stride = hist_stride(g.shape[0])
        w = self.valid[::stride]
        mbin = (BINS_PER_OCT * torch.log2(mag[::stride])
                - BINS_PER_OCT * MAG_LO_OCT).floor().clamp(0, MAG_BINS - 1)
        abin = self.age[::stride].floor().clamp(0, AGE_BINS - 1)
        self.mag_hist = torch.bincount(mbin[w].long(), minlength=MAG_BINS
                                       ).to(torch.float32)
        self.age_hist = torch.bincount(abin[w].long(), minlength=AGE_BINS
                                       ).to(torch.float32)
        self.g = g_t.to(torch.bfloat16)
        self.carried = {"theta_m": tm.to(torch.float32),
                        "theta_a": ta.to(torch.float32),
                        "n_sel_m": sel_m.sum().to(torch.float32),
                        "n_sel": sel.sum().to(torch.float32),
                        "streak": streak}
        self.rounds += 1
        return g_t


class AdamW:
    """AdamW without weight decay over a list of float32 leaves."""

    def __init__(self, params: List[Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, params: List[Tensor], grads: List[Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / ((v / bc2).sqrt() + self.eps))
