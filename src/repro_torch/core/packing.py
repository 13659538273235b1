"""Packed server state: the whole parameter tree as one flat buffer, the
statistics-histogram spec, the async age bookkeeping and the warm-start
threshold state (``repro.core.packing``).

``PackedLayout`` lays every leaf of a parameter tree (nested dicts of
tensors, flattened in ``jax.tree_util`` order by ``repro_torch.tree``)
into ONE contiguous buffer: each leaf starts at a multiple of ``lane``
(256, the fused kernel's tile quantum) and is followed by ``pad`` dead
coordinates up to the next multiple.  The block table is static Python
data, so ``pack`` is one ``torch.cat`` over the leaves and the pad fills
and ``unpack`` returns views.  The FL trainer's flat ``(d,)`` server
vector is the one-leaf layout with ``lane=1`` (no pads).

Padding protocol (kept by the kernels): pad coordinates carry ``g = 0``
and ``age = PAD_AGE`` (-1); real ages are >= 0, so ``age < 0`` marks a
pad everywhere downstream — never selected, age, ``g_prev`` and residual
passed through, weight zero in the histograms; the sampled-quantile
thresholds sample only valid coordinates (``PackedLayout.sample_ids``).
The threshold estimators take the adaptive controller's traced split as
a 0-d tensor.
"""

from __future__ import annotations

import dataclasses
from math import prod
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import oac
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor

PAD_AGE = -1.0
# staleness clip applied by every age update (int8 server state headroom,
# with room for an async lag shift on top)
AGE_CAP = 120.0
LANE = 256

# counters of the structural claims (``benchmarks/torch_packed_bench.py
# --smoke``): tree copies into and out of the packed buffer, and full read
# passes over the gradient buffer (the fused kernel, the sampled-quantile
# and order-statistic estimators and the legacy count pass each add one)
PACK_CALLS = 0
UNPACK_CALLS = 0
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


@dataclasses.dataclass(frozen=True)
class BlockEntry:
    """One leaf's slot in the packed buffer."""
    index: int                  # position in the flattened leaf list
    offset: int                 # start in the packed buffer (lane-aligned)
    size: int                   # real coordinates
    pad: int                    # dead coordinates after the leaf
    shape: Tuple[int, ...]
    dtype: torch.dtype


class PackedLayout:
    """Static packed layout of a parameter tree: ``d_packed`` counts the
    buffer, ``d_valid`` the real coordinates the budgets draw on,
    ``n_leaves`` the block table's entries."""

    def __init__(self, paths: Sequence[tree_util.Path],
                 entries: Sequence[BlockEntry], lane: int = LANE):
        self.paths = tuple(paths)
        self.table: Tuple[BlockEntry, ...] = tuple(entries)
        self.lane = lane
        last = self.table[-1] if self.table else None
        self.d_packed = last.offset + last.size + last.pad if last else 0
        self.d_valid = sum(e.size for e in self.table)
        self.n_leaves = len(self.table)
        self._fills: Dict[Any, Tensor] = {}

    @classmethod
    def from_tree(cls, tree: Any, lane: int = LANE) -> "PackedLayout":
        """The layout of a tree whose leaves have ``shape`` and ``dtype``
        (tensors, ``meta`` tensors included, or numpy arrays)."""
        paths, entries, offset = [], [], 0
        for i, (path, leaf) in enumerate(tree_util.leaves(tree)):
            shape = tuple(int(n) for n in leaf.shape)
            size = prod(shape)
            padded = -(-size // lane) * lane
            dtype = (leaf.dtype if isinstance(leaf.dtype, torch.dtype)
                     else torch.from_numpy(np.zeros(0, leaf.dtype)).dtype)
            entries.append(BlockEntry(i, offset, size, padded - size, shape,
                                      dtype))
            paths.append(path)
            offset += padded
        return cls(paths, entries, lane)

    # -- pack / unpack ------------------------------------------------------

    def _fill(self, fill: float, dtype: torch.dtype, device) -> Tensor:
        """A cached run of ``fill`` as long as the longest pad: every pad
        slot of ``pack`` is a view of it."""
        key = (fill, dtype, torch.device(device))
        buf = self._fills.get(key)
        if buf is None:
            n = max((e.pad for e in self.table), default=0)
            buf = torch.full((n,), fill, dtype=dtype, device=device)
            self._fills[key] = buf
        return buf

    def pack(self, tree: Any, dtype: torch.dtype = torch.float32,
             fill: float = 0.0) -> Tensor:
        """Tree -> ``(d_packed,)`` buffer of ``dtype``: one ``torch.cat``
        over the flattened leaves, with ``fill`` in the pads."""
        global PACK_CALLS
        PACK_CALLS += 1
        leaves = [leaf for _, leaf in tree_util.leaves(tree)]
        if len(leaves) != self.n_leaves:
            raise ValueError(f"tree has {len(leaves)} leaves, the layout "
                             f"{self.n_leaves}")
        device = leaves[0].device
        pads = self._fill(fill, dtype, device)
        parts = []
        for e, leaf in zip(self.table, leaves):
            parts.append(leaf.reshape(-1).to(dtype))
            if e.pad:
                parts.append(pads[:e.pad])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def pack_age(self, tree: Any, dtype: torch.dtype = torch.float32
                 ) -> Tensor:
        """Age tree -> flat buffer with ``PAD_AGE`` in the pads."""
        return self.pack(tree, dtype=dtype, fill=PAD_AGE)

    def unpack(self, flat: Tensor, cast: bool = True) -> Any:
        """``(d_packed,)`` buffer -> tree of the leaves' shapes (views of
        ``flat``; with ``cast`` in the leaves' dtypes, a copy where the
        dtype differs)."""
        global UNPACK_CALLS
        UNPACK_CALLS += 1
        out = []
        for e in self.table:
            leaf = flat[e.offset:e.offset + e.size].view(e.shape)
            out.append(leaf.to(e.dtype) if cast else leaf)
        return tree_util.unflatten(self.paths, out)

    # -- pad bookkeeping ----------------------------------------------------

    def _valid_np(self) -> np.ndarray:
        mask = np.zeros(self.d_packed, bool)
        for e in self.table:
            mask[e.offset:e.offset + e.size] = True
        return mask

    def valid_mask(self, device: DeviceLike = None) -> Tensor:
        """``(d_packed,)`` bool: True on real coordinates (on the card
        unless ``device`` says otherwise)."""
        return torch.from_numpy(self._valid_np()).to(resolve_device(device))

    def init_age(self, dtype: torch.dtype = torch.int8,
                 device: DeviceLike = None) -> Tensor:
        """Fresh age buffer: 0 on valid coordinates, ``PAD_AGE`` in pads."""
        age = np.where(self._valid_np(), np.float32(0.0),
                       np.float32(PAD_AGE))
        return torch.from_numpy(age).to(device=resolve_device(device),
                                        dtype=dtype)

    def sample_ids(self, cap: int, device: DeviceLike = None) -> Tensor:
        """int64 packed positions of an even strided sample over the VALID
        coordinates only (every ``d_valid // cap``-th valid coordinate):
        pad zeros in the sample would bias θ_M low.  Computed per sampled
        coordinate, without listing the valid ones."""
        stride = max(1, self.d_valid // max(1, cap))
        v = np.arange(0, self.d_valid, stride, dtype=np.int64)
        starts = np.cumsum([0] + [e.size for e in self.table])[:-1]
        offsets = np.array([e.offset for e in self.table], np.int64)
        leaf = np.searchsorted(starts, v, side="right") - 1
        return torch.from_numpy(offsets[leaf] + (v - starts[leaf])).to(
            resolve_device(device))


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


def shift_selected_age(age_next: Tensor, lag) -> Tensor:
    """Async rounds: the just-selected coordinates (the ``age == 0`` ones
    of a POST-merge age vector) carry their delivery lag ``lag`` instead of
    0; other ages and pads pass through; clipped at ``AGE_CAP``.  ``lag =
    0`` is the identity."""
    a = age_next.to(torch.float32)
    sel = (a == 0.0).to(torch.float32)
    return torch.clamp(a + sel * float(lag), max=AGE_CAP)


def shift_age_hist(age_hist: Tensor, lag: int) -> Tensor:
    """The histogram of ``shift_selected_age``: bin 0's mass moves to bin
    ``lag`` (clipped to the top bin).  ``lag <= 0`` returns the input."""
    if lag <= 0:
        return age_hist
    b = min(int(lag), STATS_AGE_BINS - 1)
    out = age_hist.to(torch.float32).clone()
    # in-place on views: assigning a Python scalar to an element of a
    # CUDA tensor is a host-to-device copy that waits for the device
    out[b].add_(out[0])
    out[0].zero_()
    return out


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


THRESHOLD_STATE_FIELDS = ("theta_m", "theta_a", "n_sel_m", "n_sel",
                          "init", "streak")
THRESHOLD_STATE_SIZE = (len(THRESHOLD_STATE_FIELDS)
                        + STATS_MAG_BINS + STATS_AGE_BINS)


def threshold_state_to_vec(ts: Dict[str, Tensor]) -> Tensor:
    """(THRESHOLD_STATE_SIZE,) float32 encoding: the six scalars, then the
    two histograms (the launch path's carried ``theta`` vector)."""
    scalars = torch.stack([ts[f].to(torch.float32).reshape(())
                           for f in THRESHOLD_STATE_FIELDS])
    return torch.cat([scalars, ts["mag_hist"].to(torch.float32),
                      ts["age_hist"].to(torch.float32)])


def threshold_state_from_vec(vec: Tensor) -> Dict[str, Tensor]:
    """The inverse of ``threshold_state_to_vec`` (views of ``vec``); a
    scalar-only legacy vector gets zero histograms."""
    ns = len(THRESHOLD_STATE_FIELDS)
    ts = {f: vec[i] for i, f in enumerate(THRESHOLD_STATE_FIELDS)}
    if vec.shape[0] >= THRESHOLD_STATE_SIZE:
        ts["mag_hist"] = vec[ns:ns + STATS_MAG_BINS]
        ts["age_hist"] = vec[ns + STATS_MAG_BINS:THRESHOLD_STATE_SIZE]
    else:
        ts["mag_hist"] = torch.zeros(STATS_MAG_BINS, dtype=torch.float32,
                                     device=vec.device)
        ts["age_hist"] = torch.zeros(STATS_AGE_BINS, dtype=torch.float32,
                                     device=vec.device)
    return ts


# --- layout (de)serialisation: checkpoints of the packed server buffers --

def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype by the numpy name the reference records
    (``torch.bfloat16`` -> ``"bfloat16"``)."""
    return str(dtype).replace("torch.", "")


def layout_to_meta(layout: PackedLayout) -> Dict[str, Any]:
    """JSON-serialisable block table (no tree structure: the restoring
    process rebuilds the layout from its own parameter tree and checks it
    with ``layout_matches``) — the reference's record, key for key."""
    return {
        "lane": layout.lane,
        "d_packed": layout.d_packed,
        "d_valid": layout.d_valid,
        "entries": [[e.offset, e.size, e.pad, list(e.shape),
                     dtype_name(e.dtype)] for e in layout.table],
    }


def layout_matches(layout: PackedLayout, meta: Dict[str, Any]) -> bool:
    """True when ``layout`` describes the buffer geometry of a saved
    ``layout_to_meta`` record (offsets, sizes, pads, shapes and dtypes)."""
    if (layout.lane != meta["lane"] or layout.d_packed != meta["d_packed"]
            or layout.d_valid != meta["d_valid"]
            or len(layout.table) != len(meta["entries"])):
        return False
    return all([e.offset, e.size, e.pad, list(e.shape),
                dtype_name(e.dtype)] == m
               for e, m in zip(layout.table, meta["entries"]))


def _pow(x: Tensor, alpha: float) -> Tensor:
    """``x ** alpha`` as the compiled reference computes it: XLA computes
    an array's power 0.5 as the correctly rounded square root.  Taken in
    float64 and rounded once: ``torch.pow`` at 0.5, and ``torch.sqrt`` of
    a float32 on the CPU, differ from it in the last place on about 1% of
    values."""
    if alpha == 0.5:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return x ** alpha


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
    degenerate stages as ``where``s on data.  With a static ``k_m`` the
    divisions by ``k_m`` and ``k_a`` are products with their float32
    reciprocals, as the compiled reference computes them."""
    device = ts["theta_m"].device
    if isinstance(k_m, Tensor):
        k_m_f = k_m.to(torch.float32)
        k_a_f = k - k_m_f
        f_m = torch.clamp(_pow(torch.clamp(ts["n_sel_m"], min=1.0)
                               / torch.clamp(k_m_f, min=1.0), alpha),
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
        f_m = torch.clamp(_pow(torch.clamp(ts["n_sel_m"], min=1.0)
                               * oac.reciprocal(k_m), alpha),
                          1.0 / clip, clip)
        theta_m = torch.where(torch.isinf(ts["theta_m"]), ts["theta_m"],
                              ts["theta_m"] * f_m)
    else:
        theta_m = inf
    if k_a > 0:
        n_a = ts["n_sel"] - ts["n_sel_m"]
        step = torch.clamp((n_a - k_a) * oac.reciprocal(k_a), -1.0,
                           1.0) * max_age_step
        theta_a = torch.where(torch.isinf(ts["theta_a"]), ts["theta_a"],
                              ts["theta_a"] + step)
    else:
        theta_a = inf
    return theta_m.to(torch.float32), theta_a.to(torch.float32)
