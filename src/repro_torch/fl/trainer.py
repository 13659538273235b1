"""OAC-FL training loop (paper Algorithm 1) on the exact, threshold and
packed backends.

One round: every client runs ``H`` local SGD steps (Eq. 4) and returns
its accumulated gradient (Eq. 5); the clients stream through the round in
chunks of ``client_chunk``, each chunk batched with
``torch.func.vmap(torch.func.grad(...))`` and folded into one
accumulator, so the (N, d) matrix is never live.

* ``exact`` (the paper's figures): the selection ``S_t`` (Eq. 11, any of
  the six policies) scores ``(g_prev, age)`` before the clients compute,
  so each chunk is gathered at the ``k`` selected coordinates and folded
  into a (k,) row — the faded contraction on the coherent uplink (Eq. 7),
  the ±1 vote sum on the one-bit FSK-MV uplink (``ops.vote_fold``: one
  ``sign_mv`` launch quantizes, gathers and adds each chunk).
  On the one-bit uplink the majority vote (``sign_from_energy``) follows;
  then one ``aou_merge`` launch (``ops.aou_merge_by_indices``) applies the
  coherent receiver tail (noise and 1/N), the Eq. 8 scatter, the
  index-form Eq. 10, the participation count and client-side error
  feedback, and the model step (Eq. 9) ends the round.
* ``threshold`` and ``packed``: the coherent uplink superposes the faded
  gradients over all d coordinates; the one-bit uplink folds each chunk's
  votes with ``ops.vote_fold`` and detects with one ``sign_from_energy``
  launch (noise, signs and the selection score); then one fused FAIR-k
  pass (``fairk_update`` kernel) selects, merges and advances the age,
  with server-side error feedback, and emits the counts and histograms.
  ``threshold`` takes (θ_M, θ_A) from this round's sampled quantiles,
  ``packed`` from the carried statistics (round 0 is a full refresh).

Adaptive split (``adaptive_km=True``, or the ``fairk_auto`` alias): the
FAIR-k split ``k_m_frac`` is the carried controller state's live value (a
0-d tensor on the device), and the ``BudgetController`` update ends the
round.  Exact: the rank-form FAIR-k mask at ``traced_km(k, k_m_frac)``,
its ``k`` indices taken without a host sync (``engine.mask_to_indices``),
then the same clients fold and the same single ``aou_merge`` launch; the
controller reads the post-update age histogram (``ref.strided_hists_ref``).
Packed: the traced split goes into the engine's statistics thresholds, and
the controller reads the kernel's age and magnitude histograms.

Async rounds (``async_lag`` > 0): the selected coordinates' contribution
lands ``async_lag`` rounds late, so their post-update age is the lag
instead of 0 (``packing.shift_selected_age``, after the exact route's
``aou_merge`` launch, inside the engine on the others), and the
controller's age target moves by the same constant.  ``scan_rounds`` > 1
runs the rounds in chunks cut at eval rounds, each chunk's client batches
staged in one pinned host buffer and sent in one copy; it walks the
per-round loop's trajectory bit for bit.

Scenario rounds (``faults``, ``population``, ``wireless``; DESIGN.md
§14–16): every backend takes the dense route — the exact one too, with
the engine's noise and statistics on.  The per-client gates (fading,
Gilbert–Elliott availability or the population's participation, the
channel's survivors times their CSI error) compose into one (N,) weight
row, the superposition rescales by the realised participation
(``faults.participation_scale``), corruption hits the aggregate, churn and
fade blocks erase, a round with no participant erases everything, and
``select_and_merge`` runs sanitized.  The one-bit wireless round weights
each client's votes by ``sent · csi`` inside the fold (``ops.vote_fold``'s
``row``: one ``sign_mv`` launch per chunk).  The watchdog
(``faults.watchdog_step``) observes the loss on the first client's first
batch and ``‖g_t‖`` after the round, rolls every carried buffer back to
its shadow snapshot on a trip and tightens the split during its cooldown;
all of it with ``torch.where``, no host sync.  The carried state is
``init_fault_state``'s ``fstate``.

Randomness: PyTorch cannot reproduce JAX's threefry streams, so a round
takes its draws as tensors (``draw_round``): the fading ``h`` (N,) on the
coherent uplink, the standard-normal channel noise ``z`` — (d,) on the
dense route, (k,) on the exact one — and, for ``toprand`` / ``randk``,
the uniform selection draw ``u`` (d,); a scenario round adds its named
draws (``av``, ``fd``, ``nz``, ``pop`` and ``participants``, ``er``,
``fad``, ``csi``).  ``train`` draws them from a ``torch.Generator``
seeded with ``fl.seed``; the tests hand both packages the same numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import channel as chan
from repro_torch.core import controller as budget
from repro_torch.core import faults, oac, packing, population, quantize
from repro_torch.core import selection
from repro_torch.core.engine import (EngineConfig, SelectionEngine,
                                     budgets_for)
from repro_torch.core.oac import ChannelConfig
from repro_torch.device import DeviceLike, resolve_device, set_numerics
from repro_torch.kernels import ops, ref
from repro_torch.models.cnn import ravel_params

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Field names and defaults of ``repro.fl.trainer.FLConfig``."""
    n_clients: int = 50
    local_steps: int = 5            # H
    batch_size: int = 50            # B
    local_lr: float = 0.01          # eta_l
    global_lr: float = 0.01         # eta
    rounds: int = 200
    policy: str = "fairk"
    backend: str = "exact"          # "exact" | "threshold" | "packed"
    compression_ratio: float = 0.1  # rho = k / d
    k_m_frac: float = 0.75          # k_M / k
    r_frac: float = 1.5
    channel: ChannelConfig = oac.PAPER_DEFAULT
    one_bit: bool = False           # FSK-MV prototype uplink (Sec. V-B)
    error_feedback: bool = False    # client-side on the exact round and on
                                    # one-bit, server-side (in the fused
                                    # pass or the engine) otherwise
    adaptive_km: bool = False       # the adaptive split; "fairk_auto"
                                    # is an alias
    async_lag: int = 0              # rounds a selected contribution
                                    # lands late (0: synchronous)
    scan_rounds: int = 0            # rounds per staged chunk (0/1: per
                                    # round)
    controller: budget.ControllerConfig = budget.ControllerConfig()
    faults: faults.FaultConfig = faults.FaultConfig()
                                    # Gilbert–Elliott dropout, deep-fade
                                    # erasures, NaN/Inf corruption (all
                                    # zero: off)
    watchdog: Optional[faults.WatchdogConfig] = None
                                    # divergence watchdog: rollback to a
                                    # shadow snapshot, tightened k_M
    population: Optional[population.PopulationConfig] = None
                                    # the N clients are each round's
                                    # cohort of a virtual population
                                    # (participants == n_clients)
    wireless: Optional[chan.ChannelConfig] = None
                                    # geometric channel: per-client AR(1)
                                    # fading, truncated inversion, CSI
                                    # error (replaces ``channel``'s fading;
                                    # its noise_std stays)
    client_chunk: Optional[int] = None
    seed: int = 0

    @property
    def adaptive(self) -> bool:
        return self.adaptive_km or self.policy == "fairk_auto"

    @property
    def chaos(self) -> bool:
        return self.faults.enabled

    @property
    def scenario(self) -> bool:
        """Faults, a population or the wireless channel: the round takes
        the dense sanitized route on every backend."""
        return self.chaos or self.population is not None or (
            self.wireless is not None)

    @property
    def stateful(self) -> bool:
        """The round carries ``fstate`` (``init_fault_state``)."""
        return self.scenario or self.watchdog is not None

    def budgets(self, d: int) -> Tuple[int, int, int]:
        """(k, k_M, r) — the engine's rounding and Remark-1 pinning."""
        return budgets_for(EngineConfig(
            policy="fairk" if self.policy == "fairk_auto" else self.policy,
            rho=self.compression_ratio, k_m_frac=self.k_m_frac,
            r_frac=self.r_frac), d)


@dataclasses.dataclass
class ServerState:
    """Flat server buffers carried across rounds (single-leaf packed layout,
    lane=1, no pads)."""
    w: Tensor                        # flat global model (d,)
    g: Tensor                        # last reconstructed gradient (d,)
    age: Tensor                      # AoU vector (d,)
    sel_count: Tensor                # per-entry participation counter
    residual: Tensor = None          # EF accumulator (d,)
    theta: Dict[str, Tensor] = None  # packing.init_threshold_state()
    ctrl: Dict[str, Tensor] = None   # controller.init_controller_state()
    round: int = 0


def validate(fl: FLConfig) -> None:
    """The reference's ``make_fl_step`` checks: ``ValueError`` for an
    unknown backend, a negative lag, an adaptive or watchdog run off
    FAIR-k, a scenario with an index-form policy, chaos or a population on
    the one-bit uplink, a wireless deployment of another size, a
    population whose cohort is not the N clients or that runs beside
    ``faults.dropout``, and a chunk that does not divide N."""
    if fl.backend not in ("exact", "threshold", "packed"):
        raise ValueError(f"FLConfig.backend must be exact|threshold|packed, "
                         f"got {fl.backend!r}")
    if fl.adaptive and fl.policy not in ("fairk", "fairk_auto"):
        raise ValueError("adaptive_km moves the FAIR-k split — policy "
                         f"{fl.policy!r} pins or ignores it")
    if fl.async_lag < 0:
        raise ValueError(f"async_lag must be >= 0, got {fl.async_lag}")
    pop, wl = fl.population is not None, fl.wireless is not None
    if fl.chaos and fl.one_bit:
        raise ValueError("fault injection on the one-bit FSK-MV uplink is "
                         "not modelled — run chaos with one_bit=False")
    if fl.scenario and fl.policy not in ("fairk", "topk", "roundrobin",
                                         "fairk_auto"):
        raise ValueError("chaos/population/wireless rounds run selection "
                         f"in sanitized threshold/rank form — policy "
                         f"{fl.policy!r} needs index arithmetic")
    if wl and fl.wireless.n_clients != fl.n_clients:
        raise ValueError(
            "the wireless deployment covers the compute clients: "
            f"wireless.n_clients={fl.wireless.n_clients} must equal "
            f"n_clients={fl.n_clients}")
    if pop:
        if fl.population.participants != fl.n_clients:
            raise ValueError(
                "the FL sim's compute clients ARE the sampled cohort: "
                f"population.participants={fl.population.participants} "
                f"must equal n_clients={fl.n_clients}")
        if fl.faults.dropout > 0.0:
            raise ValueError(
                "population availability and FaultConfig.dropout are two "
                "availability processes gating the same superposition — "
                "run one at a time (fade/nan_rate compose fine)")
        if fl.one_bit:
            raise ValueError("population churn on the one-bit FSK-MV "
                             "uplink is not modelled — run population "
                             "with one_bit=False")
    if fl.watchdog is not None and fl.policy not in ("fairk", "fairk_auto"):
        raise ValueError("the watchdog tightens the FAIR-k split — policy "
                         f"{fl.policy!r} pins or ignores it")
    chunk = fl.client_chunk if fl.client_chunk is not None else fl.n_clients
    if not 1 <= chunk <= fl.n_clients or fl.n_clients % chunk:
        raise ValueError(f"client_chunk={fl.client_chunk} must be in "
                         f"[1, n_clients] and divide n_clients="
                         f"{fl.n_clients}")


def make_fl_step(fl: FLConfig, unravel: Callable, loss_fn: Callable, d: int,
                 device: DeviceLike = None,
                 kernel_mode: Optional[str] = None) -> Callable:
    """Build the one-round function

        fl_round(w, g_prev, age, sel_count, xs, ys, residual, tstate, draws,
                 cstate=None, fstate=None)
          -> (w', g_t, age', sel_count', residual', sel_mask, tstate',
              cstate', metrics[, fstate'])

    ``loss_fn(params, x, y) -> scalar`` is the per-client loss on a
    parameter tree; ``xs``/``ys`` are (N, H, B, ...) tensors; ``draws``
    is one round of ``draw_round``; ``cstate`` is the controller state
    (``controller.init_controller_state``), needed with ``fl.adaptive``
    and passed through otherwise.  With ``fl.stateful`` (faults, a
    population, the wireless channel or the watchdog) the round takes the
    carried ``fstate`` (``init_fault_state``) and returns it as a 10th
    output.  ``kernel_mode`` goes to every kernel dispatcher
    (``kernels.ops``).

    ``fl_round.server_phase(w, agg, ef_sum, g_prev, age, sel_count,
    residual, tstate, draws, idx=None, cstate=None, k_scale=None)`` is
    the round after the superposition, for feeding it an aggregate
    computed elsewhere: on the exact route ``agg`` is the (k,) row at the
    selection ``idx`` (selected anew from ``(g_prev, age)`` and the split
    when None), on the dense route the (d,) aggregate (or the one-bit
    vote energy), and the dense route's also takes ``erase=`` and
    ``sanitize=`` for the engine; ``k_scale`` multiplies the split (the
    watchdog's cooldown)."""
    validate(fl)
    adaptive = fl.adaptive
    dev = resolve_device(device)
    set_numerics(dev)
    n, big_h, lr = fl.n_clients, fl.local_steps, fl.local_lr
    chunk = fl.client_chunk if fl.client_chunk is not None else n
    k, k_m, r = fl.budgets(d)
    exact = fl.backend == "exact"
    packed = fl.backend == "packed"
    age_lag = fl.async_lag or None
    chaos, scen, wdcfg = fl.chaos, fl.scenario, fl.watchdog
    pop, wl = fl.population is not None, fl.wireless is not None
    # the dense route: every client superposed over all d coordinates, one
    # select_and_merge on the aggregate (threshold, packed, and the exact
    # backend under a scenario); the exact route gathers at S_t first
    dense = not exact or scen
    policy_name = "fairk" if fl.policy == "fairk_auto" else fl.policy
    engine = SelectionEngine(
        EngineConfig(policy=policy_name, backend=fl.backend, k=k, k_m=k_m,
                     r=r,
                     # the exact route adds the channel noise to the (k,)
                     # aggregate, the one-bit uplink to the vote energy:
                     # engine noise on the dense coherent route only
                     noise_std=(fl.channel.noise_std
                                if dense and not fl.one_bit else 0.0),
                     n_clients=n, kernel_mode=kernel_mode,
                     # counts and histograms on every dense route (the
                     # exact engine's come from the plain helper)
                     fused_stats=dense, warm_start=packed), d,
        # the flat (d,) server vector: the one-leaf layout, no pads
        layout=(packing.PackedLayout.from_tree(
            torch.empty(d, device="meta"), lane=1) if packed else None))
    frac_static = k_m / k if k else 0.0
    # fault channels, churn and truncation outage block refreshes
    # independently per round: their thinning rates add
    thin_total = min(0.99, (fl.faults.thin if chaos else 0.0)
                     + (fl.population.thin if pop else 0.0)
                     + (fl.wireless.thin if wl else 0.0))
    bctrl = (budget.BudgetController(fl.controller,
                                     rho=fl.compression_ratio,
                                     age_offset=float(fl.async_lag),
                                     thin=thin_total)
             if adaptive else None)
    # client-side error feedback: the exact route (both uplinks) and every
    # one-bit round; the dense coherent round folds the residual into the
    # server pass instead
    client_ef = fl.error_feedback and (not dense or fl.one_bit)

    def flat_loss(w_flat: Tensor, x: Tensor, y: Tensor) -> Tensor:
        return loss_fn(unravel(w_flat), x, y)

    batched_grad = torch.func.vmap(torch.func.grad(flat_loss))

    def clients(w: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
        """H local SGD steps for a chunk of clients -> their accumulated
        gradients (Eq. 5), (chunk, d)."""
        w_c = w.unsqueeze(0).expand(xs.shape[0], -1)
        for s in range(big_h):
            w_c = w_c - lr * batched_grad(w_c, xs[:, s], ys[:, s])
        return (w.unsqueeze(0) - w_c) / lr

    def clients_fold(w, xs, ys, residual, row, idx=None):
        """Stream the clients chunk by chunk -> ``(acc, ef_sum)``.  Each
        chunk's gradients (EF-shifted by the residual under client-side
        EF) are gathered at ``idx`` (exact route) before they are reduced:
        the weighted sum ``Σ_n row_n ǧ_n`` on the coherent uplink (``row``
        the fading, or the scenario's gate row), the vote energy on the
        one-bit uplink (``ops.vote_fold``, ``row`` the optional per-client
        vote weight).  ``ef_sum`` is ``Σ_n (ǧ_n + residual)`` under
        client-side EF, else None."""
        acc = torch.zeros(d if idx is None else idx.shape[0],
                          dtype=torch.float32, device=dev)
        ef_sum = (torch.zeros(d, dtype=torch.float32, device=dev)
                  if client_ef else None)
        for c0 in range(0, n, chunk):
            g = clients(w, xs[c0:c0 + chunk], ys[c0:c0 + chunk])
            eff = g + residual.unsqueeze(0) if client_ef else g
            rc = None if row is None else row[c0:c0 + chunk]
            if fl.one_bit:
                # quantize, weight, gather at idx and add the ±1 vote
                # counts into acc: one sign_mv kernel launch
                ops.vote_fold(acc, eff, idx, mode=kernel_mode, row=rc)
            else:
                sent = eff if idx is None else eff[:, idx]
                acc = acc + rc @ sent
            if client_ef:
                ef_sum = ef_sum + eff.sum(dim=0)
        return acc, ef_sum

    def round_kmf(cstate, k_scale):
        """The round's split: the controller's live value (adaptive), the
        static split under the watchdog's cooldown scale, or None."""
        kmf = None
        if adaptive:
            if cstate is None:
                raise ValueError("an adaptive round needs the controller "
                                 "state cstate")
            kmf = cstate["k_m_frac"]
        if k_scale is not None:
            kmf = (kmf if kmf is not None else torch.full(
                (), frac_static, dtype=torch.float32, device=dev)) * k_scale
        return kmf

    def tail(w, g_t, age_next, sel_mask, sel_count, residual, tstate,
             n_selected, cstate, kmf):
        """The model step (Eq. 9) and the metrics; ``sel_count`` is the
        updated participation count, ``kmf`` this round's split."""
        w_next = w - fl.global_lr * g_t                          # Eq. (9)
        metrics = {"mean_aou": age_next.mean(), "max_aou": age_next.max(),
                   "km_frac": (kmf if kmf is not None else
                               torch.full((), frac_static, device=dev)),
                   "n_selected": n_selected}
        return (w_next, g_t, age_next, sel_count, residual, sel_mask,
                tstate, cstate, metrics)

    def exact_select(g_prev, age, draws, kmf):
        """S_t (Eq. 11) on ``(g_prev, age)``: the index form, or the rank
        form at a traced split."""
        if kmf is not None:
            return engine.select_traced(g_prev, age, kmf)
        return engine.select(g_prev, age, draws.get("u"))

    def exact_server_phase(w, agg, ef_sum, g_prev, age, sel_count,
                           residual, tstate, draws, idx=None, cstate=None,
                           k_scale=None):
        """The receiver tail on the (k,) row, the Eq. 8 scatter, the EF
        residual, the index-form Eq. 10 and the participation count (one
        ``aou_merge`` launch, which on the coherent uplink also applies
        Eq. 7's tail), the controller step, then the model step."""
        kmf = round_kmf(cstate, k_scale)
        if idx is None:
            idx = exact_select(g_prev, age, draws, kmf)
        if fl.one_bit:
            row = quantize.fsk_majority_from_energy(
                agg, draws.get("z"), fl.channel.noise_std, mode=kernel_mode)
        else:
            row = agg                    # the kernel applies Eq. (7)'s tail
        g_t, age_next, sel_mask, sel_count, ef_res = (
            ops.aou_merge_by_indices(                    # Eqs. (8), (10)
                idx, row, g_prev, age, sel_count, n_clients=n,
                superposed=not fl.one_bit, z=draws.get("z"),
                noise_std=fl.channel.noise_std,
                ef_sum=ef_sum if fl.error_feedback else None,
                mode=kernel_mode))
        if fl.error_feedback:
            residual = ef_res
        if age_lag:
            # async: the refreshed coordinates' contribution lands age_lag
            # rounds late (one elementwise pass after the launch)
            age_next = packing.shift_selected_age(age_next, age_lag)
        if adaptive:
            # no kernel emits statistics on the exact round: the age
            # histogram comes from the plain helper (no magnitude one)
            _, age_hist = ref.strided_hists_ref(
                g_t, age_next, age >= 0.0, packing.hist_stride(d))
            cstate = bctrl.update(cstate, age_hist)
        return tail(w, g_t, age_next, sel_mask, sel_count, residual,
                    tstate, torch.full((), float(k), device=dev), cstate,
                    kmf)

    def dense_server_phase(w, agg, ef_sum, g_prev, age, sel_count,
                           residual, tstate, draws, idx=None, cstate=None,
                           k_scale=None, erase=None, sanitize=False):
        """One-bit detection, then one ``select_and_merge`` on the whole
        aggregate (the fused FAIR-k pass on threshold and packed, which
        selects: no ``idx``; the sanitized rank form and the mask-form
        ``aou_merge`` on exact), the EF residual, the controller step and
        the model step (only the packed backend reads and returns the
        carried ``tstate``)."""
        kmf = round_kmf(cstate, k_scale)
        ts = tstate if packed else None
        if fl.one_bit:
            # one sign_from_energy launch: the noise noise_std·z, the
            # signs and the score |energy| + index jitter (noiseless
            # energies tie at even integers; the sub-unit jitter breaks
            # the ties, levels sit 2 apart)
            fresh_sign, _, score = ops.sign_from_energy(
                agg, z=draws.get("z"), noise_std=fl.channel.noise_std,
                score=True, mode=kernel_mode)
            g_t, age_next, stats = engine.select_and_merge(
                score, g_prev, age, fresh=fresh_sign, tstate=ts,
                k_m_frac=kmf, age_lag=age_lag, erase=erase,
                sanitize=sanitize)
            # async rounds shift the refreshed ages, so the engine hands
            # the selection back
            sel_mask = (stats["sel_mask"] if age_lag
                        else (age_next == 0.0).to(torch.float32))
            if fl.error_feedback:
                # unsent mass of the mean effective gradient
                residual = (ef_sum * oac.reciprocal(n)) * (1.0 - sel_mask)
        else:
            g_t, age_next, stats = engine.select_and_merge(
                agg, g_prev, age, noise=draws.get("z"), tstate=ts,
                residual=residual if fl.error_feedback else None,
                k_m_frac=kmf, age_lag=age_lag, erase=erase,
                sanitize=sanitize)
            sel_mask = (stats["sel_mask"] if age_lag
                        else (age_next == 0.0).to(torch.float32))
            if fl.error_feedback:
                residual = stats["residual"]
        if adaptive:
            # the controller reads the histograms the server pass emitted
            cstate = bctrl.update(cstate, stats["age_hist"],
                                  stats["mag_hist"])
        return tail(w, g_t, age_next, sel_mask, sel_count + sel_mask,
                    residual, stats.get("tstate", tstate),
                    stats["n_selected"], cstate, kmf)

    server_phase = dense_server_phase if dense else exact_server_phase

    def dense_round(w, g_prev, age, sel_count, xs, ys, residual, tstate,
                    draws, cstate, fstate, k_scale):
        """The dense route.  Under a scenario every per-client gate
        composes into one (N,) weight row before any gradient exists —
        wireless: ``csi · sent · (participation | availability)``
        (truncated inversion replaces the iid fading), population:
        ``h · participation``, faults: ``h · availability`` — the
        superposition rescales by the realised participation (guarded
        1/n_t), corruption hits the aggregate, churn and fade blocks erase
        (``max``), a round with no participant erases everything, and the
        engine runs sanitized.  The one-bit wireless round weights each
        client's votes by ``sent · csi`` inside the fold and erases the
        round on a total outage."""
        if scen:
            fstate = dict(fstate)
        if wl:
            cnext, cps = chan.channel_round(fstate["chan"], draws["fad"],
                                            fl.wireless)
            fstate["chan"] = cnext
            w_csi = (chan.csi_weights(draws["csi"], fl.wireless)
                     if "csi" in draws else torch.ones(n, device=dev))
        if fl.one_bit:
            agg, ef_sum = clients_fold(w, xs, ys, residual,
                                       cps["sent"] * w_csi if wl else None)
            erase = (faults.erase_with_outage(
                torch.zeros(d, dtype=torch.float32, device=dev),
                cps["n_sent"]) if wl else None)
            out = server_phase(w, agg, ef_sum, g_prev, age, sel_count,
                               residual, tstate, draws, cstate=cstate,
                               erase=erase, sanitize=wl, k_scale=k_scale)
            return out, fstate
        n_t = None
        if pop:
            pnext, ps = population.population_round(
                fstate["pop"], draws["pop"], draws["participants"],
                fl.population)
            fstate["pop"] = pnext
        elif chaos:
            avail = faults.avail_step(fstate["avail"], draws["av"],
                                      fl.faults)
            fstate["avail"] = avail
        if wl:
            gate = cps["sent"]
            if pop:
                gate = ps["part"] * gate
            elif chaos:
                gate = avail * gate
            n_t = gate.sum()
            wv = w_csi * gate
        elif pop:
            n_t = ps["n_t"]
            wv = draws["h"] * ps["part"]
        elif chaos:
            n_t = avail.sum()
            wv = draws["h"] * avail
        else:
            wv = draws["h"]
        total, ef_sum = clients_fold(w, xs, ys, residual, wv)
        # the realised-participation rescale (guarded 1/n_t) on the gated
        # rounds, the plain 1/N average otherwise
        fresh = (faults.participation_scale(total, n_t) if n_t is not None
                 else total * oac.reciprocal(n))
        erase = None
        if scen:
            if fl.faults.nan_rate > 0.0:
                fresh = faults.corrupt(fresh, draws["nz"], fl.faults)
            erase = torch.zeros(d, dtype=torch.float32, device=dev)
            if pop:
                erase = torch.maximum(erase, population.churn_erase_mask(
                    draws["er"], d, ps["churn"], fl.population))
            if fl.faults.fade > 0.0:
                erase = torch.maximum(erase, faults.fade_mask(
                    draws["fd"], d, fl.faults))
            erase = faults.erase_with_outage(erase, n_t)
        out = server_phase(w, fresh, ef_sum, g_prev, age, sel_count,
                           residual, tstate, draws, cstate=cstate,
                           erase=erase, sanitize=scen, k_scale=k_scale)
        return out, fstate

    def guard(out, fstate, xs, ys):
        """The divergence watchdog: observe this round's loss on the first
        client's first batch and ``‖g_t‖``; a trip (non-finite, or a spike
        over the EMA) rolls every carried buffer back to the shadow
        snapshot (``torch.where``: no host sync); healthy rounds out of
        cooldown refresh the snapshot.  The AoU metrics are read from the
        rolled-back ages, as the reference's are."""
        (w_next, g_t, age_next, sel_count, residual, sel_mask, tstate,
         cstate, metrics) = out
        loss = loss_fn(unravel(w_next), xs[0, 0], ys[0, 0])
        unorm = torch.linalg.vector_norm(g_t)
        wd, trip, _ = faults.watchdog_step(wdcfg, fstate["wd"], loss, unorm)
        live = (w_next, g_t, age_next, sel_count, residual, tstate, cstate)
        rolled = faults.tree_select(trip, fstate["snap"], live)
        healthy = ~trip & (wd["cooldown"] <= 0.0)
        snap = faults.tree_select(healthy, rolled, fstate["snap"])
        w_next, g_t, age_next, sel_count, residual, tstate, cstate = rolled
        metrics = {**metrics, "mean_aou": age_next.mean(),
                   "max_aou": age_next.max()}
        return ((w_next, g_t, age_next, sel_count, residual, sel_mask,
                 tstate, cstate, metrics),
                {**fstate, "wd": wd, "snap": snap})

    def fl_round(w, g_prev, age, sel_count, xs, ys, residual, tstate,
                 draws: Dict[str, Tensor], cstate=None, fstate=None):
        if fl.stateful and fstate is None:
            raise ValueError("a faults / population / wireless / watchdog "
                             "round needs the carried fstate "
                             "(init_fault_state)")
        k_scale = None
        if wdcfg is not None:
            # cooldown: the split shrinks by ``tighten`` (data, no sync)
            k_scale = torch.where(fstate["wd"]["cooldown"] > 0.0,
                                  float(np.float32(wdcfg.tighten)),
                                  1.0).to(torch.float32)
        if dense:
            out, fstate = dense_round(w, g_prev, age, sel_count, xs, ys,
                                      residual, tstate, draws, cstate,
                                      fstate, k_scale)
        else:
            # exact: S_t (Eq. 11) scores (g_prev, age), before the clients
            idx = exact_select(g_prev, age, draws,
                               round_kmf(cstate, k_scale))
            agg, ef_sum = clients_fold(w, xs, ys, residual, draws.get("h"),
                                       idx)
            out = server_phase(w, agg, ef_sum, g_prev, age, sel_count,
                               residual, tstate, draws, idx, cstate,
                               k_scale=k_scale)
        if wdcfg is not None:
            out, fstate = guard(out, fstate, xs, ys)
        return out + (fstate,) if fl.stateful else out

    fl_round.server_phase = server_phase
    return fl_round


def init_server(init_params: Any, fl: Optional[FLConfig] = None,
                device: DeviceLike = None
                ) -> Tuple[ServerState, Callable]:
    """Flat server state for a parameter tree -> (state, unravel)."""
    dev = resolve_device(device)
    params = {key: _to(v, dev) for key, v in init_params.items()}
    flat, unravel = ravel_params(params)
    d = flat.shape[0]

    def zeros():
        return torch.zeros(d, dtype=torch.float32, device=dev)

    state = ServerState(w=flat.to(torch.float32), g=zeros(), age=zeros(),
                        sel_count=zeros(), residual=zeros(),
                        theta=packing.init_threshold_state(dev),
                        ctrl=budget.init_controller_state(
                            fl.k_m_frac if fl is not None else 0.75, dev))
    return state, unravel


def _to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32, device=dev)


def draw_round(gen: torch.Generator, fl: FLConfig, d: int,
               device: torch.device) -> Dict[str, Tensor]:
    """One round's random numbers from ``gen``, in the order of the
    reference's named keys (``sel``, ``ch``, ``av``, ``fd``, ``nz``,
    ``pop``, ``er``, ``fad``, ``csi``): ``h`` (N,) fading on the coherent
    uplink (not on a wireless round); ``z`` standard-normal channel noise,
    (d,) on the dense route and (k,) on the exact one; on the exact route
    ``u`` (d,) uniform for ``toprand`` / ``randk``.  Faults: ``av`` (N,)
    uniforms of the availability chain, ``fd`` (⌈d/fade_block⌉,) fade
    uniforms, ``nz`` (d,) corruption uniforms; population: ``pop``
    (n_virtual,) uniforms and ``participants`` (N,) int64 cohort ids, ``er``
    (⌈d/erase_block⌉,) churn uniforms; wireless: ``fad`` (N, 2) standard
    normals of the fading step, ``csi`` (N,) of the CSI error.  Only the
    draws the configuration uses are made."""
    n = fl.n_clients
    dense = fl.backend != "exact" or fl.scenario
    pop, wl, fc = fl.population, fl.wireless, fl.faults

    def uniform(*shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    draws = {}
    if not fl.one_bit and wl is None:
        draws["h"] = oac.sample_fading(gen, n, fl.channel, device)
    draws["z"] = normal(d if dense else fl.budgets(d)[0])
    if not dense and fl.policy in selection.RANDOM_POLICIES:
        draws["u"] = uniform(d)
    if fl.chaos and pop is None:
        draws["av"] = uniform(n)
    if fc.fade > 0.0:
        draws["fd"] = uniform(-(-d // fc.fade_block))
    if fc.nan_rate > 0.0:
        draws["nz"] = uniform(d)
    if pop is not None:
        draws["pop"], draws["participants"] = population.draw_round(
            gen, pop, device)
        draws["er"] = uniform(-(-d // pop.erase_block))
    if wl is not None:
        draws["fad"] = normal(n, 2)
        if wl.csi_err > 0.0:
            draws["csi"] = normal(n)
    return draws


def init_fault_state(fl: FLConfig, state: ServerState) -> Dict[str, Any]:
    """The carried scenario state of a ``fl.stateful`` round: ``avail``
    the Gilbert–Elliott availability (N,), ``pop`` the virtual
    population, ``chan`` the per-client fading chain (a stationary draw),
    ``wd`` the watchdog's EMAs and ``snap`` its shadow snapshot (copies of
    w, g, age, sel_count, residual, theta, ctrl).  The initial draws come
    from a generator on the state's device seeded ``fl.seed + 0x5EED``."""
    dev = state.w.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(fl.seed + 0x5EED)

    def get(fn, *shape):
        return fn(shape, generator=gen, dtype=torch.float32, device=dev)

    fstate: Dict[str, Any] = {}
    if fl.chaos:
        fstate["avail"] = (faults.init_avail_state(
            get(torch.rand, fl.n_clients), fl.faults)
            if fl.faults.dropout > 0.0 else
            torch.ones(fl.n_clients, dtype=torch.float32, device=dev))
    if fl.population is not None:
        fstate["pop"] = population.init_population_state(
            get(torch.rand, fl.population.n_clients), fl.population)
    if fl.wireless is not None:
        fstate["chan"] = chan.init_channel_state(
            get(torch.randn, fl.n_clients, 2), fl.wireless)
    if fl.watchdog is not None:
        fstate["wd"] = faults.init_watchdog_state(dev)
        fstate["snap"] = tuple(
            None if x is None else
            ({key: v.clone() for key, v in x.items()} if isinstance(x, dict)
             else x.clone())
            for x in (state.w, state.g, state.age, state.sel_count,
                      state.residual, state.theta, state.ctrl))
    return fstate


def train(fl: FLConfig, init_params: Any, loss_fn: Callable,
          sample_round: Callable[[int], Tuple[np.ndarray, np.ndarray]],
          eval_fn: Optional[Callable] = None, eval_every: int = 20,
          verbose: bool = False, device: DeviceLike = None,
          kernel_mode: Optional[str] = None) -> Dict[str, Any]:
    """Run ``fl.rounds`` communication rounds.

    ``loss_fn(params, x, y) -> scalar``; ``sample_round(t) -> (xs, ys)``
    numpy client batches (N, H, B, ...); ``eval_fn(params) -> dict`` of
    metrics (e.g. ``acc``, ``loss``).  Returns a history dict: the eval
    curve, per-round mean/max AoU, ``km_frac``, ``n_selected`` and
    ``round_ms`` (CUDA events on the card, the host clock on the CPU),
    the final parameters, the final ``ServerState`` and ``fstate`` (None
    unless ``fl.stateful``), and with the watchdog ``wd_trips``."""
    dev = resolve_device(device)
    state, unravel = init_server(init_params, fl, dev)
    d = state.w.shape[0]
    fl_step = make_fl_step(fl, unravel, loss_fn, d, dev, kernel_mode)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fl.seed)
    fstate = init_fault_state(fl, state) if fl.stateful else None
    history: Dict[str, Any] = {"round": [], "acc": [], "loss": [],
                               "k": fl.budgets(d)[0], "d": d}
    w, g, age, sel_count = state.w, state.g, state.age, state.sel_count
    residual, tstate, cstate = state.residual, state.theta, state.ctrl
    per_round = {"mean_aou": [], "max_aou": [], "km_frac": [],
                 "n_selected": []}
    cuda = dev.type == "cuda"
    marks = []

    def mark():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    def is_eval(t: int) -> bool:
        return eval_fn is not None and ((t + 1) % eval_every == 0 or t == 0
                                        or t == fl.rounds - 1)

    def stage(t0: int, n: int) -> Tuple[Tensor, Tensor]:
        """Rounds t0 .. t0+n-1's client batches, in ``sample_round`` order,
        in one (pinned, on the card) host buffer pair sent in one copy
        each."""
        bx, by = (np.asarray(a) for a in sample_round(t0))
        xs_h = torch.empty((n,) + bx.shape, pin_memory=cuda,
                           dtype=torch.from_numpy(bx).dtype)
        ys_h = torch.empty((n,) + by.shape, pin_memory=cuda,
                           dtype=torch.from_numpy(by).dtype)
        xs_h[0], ys_h[0] = torch.from_numpy(bx), torch.from_numpy(by)
        for i in range(1, n):
            bx, by = sample_round(t0 + i)
            xs_h[i] = torch.from_numpy(np.asarray(bx))
            ys_h[i] = torch.from_numpy(np.asarray(by))
        return (xs_h.to(dev, non_blocking=True),
                ys_h.to(dev, non_blocking=True))

    t = 0
    while t < fl.rounds:
        if fl.scan_rounds > 1:
            # a chunk ends at the next eval round (eval reads w)
            stop = next((u + 1 for u in range(t, fl.rounds) if is_eval(u)),
                        fl.rounds)
            n_chunk = min(fl.scan_rounds, stop - t)
            batches = list(zip(*stage(t, n_chunk)))
        else:
            xs, ys = sample_round(t)
            batches = [(torch.as_tensor(np.asarray(xs), device=dev),
                        torch.as_tensor(np.asarray(ys), device=dev))]
        for xs, ys in batches:
            draws = draw_round(gen, fl, d, dev)
            mark()
            out = fl_step(w, g, age, sel_count, xs, ys, residual, tstate,
                          draws, cstate, fstate)
            mark()
            (w, g, age, sel_count, residual, _, tstate, cstate,
             rm) = out[:9]
            if fl.stateful:
                fstate = out[9]
            for key in per_round:
                per_round[key].append(rm[key])
            if is_eval(t):
                metrics = eval_fn(unravel(w))
                history["round"].append(t + 1)
                history["acc"].append(float(metrics.get("acc", np.nan)))
                history["loss"].append(float(metrics.get("loss", np.nan)))
                if verbose:
                    print(f"  round {t+1:4d}  acc={history['acc'][-1]:.4f}"
                          f"  meanAoU={float(rm['mean_aou']):.2f}",
                          flush=True)
            t += 1
    if cuda:
        torch.cuda.synchronize(dev)
        history["round_ms"] = [marks[i].elapsed_time(marks[i + 1])
                               for i in range(0, len(marks), 2)]
    else:
        history["round_ms"] = [1e3 * (marks[i + 1] - marks[i])
                               for i in range(0, len(marks), 2)]
    for key, vals in per_round.items():
        history[key] = (torch.stack([v.reshape(()) for v in vals])
                        .cpu().tolist() if vals else [])
    history["sel_count"] = sel_count.cpu().numpy()
    history["final_age"] = age.cpu().numpy()
    history["params"] = unravel(w)
    history["state"] = ServerState(w=w, g=g, age=age, sel_count=sel_count,
                                   residual=residual, theta=tstate,
                                   ctrl=cstate, round=fl.rounds)
    history["fstate"] = fstate
    if fl.watchdog is not None:
        history["wd_trips"] = float(fstate["wd"]["trips"])
    return history
