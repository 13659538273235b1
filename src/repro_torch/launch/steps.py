"""The launch path's train step on one card (``repro.launch.steps``).

``make_train_step(cfg, shape, ...)`` returns a ``StepBundle`` whose ``fn``
runs one step of the production trainer: the transformer LM's local
gradients, accumulated over microbatches (``client_chunk`` streams them
chunk by chunk), then the FAIR-k OAC server phase, then the optimizer.
The default server phase is the persisted packed one: the parameter tree
packed into ONE flat buffer (``core.packing.PackedLayout``), one fused
``fairk_update`` pass against the flat carried state (bf16 ``g``, int8
``age`` with ``PAD_AGE`` in the pads, the float32 ``theta`` vector, and
as configured the EF residual ``res``, the controller vector ``ctrl``, the
async ``shadow`` / ``pending`` buffers and the wireless chain ``fad``),
with ``one_bit`` one ``sign_mv`` launch for the detection, then one
unpack for the optimizer.  ``OacServerConfig(packed=False)`` runs the
historical per-leaf loop (one threshold engine per leaf).

``make_prefill_step`` and ``make_serve_step`` return the serving path's
bundles: ``fn(params, caches, batch)`` fills the caches from a prompt and
``fn(params, caches, token, pos)`` decodes one token, both updating the
caches in place (``models.transformer.prefill`` / ``decode_step``).

One card is one shard: the reference's ``shard_map``, the mesh and the
data-axis reduction are gone, and ``n_clients`` is 1.  The reference's
``sequence_parallel`` flag is a sharding hint with no effect on one card,
and so is the expert axis it pins MoE tensors to; both are left out until
the mesh is ported (ROADMAP item 11d), and so is ``make_fl_oac_step``.

The step updates ``params``, ``opt_state`` and ``server`` in place under
``torch.no_grad()`` (the reference donates them), so a full-width model
holds one copy of its optimizer state.  Random draws come in as tensors:
``server_draws(oac, seed, ...)`` makes them from named streams, a
``torch.Generator`` per ``(seed, tag)`` — the tags of the reference's
fold-ins (``0xC4A`` the fading chain, ``0xC51`` the CSI factor,
``0xFADE`` the fades, ``0x509`` the churn, the population's base seed
``0x509``) — and ``fn(..., draws=...)`` takes any of them from the
caller instead (the tests hand over the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import channel as chan
from repro_torch.core import controller as budget
from repro_torch.core import faults, packing
from repro_torch.core import population as pop_mod
from repro_torch.core.engine import (EngineConfig, SelectionEngine,
                                     index_jitter, sampled_thresholds)
from repro_torch.core.oac import reciprocal
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr
from repro_torch.optim import make_optimizer

Tensor = torch.Tensor

# named draw streams of a step (the reference's fold-in tags)
TAG_NOISE = 0
TAG_FADING = 0xC4A
TAG_CSI = 0xC51
TAG_FADE = 0xFADE
TAG_CHURN = 0x509
TAG_LEAF = 0x1EAF
POPULATION_SEED = 0x509


@dataclasses.dataclass(frozen=True)
class OacServerConfig:
    """FAIR-k server-side compression settings for the big-model trainer
    (fields and defaults of ``repro.launch.steps.OacServerConfig``)."""
    rho: float = 0.1               # selection budget k/d
    k_m_frac: float = 0.75         # magnitude share of the budget
    noise_std: float = 0.0         # channel noise sigma_z
    n_clients: int = 16            # N in Eq. (7) (= data shards: 1 here)
    sample_cap: int = 65536        # quantile sample size
    packed: bool = True            # one fused pass over the packed tree
    warm_start: bool = True        # carry (θ_M, θ_A) across rounds
    fused_stats: bool = True       # counts and histograms from the kernel
    error_feedback: bool = False   # persisted flat EF residual
    adaptive_km: bool = False      # in-step budget controller
    async_agg: bool = False        # double-buffered rounds
    straggler_frac: float = 0.25   # coordinates delivered one round late
    straggler_lag: int = 1         # their delivery lag (rounds)
    sanitize: bool = False         # non-finite coordinates are unsent
    fade: float = 0.0              # per-block deep-fade erasure rate
    fade_block: int = 128          # coordinates per fade block
    one_bit: bool = False          # merge sign_mv-detected signs
    population: Optional[pop_mod.PopulationConfig] = None
    wireless: Optional[chan.ChannelConfig] = None


@dataclasses.dataclass
class StepBundle:
    """One step builder's product.  For a train step ``fn(params,
    opt_state, server, batch, seed, draws=None) -> (params, opt_state,
    server, loss)`` is the whole step (in place); ``grads_fn(params, batch)
    -> (loss, grads)`` its local-gradient part and ``update(params,
    opt_state, server, grads, seed, draws=None)`` its server and optimizer
    part (in place); ``layout`` the packed layout (None per leaf).  A
    serving bundle has only ``fn`` and ``meta``."""
    fn: Callable
    meta: Dict[str, Any]
    grads_fn: Optional[Callable] = None
    update: Optional[Callable] = None
    layout: Optional[packing.PackedLayout] = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _batch_parts(shape: InputShape, n_micro: Optional[int]
                 ) -> Tuple[int, int, int]:
    n_shards = 1
    gb = shape.global_batch
    if n_micro is None:
        n_micro = max(1, gb // n_shards)
    if gb % n_micro:
        raise ValueError(f"global batch {gb} not divisible by n_micro "
                         f"{n_micro}")
    return n_micro, gb // n_micro, n_shards


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    return seq_len - cfg.n_patches if cfg.family == "vlm" else seq_len


def train_input_specs(cfg: ModelConfig, shape: InputShape, n_micro: int,
                      mb: int) -> Dict[str, Tensor]:
    """The train step's batch as ``meta`` tensors: ``tokens`` and
    ``labels`` (n_micro, mb, text length) int32, a VLM's ``embeds`` and an
    encoder-decoder's ``frames`` in the compute dtype."""
    s_text = _text_len(cfg, shape.seq_len)
    cdt = getattr(torch, cfg.compute_dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")
    specs = {"tokens": meta((n_micro, mb, s_text), torch.int32),
             "labels": meta((n_micro, mb, s_text), torch.int32)}
    if cfg.family == "vlm":
        specs["embeds"] = meta((n_micro, mb, cfg.n_patches, cfg.d_model),
                               cdt)
    if cfg.family == "audio":
        specs["frames"] = meta((n_micro, mb, cfg.encoder_seq, cfg.d_model),
                               cdt)
    return specs


def server_layout(params: Any) -> packing.PackedLayout:
    """The packed layout of the persisted server state (one shard: the
    whole tree)."""
    return packing.PackedLayout.from_tree(params)


def fairk_threshold_masks(g_flat: Tensor, age_flat: Tensor,
                          oac: OacServerConfig, sample_cap: int
                          ) -> Tuple[Tensor, Tensor]:
    """Sampled-quantile FAIR-k masks, float32 ``(selected, magnitude
    stage)``: ``|g| >= θ_M``, else ``age + jitter >= θ_A``."""
    theta_m, theta_a = sampled_thresholds(
        g_flat, age_flat, rho=oac.rho, k_m_frac=oac.k_m_frac,
        sample_cap=sample_cap)
    jit = index_jitter(g_flat.shape[0], device=g_flat.device)
    mask_m = g_flat.to(torch.float32).abs() >= theta_m
    mask_a = (age_flat.to(torch.float32) + jit >= theta_a) & ~mask_m
    return ((mask_m | mask_a).to(torch.float32),
            mask_m.to(torch.float32))


def _leaf_engine(oac: OacServerConfig, n: int, kernel_mode=None
                 ) -> SelectionEngine:
    """Threshold-backend engine for one parameter leaf of ``n`` elements."""
    return SelectionEngine(
        EngineConfig(policy="fairk", backend="threshold", rho=oac.rho,
                     k_m_frac=oac.k_m_frac, sample_cap=oac.sample_cap,
                     noise_std=oac.noise_std, n_clients=oac.n_clients,
                     kernel_mode=kernel_mode), n)


def _leaf_server_update(g: Tensor, g_prev: Tensor, age: Tensor,
                        noise: Optional[Tensor], oac: OacServerConfig,
                        eng: Optional[SelectionEngine] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-leaf FAIR-k server phase -> (g_t, new g_prev in its dtype, new
    age int8); ``noise`` is the leaf's standard-normal draw."""
    shape = g.shape
    gf = g.reshape(-1)
    eng = eng or _leaf_engine(oac, gf.shape[0])
    g_t, age_next, _ = eng.select_and_merge(
        gf, g_prev.reshape(-1), age.reshape(-1),
        noise=noise.reshape(-1) if oac.noise_std > 0.0 else None)
    return (g_t.reshape(shape), g_t.to(g_prev.dtype).reshape(shape),
            age_next.to(torch.int8).reshape(shape))


def init_server_state(params: Any,
                      oac: Optional[OacServerConfig] = OacServerConfig()
                      ) -> Dict[str, Any]:
    """The server state ``make_train_step`` expects, on the parameters'
    device.  Packed (the default): flat ``g`` (d,) bf16, ``age`` (d,) int8
    with ``PAD_AGE`` in the pads and the ``theta`` vector, plus ``res``,
    ``ctrl``, ``shadow`` / ``pending`` and ``fad`` as configured.  Per
    leaf (``oac`` None or ``packed=False``): trees of bf16 ``g`` and int8
    ``age``, and ``theta``."""
    dev = tree_util.leaves(params)[0][1].device
    theta = torch.zeros(packing.THRESHOLD_STATE_SIZE, dtype=torch.float32,
                        device=dev)
    if oac is None or not oac.packed:
        return {"g": tree_util.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=dev), params),
                "age": tree_util.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.int8,
                                          device=dev), params),
                "theta": theta}
    lay = server_layout(params)
    d = lay.d_packed
    state = {"g": torch.zeros(d, dtype=torch.bfloat16, device=dev),
             "age": lay.init_age(torch.int8, dev), "theta": theta}
    if oac.error_feedback:
        state["res"] = torch.zeros(d, dtype=torch.float32, device=dev)
    if oac.adaptive_km:
        state["ctrl"] = budget.controller_state_to_vec(
            budget.init_controller_state(oac.k_m_frac, dev))
    if oac.async_agg:
        state["shadow"] = torch.zeros(d, dtype=torch.bfloat16, device=dev)
        state["pending"] = torch.zeros(d, dtype=torch.bfloat16, device=dev)
    if oac.wireless is not None:
        state["fad"] = chan.init_block_fading(chan.n_blocks(d, oac.wireless),
                                              dev)
    return state


def state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A tree of numpy arrays (the reference's params, optimizer state or
    server state through ``np.asarray``) -> the same tree of tensors on
    ``device``.  A bfloat16 leaf arrives as its ``uint16`` view (or a
    numpy ``bfloat16`` extension array) and becomes a bf16 tensor; other
    dtypes are kept."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
            words = np.ascontiguousarray(a).view(np.int16).copy()
            return torch.from_numpy(words).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)
    return tree_util.tree_map(leaf, tree)


def _stream(seed: int, tag: int, device, index: int = 0) -> torch.Generator:
    """The named draw stream ``(seed, tag, index)`` on ``device``."""
    return pop_mod.round_generator(seed, tag, index, device)


def server_draws(oac: OacServerConfig, seed: int, layout, device
                 ) -> Dict[str, Any]:
    """The packed server phase's draws for step ``seed``: ``noise`` (d,)
    standard normals (the channel noise; with ``one_bit`` the vote noise),
    ``fad_w`` (nb, 2) and ``csi`` (nb,) normals of the wireless round,
    ``fade_u`` and ``churn_u`` block uniforms, and ``pop`` the stateless
    population round's statistics — each as the configuration needs it."""
    d = layout.d_packed
    wireless = oac.wireless
    draws: Dict[str, Any] = {}
    if oac.noise_std > 0.0:
        draws["noise"] = torch.randn(
            d, generator=_stream(seed, TAG_NOISE, device),
            device=device)
    if wireless is not None:
        nb = chan.n_blocks(d, wireless)
        draws["fad_w"] = torch.randn(
            nb, 2, generator=_stream(seed, TAG_FADING, device),
            device=device)
        if wireless.csi_err > 0.0:
            draws["csi"] = torch.randn(
                nb, generator=_stream(seed, TAG_CSI, device),
                device=device)
    if oac.fade > 0.0:
        draws["fade_u"] = torch.rand(
            -(-d // oac.fade_block),
            generator=_stream(seed, TAG_FADE, device), device=device)
    if oac.population is not None:
        pc = oac.population
        draws["pop"] = pop_mod.stateless_round(POPULATION_SEED, int(seed),
                                               pc, device)
        draws["churn_u"] = torch.rand(
            -(-d // pc.erase_block),
            generator=_stream(seed, TAG_CHURN, device), device=device)
    return draws


def leaf_draws(oac: OacServerConfig, seed: int, params: Any, device
               ) -> Dict[str, Any]:
    """The per-leaf server phase's draws: ``leaf_noise``, one (size,)
    standard-normal vector per leaf in flattening order."""
    if oac.noise_std <= 0.0:
        return {}
    return {"leaf_noise": [
        torch.randn(leaf.numel(), generator=_stream(seed, TAG_LEAF, device,
                                                      i), device=device)
        for i, (_, leaf) in enumerate(tree_util.leaves(params))]}


def _check_oac(oac: Optional[OacServerConfig]) -> None:
    """The reference's argument checks (``make_train_step``)."""
    if oac is None:
        return
    if oac.error_feedback and not oac.packed:
        raise ValueError("error_feedback needs the packed server phase "
                         "(the residual is a flat persisted buffer)")
    if oac.one_bit and not oac.packed:
        raise ValueError("one_bit needs the packed server phase (the sign "
                         "vector is detected on the flat packed buffer)")
    if oac.adaptive_km and not (oac.packed and oac.fused_stats):
        raise ValueError("adaptive_km consumes the kernel-emitted age/"
                         "magnitude histograms — it needs the packed "
                         "server phase with fused_stats")
    if oac.sanitize and not oac.packed:
        raise ValueError("sanitize rides the fused kernel's masking stage "
                         "— it needs the packed server phase")
    if oac.fade > 0.0 and not oac.sanitize:
        raise ValueError("fade erasures degrade through the sanitize "
                         "path — set OacServerConfig(sanitize=True)")
    if oac.async_agg:
        if not oac.packed:
            raise ValueError("async_agg double-buffers the PACKED server "
                             "state (flat shadow/pending buffers) — it "
                             "needs the packed server phase")
        if not 0.0 <= oac.straggler_frac <= 1.0:
            raise ValueError(f"straggler_frac must be in [0, 1], got "
                             f"{oac.straggler_frac}")
        if oac.straggler_lag < 1:
            raise ValueError(f"straggler_lag must be >= 1, got "
                             f"{oac.straggler_lag}")
    if oac.population is not None:
        if not (oac.packed and oac.sanitize):
            raise ValueError("population churn erasures degrade through "
                             "the fused kernel's sanitize path — set "
                             "OacServerConfig(packed=True, sanitize=True)")
        if oac.one_bit:
            raise ValueError("population churn on the one-bit uplink is "
                             "not modelled — run population with "
                             "one_bit=False")
        if oac.population.mode == "ge":
            raise ValueError("the launch population is stateless (iid | "
                             "diurnal — recomputed per round from the "
                             "seed); Gilbert–Elliott bursts carry chain "
                             "state and run in the FL sim trainer only")
        if oac.population.slow_frac > 0.0 and not oac.async_agg:
            raise ValueError("population stragglers land through the "
                             "async shadow buffer — slow_frac > 0 needs "
                             "OacServerConfig(async_agg=True)")
    if oac.wireless is not None and not (oac.packed and oac.sanitize):
        raise ValueError("wireless truncation outages degrade through "
                         "the fused kernel's sanitize path on the "
                         "packed buffers — set "
                         "OacServerConfig(packed=True, sanitize=True)")


def _meta(cfg, shape, oac, n_micro, mb, client_chunk, opt_name, lr,
          gather_dtype) -> Dict[str, Any]:
    on = oac is not None
    return {
        "kind": "train", "n_micro": n_micro, "micro_batch": mb,
        "client_chunk": client_chunk,
        "seq_len": shape.seq_len, "oac": on,
        "oac_packed": bool(oac.packed) if on else False,
        "oac_warm_start": bool(oac.warm_start) if on else False,
        "oac_ef": bool(oac.error_feedback) if on else False,
        "oac_fused_stats": bool(oac.fused_stats) if on else False,
        "oac_one_bit": bool(oac.one_bit) if on else False,
        "oac_adaptive_km": bool(oac.adaptive_km) if on else False,
        "oac_async": bool(oac.async_agg) if on else False,
        "oac_sanitize": bool(oac.sanitize) if on else False,
        "oac_fade": float(oac.fade) if on else 0.0,
        "oac_population": (oac.population.n_clients
                           if on and oac.population is not None else 0),
        "oac_wireless": bool(oac.wireless is not None) if on else False,
        "optimizer": opt_name or cfg.optimizer, "lr": lr,
        "gather_dtype": gather_dtype,
        "scans": {"microbatch": n_micro, "layers": cfg.n_scan_blocks},
    }


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, shape: InputShape, *,
                    n_micro: Optional[int] = None,
                    client_chunk: Optional[int] = None,
                    oac: Optional[OacServerConfig] = OacServerConfig(),
                    opt_name: Optional[str] = None, lr=1e-3,
                    gather_dtype: Optional[str] = None,
                    kernel_mode: Optional[str] = None,
                    device: DeviceLike = None) -> StepBundle:
    """The train step of ``cfg`` at ``shape`` on ``device`` (the card
    unless asked otherwise), with the reference's argument checks and
    ``meta`` keys.  ``kernel_mode`` ("plain") runs the server phase on the
    kernels' plain versions."""
    dev = resolve_device(device)
    n_micro, mb, n_shards = _batch_parts(shape, n_micro)
    if client_chunk is not None and (
            client_chunk < 1 or n_micro % client_chunk):
        raise ValueError(
            f"client_chunk must divide n_micro ({n_micro}), got "
            f"{client_chunk}")
    opt = make_optimizer(opt_name or cfg.optimizer, lr)
    _check_oac(oac)
    meta = _meta(cfg, shape, oac, n_micro, mb, client_chunk, opt_name, lr,
                 gather_dtype)
    gdt = getattr(torch, gather_dtype) if gather_dtype else None
    inv_micro = reciprocal(n_micro)

    def grads_fn(params, batch):
        """Mean loss and gradients over the microbatches (float32
        accumulators; a chunk's gradients are summed before they join)."""
        leaves = tree_util.leaves(params)
        paths = [pa for pa, _ in leaves]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for _, p in leaves]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        chunk = client_chunk or 1
        for c0 in range(0, n_micro, chunk):
            loss_c, g_c = None, None
            for i in range(c0, c0 + chunk):
                mbatch = {k: v[i] for k, v in batch.items()}
                with torch.enable_grad():
                    xs = [(p.detach().to(gdt) if gdt is not None
                           and p.dim() > 1 else p.detach())
                          .requires_grad_(True) for _, p in leaves]
                    loss, _ = tr.loss_fn(tree_util.unflatten(paths, xs),
                                         cfg, mbatch)
                    gs = torch.autograd.grad(loss, xs,
                                             materialize_grads=True)
                gs = [g.to(torch.float32) for g in gs]
                loss = loss.detach()
                if loss_c is None:
                    loss_c, g_c = loss, gs
                else:
                    loss_c = loss_c + loss
                    g_c = [a + b for a, b in zip(g_c, gs)]
                del gs
            loss_acc = loss_acc + loss_c
            for a, g in zip(acc, g_c):
                a.add_(g)
            del g_c
        loss = loss_acc * inv_micro
        grads = [(a.mul_(inv_micro)).to(p.dtype)
                 for a, (_, p) in zip(acc, leaves)]
        return loss, tree_util.unflatten(paths, grads)

    layout = None
    if oac is None:
        def server_fn(server, grads, seed, draws):
            return grads, None
    else:
        oac = dataclasses.replace(oac, n_clients=n_shards)
        if oac.wireless is not None:
            oac = dataclasses.replace(
                oac, wireless=dataclasses.replace(oac.wireless,
                                                  n_clients=n_shards))
        bctrl = (budget.BudgetController(
            rho=oac.rho,
            age_offset=(float(oac.straggler_lag) if oac.async_agg
                        else 0.0),
            thin=min(0.99, (oac.population.thin
                            if oac.population is not None else 0.0)
                     + (oac.wireless.thin
                        if oac.wireless is not None else 0.0)))
            if oac.adaptive_km else None)
        if oac.packed:
            layout = server_layout(tr.init_lm(None, cfg))
            server_fn = _packed_phase(oac, layout, bctrl, kernel_mode, dev)
        else:
            server_fn = _per_leaf_phase(oac, kernel_mode, dev)

    def update(params, opt_state, server, grads, seed, draws=None):
        """The server phase and the optimizer, in place."""
        with torch.no_grad():
            g_t, new_server = server_fn(server, grads, int(seed), draws)
            g_t = tree_util.tree_map(lambda gt, p: gt.to(p.dtype), g_t,
                                     params)
            opt.apply_(g_t, opt_state, params)
            if new_server is not None:
                _assign(server, new_server)
        return params, opt_state, server

    def fn(params, opt_state, server, batch, seed, draws=None):
        loss, grads = grads_fn(params, batch)
        update(params, opt_state, server, grads, seed, draws)
        return params, opt_state, server, loss

    return StepBundle(fn, meta, grads_fn, update, layout)


# ---------------------------------------------------------------------------
# prefill / serve steps
# ---------------------------------------------------------------------------

def _serve_capacity(cfg: ModelConfig, shape: InputShape) -> Tuple[int, bool]:
    """(cache capacity, ring?) for decode shapes."""
    if shape.seq_len > 32768 and cfg.sliding_window and cfg.family not in (
            "ssm", "hybrid"):
        return cfg.sliding_window, True       # long-context sliding window
    return shape.seq_len, False


def make_prefill_step(cfg: ModelConfig, shape: InputShape) -> StepBundle:
    """``fn(params, caches, batch) -> (last logits (B, 1, V), caches)``:
    the prompt (``tokens``, and ``embeds`` / ``frames`` for a VLM or an
    encoder-decoder) through the stack, the caches filled in place."""
    def prefill_step(params, caches, batch):
        return tr.prefill(params, cfg, batch["tokens"], caches,
                          embeds=batch.get("embeds"),
                          frames=batch.get("frames"))

    meta = {"kind": "prefill", "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(prefill_step, meta)


def make_serve_step(cfg: ModelConfig, shape: InputShape) -> StepBundle:
    """``fn(params, caches, token (B, 1), pos) -> (logits (B, 1, V),
    caches)``: one decoded token, the caches updated in place.  ``meta``
    holds the cache ``capacity`` and ``ring`` the step expects
    (``models.transformer.init_caches``)."""
    capacity, ring = _serve_capacity(cfg, shape)
    window = cfg.sliding_window if ring else 0

    def serve_step(params, caches, token, pos):
        return tr.decode_step(params, cfg, token, pos, caches, window=window)

    meta = {"kind": "decode", "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, "capacity": capacity,
            "ring": ring, "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(serve_step, meta)


def _assign(server: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Write the successor state into the carried buffers (copies, in
    their dtypes)."""
    for key, val in new.items():
        cur = server.get(key)
        if isinstance(cur, Tensor) and isinstance(val, Tensor) \
                and cur.shape == val.shape:
            if val.data_ptr() != cur.data_ptr():
                cur.copy_(val)
        elif isinstance(cur, (dict, list)):
            for (_, c), (_, v) in zip(tree_util.leaves(cur),
                                      tree_util.leaves(val)):
                c.copy_(v)
        else:
            server[key] = val


def _packed_phase(oac: OacServerConfig, layout: packing.PackedLayout,
                  bctrl, kernel_mode, dev):
    """ONE fused FAIR-k pass over the packed tree against the persisted
    flat buffers (``_packed_server_phase`` of the reference)."""
    d = layout.d_packed
    eng = SelectionEngine(
        EngineConfig(policy="fairk", backend="packed", rho=oac.rho,
                     k_m_frac=oac.k_m_frac, sample_cap=oac.sample_cap,
                     noise_std=(0.0 if oac.one_bit else oac.noise_std),
                     n_clients=oac.n_clients, warm_start=oac.warm_start,
                     fused_stats=oac.fused_stats, kernel_mode=kernel_mode),
        d, layout=layout)
    fcfg = faults.FaultConfig(fade=oac.fade, fade_block=oac.fade_block)
    jitter: Dict[torch.device, Tensor] = {}

    def phase(server, grads, seed, draws):
        device = server["g"].device
        drawn = server_draws(oac, seed, layout, device)
        drawn.update(draws or {})
        tstate = packing.threshold_state_from_vec(server["theta"])
        cstate = kmf = None
        if oac.adaptive_km:
            cstate = budget.controller_state_from_vec(server["ctrl"])
            kmf = cstate["k_m_frac"]
        noise = drawn.get("noise")
        pop_stats = drawn.get("pop")
        g_flat = layout.pack(grads)            # the only pack per step
        new_fad = wl_erase = None
        if oac.wireless is not None:
            new_fad, wl_erase = chan.block_outage(server["fad"],
                                                  drawn["fad_w"], d,
                                                  oac.wireless)
            if oac.wireless.csi_err > 0.0:
                g_flat = g_flat * chan.csi_block_factor(drawn["csi"], d,
                                                        oac.wireless)
        age_lag = new_shadow = None
        if oac.async_agg:
            frac = (pop_stats["slow_share"] if oac.population is not None
                    else chan.f32(oac.straggler_frac))
            if device not in jitter:
                jitter[device] = index_jitter(d, device=device)
            late = jitter[device] < frac
            # XLA rewrites the reference's ``g * float(late)`` as a
            # select (+0.0, and NaN dropped, off the pattern); the other
            # factor stays a product
            new_shadow = torch.where(late, g_flat, 0.0)
            g_flat = (g_flat * (1.0 - late.to(torch.float32))
                      + server["shadow"].to(torch.float32))
            age_lag = oac.straggler_lag
        fresh = None
        if oac.one_bit:
            eff = g_flat
            if "res" in server:
                eff = eff + server["res"]
            vote_noise = (oac.noise_std * noise if oac.noise_std > 0.0
                          else None)
            fresh, _ = ops.sign_mv(eff[None, :], noise=vote_noise,
                                   mode=kernel_mode)
            noise = None
        erase = None
        if oac.fade > 0.0:
            erase = faults.fade_mask(drawn["fade_u"], d, fcfg)
        if oac.population is not None:
            churn_er = faults.erase_with_outage(
                pop_mod.churn_erase_mask(drawn["churn_u"], d,
                                         pop_stats["churn"], oac.population),
                pop_stats["n_t"])
            erase = (churn_er if erase is None
                     else torch.maximum(erase, churn_er))
        if wl_erase is not None:
            erase = (wl_erase if erase is None
                     else torch.maximum(erase, wl_erase))
        g_t, age_next, stats = eng.select_and_merge(
            g_flat, server["g"], server["age"], noise=noise, tstate=tstate,
            residual=server.get("res"), fresh=fresh, k_m_frac=kmf,
            age_lag=age_lag, erase=erase, sanitize=oac.sanitize)
        new_server = {"g": g_t.to(torch.bfloat16),
                      "age": age_next.to(torch.int8),
                      "theta": packing.threshold_state_to_vec(
                          stats["tstate"])}
        if "res" in server:
            new_server["res"] = stats["residual"]
        if oac.wireless is not None:
            new_server["fad"] = new_fad
        if oac.adaptive_km:
            cstate = bctrl.update(cstate, stats["age_hist"],
                                  stats["mag_hist"])
            new_server["ctrl"] = budget.controller_state_to_vec(cstate)
        if oac.async_agg:
            # the optimizer consumes LAST round's merged gradient
            out = server["pending"].to(torch.float32)
            new_server["shadow"] = new_shadow.to(torch.bfloat16)
            new_server["pending"] = g_t.to(torch.bfloat16)
        else:
            out = g_t
        # the optimizer consumes per-leaf trees: ONE unpack per step
        return layout.unpack(out, cast=False), new_server

    return phase


def _per_leaf_phase(oac: OacServerConfig, kernel_mode, dev):
    """The historical per-leaf loop: one threshold engine (a quantile
    estimation and a fused launch) per parameter leaf."""
    engines: Dict[int, SelectionEngine] = {}

    def phase(server, grads, seed, draws):
        leaves_g = tree_util.leaves(grads)
        paths = [pa for pa, _ in leaves_g]
        gps = [x for _, x in tree_util.leaves(server["g"])]
        ages = [x for _, x in tree_util.leaves(server["age"])]
        device = server["theta"].device
        drawn = leaf_draws(oac, seed, grads, device)
        drawn.update(draws or {})
        noises = drawn.get("leaf_noise", [None] * len(gps))
        g_t, new_gp, new_age = [], [], []
        for i, ((_, g), gp, ag, nz) in enumerate(zip(leaves_g, gps, ages,
                                                     noises)):
            if i not in engines:
                engines[i] = _leaf_engine(oac, g.numel(), kernel_mode)
            a, b, c = _leaf_server_update(g, gp, ag, nz, oac, engines[i])
            g_t.append(a)
            new_gp.append(b)
            new_age.append(c)
        new_server = {"g": tree_util.unflatten(paths, new_gp),
                      "age": tree_util.unflatten(paths, new_age),
                      "theta": server["theta"]}
        return tree_util.unflatten(paths, g_t), new_server

    return phase


__all__ = ["OacServerConfig", "StepBundle", "make_train_step",
           "make_prefill_step", "make_serve_step", "train_input_specs",
           "init_server_state", "server_layout", "state_from_numpy",
           "server_draws", "leaf_draws", "fairk_threshold_masks",
           "TAG_NOISE", "TAG_FADING", "TAG_CSI", "TAG_FADE", "TAG_CHURN",
           "TAG_LEAF"]
