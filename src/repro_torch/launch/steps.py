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

Without a mesh the train step runs on one card, one shard: no
collective, and ``n_clients`` is 1.  With a mesh (``launch.mesh``, the
third argument of ``make_train_step``, ``make_prefill_step`` and
``make_serve_step``) each rank holds its blocks of the parameters, the
optimizer state and the server state by ``launch.sharding``'s specs
(``state_from_numpy(..., mesh=, specs=)`` cuts them from global trees;
``init_server_state(..., local=True)`` makes the rank's server state),
runs its batch rows through the model with each block's weights
gathered over the FSDP axes inside the checkpointed block function
(``models.parallel``) — and over ``model`` too where the part they
belong to does not split (``parallel.tp_split``): the split parts
compute only the rank's heads, hidden units, SSM heads or vocabulary
block; heads that do not split evenly gather ``wq`` / ``wo`` over
``model`` in the layer and compute the rank's uneven run of whole heads
(``parallel.head_range``) —, reduce-scatters each block's gradient over
the batch axes in the backward pass into float32 accumulators of its
local shape (leaves gathered over no batch axis are all-reduced once,
at the end), and runs the reference's per-shard server phase on its
blocks: one ``fairk_update`` over its ``d_packed`` with ``reduce_axes``
= every mesh axis and ``n_clients`` the number of batch shards, then
the optimizer in place.  ``sequence_parallel`` keeps the residual as the rank's slice of
the sequence over ``model`` (gathered on entry to each sub-layer and
reduce-scattered on its exit); ``_with_expert_axis`` pins the experts to
``model`` (each rank runs its ``E/M`` experts).  The sharded prefill and
serve steps partition the parameters as the train step does (the split
parts' leaves stay the rank's ``model`` blocks, gathered over the FSDP
axes layer by layer, and the rank computes its part; the logits'
vocabulary blocks are gathered at the end) and keep the caches by
``cache_pspecs``.
A bundle built on a mesh carries the reference's ``in_shardings`` and
``out_shardings`` as spec trees (``in_specs`` / ``out_specs``).

``make_fl_oac_step(cfg, mesh, ...)`` is the paper's own regime across the
ranks of a mesh (``launch.mesh``): every rank is one OAC-FL client with a
full replica of the flat float32 weights, FAIR-k picks blocks of
``block`` coordinates by the L2 norm of ``g_prev`` and by block age, and
only the selected blocks ride the ``all_reduce`` (ρ·d values instead of
d; ``baseline`` sends them all).  ``abstract_params(cfg)`` is the LM's
parameter tree as ``meta`` tensors.

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
from repro_torch.core import collectives, faults, packing
from repro_torch.core import population as pop_mod
from repro_torch.core.engine import (AGE_CAP, EngineConfig,
                                     SelectionEngine, fair_k_masks_dynamic,
                                     index_jitter, mask_to_indices,
                                     sampled_thresholds, traced_km)
from repro_torch.core.oac import reciprocal
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.launch import sharding
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.launch.sharding import P
from repro_torch.models import transformer as tr
from repro_torch.models.parallel import Parallel, gather_param, tp_split
from repro_torch.optim import make_optimizer
from repro_torch.tracing import span

Tensor = torch.Tensor

# named draw streams of a step (the reference's fold-in tags)
TAG_NOISE = 0
TAG_FADING = 0xC4A
TAG_CSI = 0xC51
TAG_FADE = 0xFADE
TAG_CHURN = 0x509
TAG_LEAF = 0x1EAF
TAG_FL_OAC = 0xF10AC      # the FL-OAC step: index 0 the fading, 1 the noise
POPULATION_SEED = 0x509
RAYLEIGH_SCALE = 1.0 / 1.2533141373155003    # E[h] = 1
ONE_BIT_MAX_CLIENTS = 2048   # vote sums stay exact integers in float16
# the mesh a single-card train step lays its shardings on: one rank and
# no process group, so nothing is gathered or reduced
_ONE_RANK = AbstractMesh((1, 1), ("data", "model"))


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
    in_specs: Any = None
    out_specs: Any = None


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _batch_parts(shape: InputShape, n_micro: Optional[int], n_shards: int
                 ) -> Tuple[int, int]:
    """(microbatches, microbatch rows) of the global batch."""
    gb = shape.global_batch
    if n_micro is None:
        n_micro = max(1, gb // n_shards)
    if gb % n_micro:
        raise ValueError(f"global batch {gb} not divisible by n_micro "
                         f"{n_micro}")
    return n_micro, gb // n_micro


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The LM's parameter tree as ``meta`` tensors: the shapes and dtypes
    of ``models.transformer.init_lm``, no memory."""
    return tr.init_lm(None, cfg)


def ravel_params(params: Any) -> Tensor:
    """The parameter tree as one flat float32 vector in tree order (the
    reference's ``ravel_pytree``)."""
    return torch.cat([p.reshape(-1).to(torch.float32)
                      for _, p in tree_util.leaves(params)])


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


def _meta_tree(params: Any, specs: Any = None, mesh=None) -> Any:
    """``params`` as ``meta`` tensors, each the rank's block shape under
    ``specs`` when a mesh is given."""
    pairs = tree_util.leaves(params)
    spec_l = (sharding.spec_leaves(specs) if mesh is not None
              else [P()] * len(pairs))
    return tree_util.unflatten(
        [pa for pa, _ in pairs],
        [torch.empty(sharding.local_shape(x.shape, sp, mesh)
                     if mesh is not None else tuple(x.shape),
                     dtype=x.dtype, device="meta")
         for (_, x), sp in zip(pairs, spec_l)])


def server_layout(params: Any, p_specs: Any = None, mesh=None
                  ) -> packing.PackedLayout:
    """The packed layout of the persisted server state: one shard, the
    whole tree; on a mesh the rank's ``PackedLayout`` built from the local
    block shapes (what ``PackedLayout.from_tree(local grads)`` builds)."""
    if mesh is None:
        return packing.PackedLayout.from_tree(params)
    return packing.PackedLayout.from_tree(_meta_tree(params, p_specs, mesh))


def _with_expert_axis(cfg: ModelConfig, mesh) -> ModelConfig:
    """Pin the experts to the ``model`` axis when E divides it and each
    rank holds at least two experts."""
    model_n = collectives.axis_size(mesh, ("model",))
    if (cfg.n_experts and not cfg.expert_shard_axis
            and cfg.n_experts % model_n == 0
            and cfg.n_experts >= 2 * model_n):
        return dataclasses.replace(cfg, expert_shard_axis="model")
    return cfg


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


def init_server_state(params: Any, mesh=None, cfg: ModelConfig = None,
                      oac: Optional[OacServerConfig] = OacServerConfig(), *,
                      local: bool = False, device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """The server state ``make_train_step`` expects, on the parameters'
    device (``device`` when they are ``meta`` tensors).  Packed (the
    default): flat ``g`` (d,) bf16, ``age`` (d,) int8 with ``PAD_AGE`` in
    the pads and the ``theta`` vector, plus ``res``, ``ctrl``, ``shadow`` /
    ``pending`` and ``fad`` as configured.  Per leaf (``oac`` None or
    ``packed=False``): trees of bf16 ``g`` and int8 ``age``, and ``theta``.

    On a mesh (``params`` the global tree, ``cfg`` its configuration) the
    packed buffers are the reference's global ones, ``n × d_packed`` with
    ``d_packed`` the per-shard layout's and ``age`` tiled per shard;
    ``local=True`` gives this rank's block of each instead, which is what
    the sharded step takes."""
    if mesh is not None:
        return _init_sharded_server_state(params, mesh, cfg, oac, local,
                                          device)
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


def _init_sharded_server_state(params, mesh, cfg, oac, local, device):
    dev = tree_util.leaves(params)[0][1].device
    dev = resolve_device(device) if dev.type == "meta" else dev
    p_specs = sharding.param_pspecs(params, cfg, mesh)
    theta = torch.zeros(packing.THRESHOLD_STATE_SIZE, dtype=torch.float32,
                        device=dev)
    if oac is None or not oac.packed:
        tree = _meta_tree(params, p_specs, mesh) if local else params
        return {"g": tree_util.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.bfloat16,
                                          device=dev), tree),
                "age": tree_util.tree_map(
                    lambda p: torch.zeros(p.shape, dtype=torch.int8,
                                          device=dev), tree),
                "theta": theta}
    lay = server_layout(params, p_specs, mesh)
    n = 1 if local else collectives.mesh_size(mesh)
    d = n * lay.d_packed
    state = {"g": torch.zeros(d, dtype=torch.bfloat16, device=dev),
             "age": lay.init_age(torch.int8, dev).repeat(n), "theta": theta}
    if oac.error_feedback:
        state["res"] = torch.zeros(d, dtype=torch.float32, device=dev)
    if oac.adaptive_km:
        state["ctrl"] = budget.controller_state_to_vec(
            budget.init_controller_state(oac.k_m_frac, dev))
    if oac.async_agg:
        state["shadow"] = torch.zeros(d, dtype=torch.bfloat16, device=dev)
        state["pending"] = torch.zeros(d, dtype=torch.bfloat16, device=dev)
    if oac.wireless is not None:
        # the cold start is a function of the GLOBAL block count
        n_all = collectives.mesh_size(mesh)
        fad = chan.init_block_fading(
            n_all * chan.n_blocks(lay.d_packed, oac.wireless), dev)
        vec = P(collectives.axis_names(mesh))
        state["fad"] = (sharding.local_shard(fad, vec, mesh).clone()
                        if local else fad)
    return state


def abstract_server_state(params_abs: Any, mesh=None, p_specs: Any = None,
                          oac: Optional[OacServerConfig] = None
                          ) -> Dict[str, Any]:
    """The global server state's shapes and dtypes as ``meta`` tensors."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    theta = meta((packing.THRESHOLD_STATE_SIZE,), torch.float32)
    if oac is not None and oac.packed:
        lay = server_layout(params_abs, p_specs, mesh)
        n = collectives.mesh_size(mesh) if mesh is not None else 1
        d = n * lay.d_packed
        state = {"g": meta((d,), torch.bfloat16),
                 "age": meta((d,), torch.int8), "theta": theta}
        if oac.error_feedback:
            state["res"] = meta((d,), torch.float32)
        if oac.adaptive_km:
            state["ctrl"] = meta((budget.CONTROLLER_STATE_SIZE,),
                                 torch.float32)
        if oac.async_agg:
            state["shadow"] = meta((d,), torch.bfloat16)
            state["pending"] = meta((d,), torch.bfloat16)
        if oac.wireless is not None:
            state["fad"] = meta(
                (2 * n * chan.n_blocks(lay.d_packed, oac.wireless),),
                torch.float32)
        return state
    return {"g": tree_util.tree_map(lambda p: meta(p.shape, torch.bfloat16),
                                    params_abs),
            "age": tree_util.tree_map(lambda p: meta(p.shape, torch.int8),
                                      params_abs),
            "theta": theta}


def state_from_numpy(tree: Any, device: DeviceLike = None, mesh=None,
                     specs: Any = None) -> Any:
    """A tree of numpy arrays (the reference's params, optimizer state or
    server state through ``np.asarray``) -> the same tree of tensors on
    ``device``.  A bfloat16 leaf arrives as its ``uint16`` view (or a
    numpy ``bfloat16`` extension array) and becomes a bf16 tensor; other
    dtypes are kept.  With ``mesh`` and ``specs`` (a spec tree matching
    ``tree``) each leaf becomes this rank's block (``local_shard``)."""
    dev = resolve_device(device)

    def leaf(a, spec=None):
        a = np.asarray(a)
        if spec is not None:
            a = a[sharding.local_slices(a.shape, spec, mesh)]
        if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
            words = np.ascontiguousarray(a).view(np.int16).copy()
            return torch.from_numpy(words).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)
    if mesh is None:
        return tree_util.tree_map(leaf, tree)
    pairs = tree_util.leaves(tree)
    specs_l = sharding.spec_leaves(specs)
    if len(specs_l) != len(pairs):
        raise ValueError(f"{len(pairs)} leaves and {len(specs_l)} specs")
    return tree_util.unflatten([pa for pa, _ in pairs],
                               [leaf(a, sp) for (_, a), sp
                                in zip(pairs, specs_l)])


def _stream(seed: int, tag: int, device, index: int = 0) -> torch.Generator:
    """The named draw stream ``(seed, tag, index)`` on ``device``."""
    return pop_mod.round_generator(seed, tag, index, device)


def server_draws(oac: OacServerConfig, seed: int, layout, device,
                 shard: int = 0) -> Dict[str, Any]:
    """The packed server phase's draws for step ``seed``: ``noise`` (d,)
    standard normals (the channel noise; with ``one_bit`` the vote noise),
    ``fad_w`` (nb, 2) and ``csi`` (nb,) normals of the wireless round,
    ``fade_u`` and ``churn_u`` block uniforms, and ``pop`` the stateless
    population round's statistics — each as the configuration needs it.
    On a mesh every stream but the population's carries the rank's
    row-major ``shard`` index (the reference folds it into its key), so
    the draws are independent across shards; the population round is the
    same on every shard."""
    d = layout.d_packed
    wireless = oac.wireless
    draws: Dict[str, Any] = {}
    if oac.noise_std > 0.0:
        draws["noise"] = torch.randn(
            d, generator=_stream(seed, TAG_NOISE, device, shard),
            device=device)
    if wireless is not None:
        nb = chan.n_blocks(d, wireless)
        draws["fad_w"] = torch.randn(
            nb, 2, generator=_stream(seed, TAG_FADING, device, shard),
            device=device)
        if wireless.csi_err > 0.0:
            draws["csi"] = torch.randn(
                nb, generator=_stream(seed, TAG_CSI, device, shard),
                device=device)
    if oac.fade > 0.0:
        draws["fade_u"] = torch.rand(
            -(-d // oac.fade_block),
            generator=_stream(seed, TAG_FADE, device, shard), device=device)
    if oac.population is not None:
        pc = oac.population
        draws["pop"] = pop_mod.stateless_round(POPULATION_SEED, int(seed),
                                               pc, device)
        draws["churn_u"] = torch.rand(
            -(-d // pc.erase_block),
            generator=_stream(seed, TAG_CHURN, device, shard), device=device)
    return draws


def leaf_draws(oac: OacServerConfig, seed: int, params: Any, device,
               shard: int = 0) -> Dict[str, Any]:
    """The per-leaf server phase's draws: ``leaf_noise``, one (size,)
    standard-normal vector per leaf in flattening order (stream index
    ``shard · n_leaves + i`` on a mesh)."""
    if oac.noise_std <= 0.0:
        return {}
    leaves = tree_util.leaves(params)
    base = shard * len(leaves)
    return {"leaf_noise": [
        torch.randn(leaf.numel(), generator=_stream(seed, TAG_LEAF, device,
                                                      base + i),
                    device=device)
        for i, (_, leaf) in enumerate(leaves)]}


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

def make_train_step(cfg: ModelConfig, shape: InputShape, mesh=None, *,
                    n_micro: Optional[int] = None,
                    client_chunk: Optional[int] = None,
                    oac: Optional[OacServerConfig] = OacServerConfig(),
                    opt_name: Optional[str] = None, lr=1e-3,
                    sequence_parallel: bool = True,
                    gather_dtype: Optional[str] = None,
                    kernel_mode: Optional[str] = None,
                    device: DeviceLike = None) -> StepBundle:
    """The train step of ``cfg`` at ``shape`` on ``device`` (the card
    unless asked otherwise), with the reference's argument checks and
    ``meta`` keys.  ``kernel_mode`` ("plain") runs the server phase on the
    kernels' plain versions.

    ``fn(params, opt_state, server, batch, seed, draws=None)`` updates the
    three trees in place and returns them with the loss; ``draws``
    replaces the step's draws (``server_draws``).  Without ``mesh`` it
    takes the whole trees and runs on one card, as the same step on a
    mesh of one rank and no process group (``_ONE_RANK``), over which
    nothing is gathered or reduced.  On a mesh
    (the reference's FSDP×TP step) it takes the rank's blocks of
    ``params`` and ``opt_state`` (``param_pspecs`` / ``opt_pspecs``), the
    rank's server state (``init_server_state(..., local=True)``) and the
    GLOBAL ``batch`` (n_micro, mb, ...), of which the rank runs its rows
    (its row-major block over the batch axes when they divide ``mb``,
    else every row); the loss is the global mean, equal on every rank.
    The parts of ``cfg`` that ``parallel.tp_split`` finds split over
    ``model`` compute the rank's part (``meta["tensor_parallel"]``), and
    ``sequence_parallel`` slices the residual over ``model`` when it has
    more than one rank."""
    grid = _ONE_RANK if mesh is None else mesh
    if mesh is not None:
        cfg = _with_expert_axis(cfg, mesh)
    dev = resolve_device(device)
    b_axes = sharding.batch_axes(grid)
    n_shards = collectives.axis_size(grid, b_axes)
    n_micro, mb = _batch_parts(shape, n_micro, n_shards)
    if client_chunk is not None and (
            client_chunk < 1 or n_micro % client_chunk):
        raise ValueError(
            f"client_chunk must divide n_micro ({n_micro}), got "
            f"{client_chunk}")
    rows = collectives.spread(grid, b_axes) if mb % n_shards == 0 else ()
    gdt = getattr(torch, gather_dtype) if gather_dtype else None
    # the dtype a block's gradient is reduce-scattered in
    rs_dtype = gdt or torch.float32
    opt = make_optimizer(opt_name or cfg.optimizer, lr)
    _check_oac(oac)
    meta = _meta(cfg, shape, oac, n_micro, mb, client_chunk, opt_name, lr,
                 gather_dtype)
    inv_micro = reciprocal(n_micro)
    inv_shards = reciprocal(n_shards)

    params_abs, p_specs, split, pinned, plan = _partition(cfg, grid)
    pairs = tree_util.leaves(params_abs)
    paths = [pa for pa, _ in pairs]
    # the accumulators have the leaves' local shapes
    acc_shapes = [sharding.local_shape(x.shape, spec, grid)
                  for (_, x), spec in zip(pairs,
                                          sharding.spec_leaves(p_specs))]
    # the leaves whose gradient the backward pass reduce-scatters over the
    # batch axes (a dimension gathered over ``rows``)
    scattered = [bool(rows) and any(axes == rows for _, axes in pl)
                 for _, pl in plan]
    seq_sp = _text_len(cfg, shape.seq_len) + (cfg.n_patches or 0)
    model = collectives.spread(grid, ("model",))
    seq = (model if sequence_parallel
           and seq_sp % collectives.axis_size(grid, ("model",)) == 0 else ())
    experts = model if pinned else ()
    tp = model if split else ()
    loss_axes = collectives.spread(grid, collectives.axis_names(grid))
    if mesh is not None:
        meta.update(mesh_shape=tuple(mesh.shape),
                    mesh_axes=collectives.axis_names(mesh),
                    rows_sharded=bool(rows), sequence_parallel=bool(seq),
                    expert_shard_axis=cfg.expert_shard_axis,
                    tensor_parallel=sorted(split))

    def my_rows(x):
        if not rows:
            return x
        n = x.shape[0] // n_shards
        r0 = collectives.axis_index(grid, rows) * n
        return x[r0:r0 + n]

    def reduce_grad(g, k):
        """The rank's summed gradient -> its mean over the batch axes: a
        leaf reduce-scattered block by block takes the factor, the others
        (gathered over no batch axis) are all-reduced here."""
        if not rows:
            return g
        if scattered[k]:
            return g * inv_shards
        return collectives.pmean(g, grid, rows)

    def grads_fn(params, batch):
        """The global mean loss and the rank's blocks of the mean
        gradients over the microbatches and the batch axes (float32
        accumulators of the local shapes; a gathered block's gradient is
        reduce-scattered and added as the backward pass leaves it; a
        chunk's gradients are summed before they join)."""
        with span("step.grads"):
            return _grads(params, batch)

    def _grads(params, batch):
        local = [p for _, p in tree_util.leaves(params)]
        acc = [torch.zeros(sh, dtype=torch.float32, device=p.device)
               for sh, p in zip(acc_shapes, local)]
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        chunk = client_chunk or 1
        for c0 in range(0, n_micro, chunk):
            sinks = (acc if chunk == 1 else
                     [torch.zeros_like(a) for a in acc])
            loss_c = None
            for i in range(c0, c0 + chunk):
                with span("step.micro"):
                    loss = _micro(local, batch, i, sinks)
                loss_c = loss if loss_c is None else loss_c + loss
            loss_acc = loss_acc + loss_c
            if chunk > 1:
                with span("step.accumulate"):
                    for a, g in zip(acc, sinks):
                        a.add_(g)
                del sinks
        with span("step.accumulate"):
            # the mean over every rank: the model ranks of one row agree
            # unless a replicated leaf's copies have drifted apart (noise,
            # fades and the channel draw per shard), and then every rank
            # still reports the same loss
            loss = collectives.pmean(loss_acc * inv_micro, grid, loss_axes)
            grads = [reduce_grad(a.mul_(inv_micro), k).to(p.dtype)
                     for k, (a, p) in enumerate(zip(acc, local))]
        del acc
        return loss, tree_util.unflatten(paths, grads)

    def _micro(local, batch, i, sinks):
        """Microbatch ``i``: its loss, its gradients added into ``sinks``."""
        mbatch = {k: my_rows(v[i]) for k, v in batch.items()}
        with torch.enable_grad():
            xs = [(p.detach().to(gdt) if gdt is not None
                   and p.dim() > 1 else p.detach())
                  .requires_grad_(True) for p in local]
            whole = [x if plan[k][0] is not None
                     else gather_param(x, grid, plan[k][1], sinks[k],
                                       rows, rs_dtype)
                     for k, x in enumerate(xs)]
            par = Parallel(grid, rows=rows, seq=seq, experts=experts,
                           tp=tp, split=split,
                           gather=_block_gather(grid, paths, plan,
                                                sinks, rows,
                                                rs_dtype))
            with span("step.forward"):
                loss, _ = tr.loss_fn(tree_util.unflatten(paths, whole),
                                     cfg, mbatch, par=par)
            with span("step.backward"):
                gs = torch.autograd.grad(loss, xs, allow_unused=True)
        # a leaf gathered over no axis gets its gradient here; the
        # others have added theirs into ``sinks`` block by block
        with span("step.accumulate"):
            for sink, g in zip(sinks, gs):
                if g is not None:
                    sink.add_(g.to(torch.float32))
        del gs
        return loss.detach()

    layout = (server_layout(params_abs, p_specs, mesh)
              if oac is not None and oac.packed else None)
    update, fn = _update_and_step(oac, n_shards, layout, opt, grads_fn,
                                  kernel_mode, dev, mesh)
    if mesh is None:
        return StepBundle(fn, meta, grads_fn, update, layout)
    o_specs = sharding.opt_pspecs(opt.init(params_abs), p_specs)
    srv_specs = sharding.server_pspecs(
        p_specs, mesh=mesh, packed=(oac is not None and oac.packed),
        error_feedback=(oac is not None and oac.error_feedback),
        adaptive_km=(oac is not None and oac.adaptive_km),
        async_agg=(oac is not None and oac.async_agg),
        wireless=(oac is not None and oac.wireless is not None))
    b_specs = _batch_specs(cfg, mb, mesh, micro=True)
    return StepBundle(fn, meta, grads_fn, update, layout,
                      in_specs=(p_specs, o_specs, srv_specs, b_specs, P()),
                      out_specs=(p_specs, o_specs, srv_specs, P()))


def _update_and_step(oac, n_shards, layout, opt, grads_fn, kernel_mode, dev,
                     mesh=None):
    """A train step's ``update`` (the server phase with ``n_clients`` the
    batch shards, then the optimizer, in place) and ``fn`` (``grads_fn``,
    then ``update``).  On a mesh the server phase is the rank's."""
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
            server_fn = _packed_phase(oac, layout, bctrl, kernel_mode, dev,
                                      mesh)
        else:
            server_fn = _per_leaf_phase(
                oac, kernel_mode, dev,
                collectives.axis_index(mesh) if mesh is not None else 0)

    def update(params, opt_state, server, grads, seed, draws=None):
        """The server phase and the optimizer, in place."""
        with span("step.update"), torch.no_grad():
            g_t, new_server = server_fn(server, grads, int(seed), draws)
            with span("optim.apply"):
                g_t = tree_util.tree_map(lambda gt, p: gt.to(p.dtype), g_t,
                                         params)
                opt.apply_(g_t, opt_state, params)
            if new_server is not None:
                with span("server.carry"):
                    _assign(server, new_server)
        return params, opt_state, server

    def fn(params, opt_state, server, batch, seed, draws=None):
        loss, grads = grads_fn(params, batch)
        update(params, opt_state, server, grads, seed, draws)
        return params, opt_state, server, loss

    return update, fn


# ---------------------------------------------------------------------------
# the shardings of the train and serving steps
# ---------------------------------------------------------------------------

def _is_expert(path_s: str, ndim: int) -> bool:
    return "/ffn/" in path_s and ndim == 4 and "router" not in path_s


# the leaves of each part that ``parallel.tp_split`` can split: the
# rank computes with its block of them along ``model``
_TP_LEAVES = {
    "attn": ("mixer/wq/w", "mixer/wo/w", "cross/wq/w", "cross/wo/w"),
    "ffn": ("ffn/wg/w", "ffn/wu/w", "ffn/wd/w", "dense_ffn/wg/w",
            "dense_ffn/wu/w", "dense_ffn/wd/w"),
    "ssm": ("mixer/wz/w", "mixer/wx/w", "mixer/wdt/w", "mixer/out_proj/w",
            "mixer/conv_x_w", "mixer/conv_x_b", "mixer/a_log",
            "mixer/d_skip", "mixer/dt_bias"),
    "vocab": ("embed", "head/w"),
}


def _tp_part(path_s: str, ndim: int) -> Optional[str]:
    """The split part a leaf belongs to (None: it is used whole)."""
    if _is_expert(path_s, ndim):
        return "moe"
    for part, ends in _TP_LEAVES.items():
        if any(path_s == e or path_s.endswith("/" + e) for e in ends):
            return part
    return None


def _partition(cfg: ModelConfig, mesh) -> Tuple:
    """(the abstract parameters, their specs, the parts split over
    ``model`` (``parallel.tp_split``), whether the rank runs only its
    experts, the leaves' gather plan): the one partition of the train
    and serving steps on ``mesh``."""
    params_abs = abstract_params(cfg)
    p_specs = sharding.param_pspecs(params_abs, cfg, mesh)
    split = tp_split(cfg, mesh)
    # the rank runs its experts where they are pinned, and wherever the
    # spec splits them over ``model``
    pinned = cfg.expert_shard_axis == "model" or "experts" in split
    plan = _gather_plan(params_abs, p_specs, pinned, mesh, split)
    return params_abs, p_specs, split, pinned, plan


def _gather_plan(params_abs: Any, p_specs: Any, pinned: bool, mesh,
                 split: frozenset = frozenset()) -> list:
    """Per leaf (in ``tree.leaves`` order): (stack name or None, the
    ``(dim, axes)`` pairs to gather over, axes of one rank left out).  A
    stacked leaf is gathered per block, so its dims count from the block;
    a pinned expert leaf keeps its experts split over ``model``, and so
    does a leaf of a part in ``split`` (``parallel.tp_split``) its
    ``model`` block, whose dimension the spec must split over ``model``
    (uneven heads gather their ``wq`` / ``wo`` blocks over ``model`` in
    the layer, ``transformer._heads_of``)."""
    plan = []
    for (path, leaf), spec in zip(tree_util.leaves(params_abs),
                                  sharding.spec_leaves(p_specs)):
        s = sharding.path_str(path)
        stack = path[0] if path[0] in ("blocks", "enc_blocks") else None
        entries = list(tuple(spec))
        if stack is not None:
            entries = entries[1:]
        part = _tp_part(s, leaf.dim())
        local = part is not None and part in split
        if local and not any("model" in collectives.spread(
                mesh, sharding.entry_axes(e)) for e in entries):
            raise ValueError(f"{s}: the spec {spec} does not split the "
                             f"{part!r} part over 'model'")
        pairs = []
        for dim, entry in enumerate(entries):
            axes = collectives.spread(mesh, sharding.entry_axes(entry))
            if local or (pinned and dim == 0 and _is_expert(s, leaf.dim())):
                axes = tuple(a for a in axes if a != "model")
            if axes:
                pairs.append((dim, axes))
        plan.append((stack, pairs))
    return plan


def _block_gather(mesh, paths, plan, sinks, rows=(), dtype=torch.float32):
    """``Parallel.gather``: the subtree at ``prefix`` of block ``i`` of
    stack ``stack`` gathered, each gathered leaf's gradient
    reduce-scattered over ``rows`` in ``dtype`` into ``sinks[k][i]``
    (None: no gradient)."""
    index = {pa: k for k, pa in enumerate(paths)}

    def gather(tree, stack, i, prefix=()):
        pairs = tree_util.leaves(tree)
        out = []
        for path, x in pairs:
            k = index[(stack,) + tuple(prefix) + tuple(path)]
            entries = plan[k][1]
            sink = (sinks[k][i] if sinks is not None and entries
                    else None)
            out.append(gather_param(x, mesh, entries, sink, rows, dtype))
        return tree_util.unflatten([pa for pa, _ in pairs], out)
    return gather


def _batch_specs(cfg: ModelConfig, gb: int, mesh, micro: bool) -> Dict:
    def mk(extra):
        return sharding.batch_pspec(gb, mesh, extra_dims=extra,
                                    leading_micro=micro)
    specs = {"tokens": mk(1), "labels": mk(1)}
    if cfg.family == "vlm":
        specs["embeds"] = mk(2)
    if cfg.family == "audio":
        specs["frames"] = mk(2)
    return specs


def _sharded_serving(cfg: ModelConfig, mesh, gb: int, cache_abs: Any):
    """(cfg with the expert pin, param specs, cache specs, the leaves'
    gather plan, the ``Parallel``) of a sharded serving step: the train
    step's partition (``_partition``) — the leaves of the parts that
    split over ``model`` stay the rank's blocks and are gathered over the
    FSDP axes only, layer by layer, and the rank computes its part —;
    the caches by ``cache_pspecs``, a batch of one splitting their
    capacity over ``data`` too (``shard_capacity``)."""
    cfg = _with_expert_axis(cfg, mesh)
    params_abs, p_specs, split, pinned, plan = _partition(cfg, mesh)
    c_specs = sharding.cache_pspecs(cache_abs, cfg, mesh,
                                    shard_capacity=gb == 1)
    found: Dict[str, Tuple[str, ...]] = {}
    for path, spec in zip([pa for pa, _ in tree_util.leaves(cache_abs)],
                          sharding.spec_leaves(c_specs)):
        s = sharding.path_str(path)
        for key, suffix, dim in (("kv", "attn/k", 2), ("cross", "cross/k", 2),
                                 ("ssm", "mamba/ssm", 2),
                                 ("conv", "mamba/conv_x", 3)):
            if s.endswith(suffix):
                found.setdefault(key, sharding.entry_axes(tuple(spec)[dim]))
    b_axes = sharding.batch_axes(mesh)
    rows = (b_axes if gb % collectives.axis_size(mesh, b_axes) == 0
            else ())
    paths = [pa for pa, _ in tree_util.leaves(params_abs)]
    model = collectives.spread(mesh, ("model",))
    # serving has no gradient: no sinks
    par = Parallel(mesh, rows=rows,
                   gather=_block_gather(mesh, paths, plan, None),
                   experts=model if pinned else (),
                   kv=found.get("kv", ()), cross=found.get("cross", ()),
                   ssm=found.get("ssm", ()), conv=found.get("conv", ()),
                   tp=model if split else (), split=split,
                   float32_sums=True)
    return cfg, p_specs, c_specs, plan, par


def _serving_params(params: Any, mesh, plan) -> Any:
    """The rank's parameter blocks -> the tree the model runs on: the
    unstacked leaves gathered by the plan (a split ``embed`` / ``head``
    keeps its ``model`` block), the stacks left to ``par.gather`` (block
    by block)."""
    pairs = tree_util.leaves(params)
    paths = [pa for pa, _ in pairs]
    return tree_util.unflatten(
        paths, [x if plan[k][0] is not None
                else gather_param(x, mesh, plan[k][1], None)
                for k, (_, x) in enumerate(pairs)])


def init_sharded_caches(cfg: ModelConfig, mesh, batch: int, capacity: int,
                        ring: bool = False, dtype=None,
                        device: DeviceLike = None):
    """The rank's blocks of empty caches (``cache_pspecs``, the capacity
    over ``data`` too for a batch of one), on ``device``: ``k`` / ``v``
    and the SSM carries cut by the specs, ``pos``, ``idx`` and ``ring``
    whole."""
    dev = resolve_device(device)
    cfg = _with_expert_axis(cfg, mesh)
    cache_abs = tr.cache_specs(cfg, batch, capacity, dtype=dtype, ring=ring)
    c_specs = sharding.cache_pspecs(cache_abs, cfg, mesh,
                                    shard_capacity=batch == 1)
    pairs = tree_util.leaves(cache_abs)
    out = []
    for (path, x), spec in zip(pairs, sharding.spec_leaves(c_specs)):
        shape = sharding.local_shape(x.shape, spec, mesh)
        name = path[-1]
        if name == "pos":
            out.append(torch.full(shape, -1, dtype=x.dtype, device=dev))
        elif name == "ring":
            out.append(torch.full(shape, bool(ring), dtype=x.dtype,
                                  device=dev))
        else:
            out.append(torch.zeros(shape, dtype=x.dtype, device=dev))
    return tree_util.unflatten([pa for pa, _ in pairs], out)


# ---------------------------------------------------------------------------
# prefill / serve steps
# ---------------------------------------------------------------------------

def _serve_capacity(cfg: ModelConfig, shape: InputShape) -> Tuple[int, bool]:
    """(cache capacity, ring?) for decode shapes."""
    if shape.seq_len > 32768 and cfg.sliding_window and cfg.family not in (
            "ssm", "hybrid"):
        return cfg.sliding_window, True       # long-context sliding window
    return shape.seq_len, False


def make_prefill_step(cfg: ModelConfig, shape: InputShape, mesh=None
                      ) -> StepBundle:
    """``fn(params, caches, batch) -> (last logits (B, 1, V), caches)``:
    the prompt (``tokens``, and ``embeds`` / ``frames`` for a VLM or an
    encoder-decoder) through the stack, the caches filled in place.  On a
    mesh ``params`` and ``caches`` are the rank's blocks
    (``init_sharded_caches``), ``batch`` is global, and the logits are the
    rank's rows.  A batch of one fills caches laid out for the batch-one
    serve step (the capacity over ``data`` too), to which the reference
    reshards between its two steps."""
    if mesh is not None:
        return _sharded_prefill_step(cfg, shape, mesh)

    def prefill_step(params, caches, batch):
        return tr.prefill(params, cfg, batch["tokens"], caches,
                          embeds=batch.get("embeds"),
                          frames=batch.get("frames"))

    meta = {"kind": "prefill", "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(prefill_step, meta)


def make_serve_step(cfg: ModelConfig, shape: InputShape, mesh=None
                    ) -> StepBundle:
    """``fn(params, caches, token (B, 1), pos) -> (logits (B, 1, V),
    caches)``: one decoded token, the caches updated in place.  ``meta``
    holds the cache ``capacity`` and ``ring`` the step expects
    (``models.transformer.init_caches``).  On a mesh as
    ``make_prefill_step``, with the capacity split over ``data`` too for
    a batch of one (``shard_capacity``)."""
    if mesh is not None:
        return _sharded_serve_step(cfg, shape, mesh)
    capacity, ring = _serve_capacity(cfg, shape)
    window = cfg.sliding_window if ring else 0

    def serve_step(params, caches, token, pos):
        return tr.decode_step(params, cfg, token, pos, caches, window=window)

    meta = {"kind": "decode", "seq_len": shape.seq_len,
            "global_batch": shape.global_batch, "capacity": capacity,
            "ring": ring, "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(serve_step, meta)


def _sharded_prefill_step(cfg: ModelConfig, shape: InputShape, mesh
                          ) -> StepBundle:
    gb = shape.global_batch
    cache_abs = tr.cache_specs(cfg, gb, shape.seq_len)
    cfg, p_specs, c_specs, plan, par = _sharded_serving(cfg, mesh, gb,
                                                        cache_abs)

    def prefill_step(params, caches, batch):
        full = _serving_params(params, mesh, plan)
        mine = {k: par.my_rows(v) for k, v in batch.items()}
        return tr.prefill(full, cfg, mine["tokens"], caches,
                          embeds=mine.get("embeds"),
                          frames=mine.get("frames"), par=par)

    b_specs = {"tokens": sharding.batch_pspec(gb, mesh, 1, False)}
    if cfg.family == "vlm":
        b_specs["embeds"] = sharding.batch_pspec(gb, mesh, 2, False)
    if cfg.family == "audio":
        b_specs["frames"] = sharding.batch_pspec(gb, mesh, 2, False)
    logits = P(par.rows or None, None, None)
    meta = {"kind": "prefill", "seq_len": shape.seq_len,
            "global_batch": gb, "scans": {"layers": cfg.n_scan_blocks},
            "rows_sharded": bool(par.rows),
            "tensor_parallel": sorted(par.split)}
    return StepBundle(prefill_step, meta, in_specs=(p_specs, c_specs,
                                                    b_specs),
                      out_specs=(logits, c_specs))


def _sharded_serve_step(cfg: ModelConfig, shape: InputShape, mesh
                        ) -> StepBundle:
    gb = shape.global_batch
    capacity, ring = _serve_capacity(cfg, shape)
    cache_abs = tr.cache_specs(cfg, gb, capacity, ring=ring)
    cfg, p_specs, c_specs, plan, par = _sharded_serving(cfg, mesh, gb,
                                                        cache_abs)
    window = cfg.sliding_window if ring else 0

    def serve_step(params, caches, token, pos):
        full = _serving_params(params, mesh, plan)
        return tr.decode_step(full, cfg, par.my_rows(token), pos, caches,
                              window=window, par=par)

    tok = P(par.rows or None, None)
    meta = {"kind": "decode", "seq_len": shape.seq_len, "global_batch": gb,
            "capacity": capacity, "ring": ring,
            "shard_capacity": gb == 1, "rows_sharded": bool(par.rows),
            "tensor_parallel": sorted(par.split),
            "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(serve_step, meta,
                      in_specs=(p_specs, c_specs, tok, P()),
                      out_specs=(P(par.rows or None, None, None), c_specs))


def _same_memory(a: Tensor, b: Tensor) -> bool:
    """Whether ``a`` and ``b`` start at one address (the same storage and
    offset; no data pointer is read, so fake tensors answer too)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


def _assign(server: Dict[str, Any], new: Dict[str, Any]) -> None:
    """Write the successor state into the carried buffers (copies, in
    their dtypes)."""
    for key, val in new.items():
        cur = server.get(key)
        if isinstance(cur, Tensor) and isinstance(val, Tensor) \
                and cur.shape == val.shape:
            if not _same_memory(val, cur):
                cur.copy_(val)
        elif isinstance(cur, (dict, list)):
            for (_, c), (_, v) in zip(tree_util.leaves(cur),
                                      tree_util.leaves(val)):
                c.copy_(v)
        else:
            server[key] = val


def _packed_phase(oac: OacServerConfig, layout: packing.PackedLayout,
                  bctrl, kernel_mode, dev, mesh=None):
    """ONE fused FAIR-k pass over the packed tree against the persisted
    flat buffers (``_packed_server_phase`` of the reference).  On a mesh
    the tree is the rank's blocks, the thresholds, counts and histograms
    are averaged over every axis (``reduce_axes``) and the draws carry the
    rank's shard index."""
    d = layout.d_packed
    axes = collectives.axis_names(mesh) if mesh is not None else ()
    shard = collectives.axis_index(mesh) if mesh is not None else 0
    eng = SelectionEngine(
        EngineConfig(policy="fairk", backend="packed", rho=oac.rho,
                     k_m_frac=oac.k_m_frac, sample_cap=oac.sample_cap,
                     noise_std=(0.0 if oac.one_bit else oac.noise_std),
                     n_clients=oac.n_clients, warm_start=oac.warm_start,
                     fused_stats=oac.fused_stats, kernel_mode=kernel_mode,
                     reduce_axes=axes),
        d, layout=layout, mesh=mesh)
    fcfg = faults.FaultConfig(fade=oac.fade, fade_block=oac.fade_block)
    jitter: Dict[torch.device, Tensor] = {}

    def phase(server, grads, seed, draws):
        device = server["g"].device
        drawn = server_draws(oac, seed, layout, device, shard)
        drawn.update(draws or {})
        tstate = packing.threshold_state_from_vec(server["theta"])
        cstate = kmf = None
        if oac.adaptive_km:
            cstate = budget.controller_state_from_vec(server["ctrl"])
            kmf = cstate["k_m_frac"]
        noise = drawn.get("noise")
        pop_stats = drawn.get("pop")
        with span("server.pack"):
            g_flat = layout.pack(grads)        # the only pack per step
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
            with span("server.vote"):
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
        with span("server.select"):
            g_t, age_next, stats = eng.select_and_merge(
                g_flat, server["g"], server["age"], noise=noise,
                tstate=tstate, residual=server.get("res"), fresh=fresh,
                k_m_frac=kmf, age_lag=age_lag, erase=erase,
                sanitize=oac.sanitize)
        with span("server.carry"):
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
        with span("server.unpack"):
            return layout.unpack(out, cast=False), new_server

    return phase


def _per_leaf_phase(oac: OacServerConfig, kernel_mode, dev, shard: int = 0):
    """The historical per-leaf loop: one threshold engine (a quantile
    estimation and a fused launch) per parameter leaf (on a mesh, per
    local block: the reference's loop inside ``shard_map``)."""
    engines: Dict[int, SelectionEngine] = {}

    def phase(server, grads, seed, draws):
        leaves_g = tree_util.leaves(grads)
        paths = [pa for pa, _ in leaves_g]
        gps = [x for _, x in tree_util.leaves(server["g"])]
        ages = [x for _, x in tree_util.leaves(server["age"])]
        device = server["theta"].device
        drawn = leaf_draws(oac, seed, grads, device, shard)
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


# ---------------------------------------------------------------------------
# FL-OAC step: the paper's regime at its own scale (clients = ranks)
# ---------------------------------------------------------------------------

def fl_oac_draws(seed: int, n_clients: int, kb: int, block: int, device
                 ) -> Dict[str, Tensor]:
    """Round ``seed``'s draws of the FL-OAC step, equal on every rank:
    ``h`` (n_clients,) Rayleigh fading of scale ``RAYLEIGH_SCALE`` (one
    per client) and ``z`` (kb, block) standard normals of the receiver
    noise, from the named streams ``(seed, TAG_FL_OAC, 0 | 1)``."""
    u = torch.rand(n_clients, generator=_stream(seed, TAG_FL_OAC, device, 0),
                   device=device)
    h = RAYLEIGH_SCALE * torch.sqrt(-2.0 * torch.log1p(-u))
    z = torch.randn(kb, block, generator=_stream(seed, TAG_FL_OAC, device, 1),
                    device=device)
    return {"h": h, "z": z}


def make_fl_oac_step(cfg: ModelConfig, mesh, *, seq_len: int = 1024,
                     local_batch: int = 1, rho: float = 0.1,
                     k_m_frac: float = 0.75, block: int = 4096,
                     noise_std: float = 1.0, baseline: bool = False,
                     one_bit: bool = False,
                     adaptive_km: bool = False) -> StepBundle:
    """Every rank of ``mesh`` is one OAC-FL client with a full model
    replica (``repro.launch.steps.make_fl_oac_step``).

    ``fn(w, g_prev, age_b, batch, seed, draws=None) -> (w', g_prev',
    age_b', loss)`` — with ``adaptive_km`` ``fn(w, g_prev, age_b, ctrl,
    batch, seed, draws=None) -> (w', g_prev', age_b', ctrl', loss)`` —
    takes the replicated flat float32 weights ``w`` and ``g_prev`` (d,),
    the block ages ``age_b`` (nb,) float32, the controller vector
    ``ctrl``, and this rank's ``batch`` of ``tokens`` / ``labels``
    (local_batch, seq_len).  The local gradient is the LM's loss on views
    of ``w`` split, reshaped and cast to each leaf (the reference's
    ``unravel``), taken per leaf and laid out flat, padded to ``nb``
    blocks.  FAIR-k runs on the block scores ``Σ g_prev²`` and the block
    ages (rank form, the split ``traced_km(kb, k_m_frac)``), identically
    on every rank; then the uplink: FAIR-k all-reduces ``h[my]·g[idx]``
    (kb, block), ``baseline`` all of ``h[my]·g`` and gathers ``idx``,
    ``one_bit`` sums int8 votes over ``model`` and float16 counts (exact
    integers up to ``ONE_BIT_MAX_CLIENTS``; neither gloo nor NCCL reduces
    int16) over the other axes and takes the sign.  The result is scaled by
    the float32 ``1/n_clients``, gets the noise ``noise_std/n_clients·z``,
    is scattered into ``g_prev``'s blocks, and the block ages advance as
    ``min((age + 1).at[idx].set(0), AGE_CAP)``; ``w' = w − 0.01·g_prev'``
    and ``loss`` is the mean over the ranks.  With ``adaptive_km`` the
    block-age histogram drives ``BudgetController.update``.  ``draws``
    replaces any of ``fl_oac_draws``'s (the tests hand over the
    reference's).  No host sync: the selection's indices come from
    ``mask_to_indices``, the collectives run on the device."""
    axes = collectives.axis_names(mesh)
    n_clients = collectives.axis_size(mesh, axes)
    rest = tuple(a for a in axes if a != "model")
    if one_bit and n_clients > ONE_BIT_MAX_CLIENTS:
        raise ValueError(f"one_bit sums votes in float16, exact for at "
                         f"most {ONE_BIT_MAX_CLIENTS} clients; the mesh has "
                         f"{n_clients}")
    bctrl = budget.BudgetController(rho=rho) if adaptive_km else None
    leaves = tree_util.leaves(abstract_params(cfg))
    paths = [path for path, _ in leaves]
    sizes = [leaf.numel() for _, leaf in leaves]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    d = offsets[-1]
    d_pad = -(-d // block) * block
    nb = d_pad // block
    kb = max(1, int(round(rho * nb)))
    # the static split as the reference's traced_km rounds it in float32
    km_static = int(np.round(np.float32(min(max(k_m_frac, 0.0), 1.0))
                             * np.float32(kb)))
    inv_n = reciprocal(n_clients)

    def local_grad(w_flat: Tensor, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, Tensor]:
        """(loss, the flat float32 gradient padded to nb·block)."""
        xs = [w_flat[offsets[i]:offsets[i + 1]].view(leaf.shape)
              .to(leaf.dtype).detach().requires_grad_(True)
              for i, (_, leaf) in enumerate(leaves)]
        with torch.enable_grad():
            loss = tr.loss_fn(tree_util.unflatten(paths, xs), cfg, batch)[0]
            grads = torch.autograd.grad(loss, xs, materialize_grads=True)
        gb = torch.zeros(d_pad, dtype=torch.float32, device=w_flat.device)
        torch.cat([g.reshape(-1).to(torch.float32) for g in grads],
                  out=gb[:d])
        return loss.detach(), gb.view(nb, block)

    def core(w_flat, g_prev, age_b, ctrl_vec, batch, seed, draws):
        dev = w_flat.device
        for key in ("tokens", "labels"):
            if tuple(batch[key].shape) != (local_batch, seq_len):
                raise ValueError(f"batch[{key!r}] has shape "
                                 f"{tuple(batch[key].shape)}, expected "
                                 f"{(local_batch, seq_len)}")
        drawn = dict(draws or {})
        if not {"h", "z"} <= set(drawn):
            drawn = {**fl_oac_draws(int(seed), n_clients, kb, block, dev),
                     **drawn}
        loss, gb_local = local_grad(w_flat, batch)
        with torch.no_grad():
            # -- shared selection (replicated inputs: equal on every rank)
            cstate = None
            km = km_static
            if adaptive_km:
                cstate = budget.controller_state_from_vec(ctrl_vec)
                km = traced_km(kb, cstate["k_m_frac"])
            gp = torch.zeros(d_pad, dtype=torch.float32, device=dev)
            gp[:d] = g_prev
            gp = gp.view(nb, block)
            score = (gp * gp).sum(dim=1)
            mask_sel, _ = fair_k_masks_dynamic(score, age_b, kb, km)
            idx = mask_to_indices(mask_sel, kb)
            # -- OAC uplink: only the selected blocks ride the channel
            h = drawn["h"][collectives.axis_index(mesh)]
            if baseline:
                agg = collectives.psum(h * gb_local, mesh, axes)
                fresh = agg[idx] * inv_n
            elif one_bit:
                votes = torch.where(gb_local[idx] >= 0.0, 1, -1).to(
                    torch.int8)
                votes = collectives.psum(votes, mesh, ("model",)).to(
                    torch.float16)
                votes = collectives.psum(votes, mesh, rest)
                fresh = torch.where(votes >= 0.0, 1.0, -1.0)
            else:
                fresh = collectives.psum(h * gb_local[idx], mesh, axes) * inv_n
            fresh = fresh + (noise_std / n_clients) * drawn["z"]
            # -- Eq. (8)-(10) at block granularity, ages clipped at AGE_CAP
            g_new = gp.index_copy_(0, idx, fresh)
            age_next = torch.clamp((age_b + 1.0).index_fill_(0, idx, 0.0),
                                   max=AGE_CAP)
            ctrl_next = None
            if adaptive_km:
                _, age_hist = ref.strided_hists_ref(
                    score, age_next,
                    torch.ones(nb, dtype=torch.bool, device=dev),
                    packing.hist_stride(nb))
                ctrl_next = budget.controller_state_to_vec(
                    bctrl.update(cstate, age_hist))
            g_flat = g_new.reshape(-1)[:d]
            w_next = w_flat - 0.01 * g_flat.to(w_flat.dtype)
            loss_mean = collectives.pmean(loss.clone(), mesh, axes)
        return (w_next, g_flat.to(g_prev.dtype), age_next, ctrl_next,
                loss_mean)

    if adaptive_km:
        def fn(w_flat, g_prev, age_b, ctrl_vec, batch, seed, draws=None):
            return core(w_flat, g_prev, age_b, ctrl_vec, batch, seed, draws)
    else:
        def fn(w_flat, g_prev, age_b, batch, seed, draws=None):
            w, g, a, _, loss = core(w_flat, g_prev, age_b, None, batch, seed,
                                    draws)
            return w, g, a, loss

    meta = {"kind": "fl_oac", "d": d, "blocks": nb, "kb": kb,
            "n_clients": n_clients, "rho": rho, "baseline": baseline,
            "one_bit": one_bit, "adaptive_km": adaptive_km,
            "scans": {"layers": cfg.n_scan_blocks}}
    return StepBundle(fn, meta)


__all__ = ["OacServerConfig", "StepBundle", "make_train_step",
           "abstract_server_state", "init_sharded_caches",
           "make_prefill_step", "make_serve_step", "make_fl_oac_step",
           "abstract_params", "ravel_params", "fl_oac_draws",
           "train_input_specs", "init_server_state", "server_layout",
           "state_from_numpy", "server_draws", "leaf_draws",
           "fairk_threshold_masks", "TAG_NOISE", "TAG_FADING", "TAG_CSI",
           "TAG_FADE", "TAG_CHURN", "TAG_LEAF", "TAG_FL_OAC"]
