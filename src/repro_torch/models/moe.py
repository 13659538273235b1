"""Mixture-of-Experts FFN with per-row capacity (``repro.models.moe``).

The reference routes with dense one-hot ``(B, S, E, C)`` dispatch and
combine einsums, the GShard form that XLA partitions into all-to-alls on
a TPU mesh.  On one card the same function is an index form: each kept
``(token, choice)`` is scattered into its ``(expert, slot)`` row of the
``(B, E, C, D)`` expert input (a pure copy, as the one-hot product of a
single nonzero term is), and each token gathers its ``K`` expert outputs
back, weighted by its gate in the compute dtype, the ``K`` terms summed
in float32 and rounded once.  Nothing is sized by the data: dropped
choices add zeros, so the route makes no host sync.

Routing is the reference's: float32 softmax over experts, the top ``k``
with ties toward the lower expert index (a stable descending sort:
``torch.topk`` promises no tie order), gates renormalized, a choice's
slot the exclusive running count of its expert over the row's flattened
``(s, k)`` order, dropped where the slot reaches the capacity
``max(int(S·K·f/E) + 1, 4)``.  ``decode_mode`` with one token per row
merges the batch into one routing group with a capacity floor of 2.  The
Switch load-balance loss is returned beside the output.

On a mesh (``par``, ``models.parallel``) a rank runs its batch rows, whose
routing is the global rows' (routing and capacity are per row); the
load-balance loss's token fractions are averaged over the row axes, so
the loss is the global batch's.  With the reference's
``expert_shard_axis`` pin (``par.experts``) the expert weights are the
rank's ``E/M`` experts: the dispatched ``(B, E, C, D)`` input keeps the
rank's experts' slots, only those run, and their outputs are gathered
back (the gather's backward keeps the rank's slots of the gradient, the
slice's gathers them, so every rank holds the same activations and
gradients).  Where the experts do not divide ``model`` and "moe" splits
(``par.split``), the reference's fallback spec splits ``wg`` / ``wu`` by
their hidden columns and ``wd`` by its output columns (the expert leaf's
path ``ffn/wd`` misses the row rule of ``ffn/wd/w``), so each rank holds
every expert's block of both: the dispatched input and the gates enter
whole (their gradients summed over ``model``), the rank's hidden units
are gathered over ``model`` before ``wd`` (their gradient
reduce-scattered back), and the rank's output columns after the combine.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _normal, dense_init
from repro_torch.models.parallel import gather_dim, gather_seq, slice_dim

Tensor = torch.Tensor


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, mlp_type: str,
             dtype, lead=()) -> Dict:
    """The router (float32 whatever ``dtype`` is) and the ``(E, d_in,
    d_out)`` expert stacks; ``lead`` prepends stacking axes."""
    lead = tuple(lead)

    def expert_mat(d_in, d_out, scale=1.0):
        w = (scale / (d_in ** 0.5)) * _normal(gen, lead + (n_experts, d_in,
                                                           d_out))
        return w.to(dtype)

    p = {"router": dense_init(gen, d_model, n_experts, torch.float32,
                              lead=lead),
         "wu": expert_mat(d_model, d_ff),
         "wd": expert_mat(d_ff, d_model, scale=0.5)}
    if mlp_type == "swiglu":
        p["wg"] = expert_mat(d_model, d_ff)
    return p


def capacity_per_row(seq: int, n_experts: int, top_k: int,
                     factor: float) -> int:
    return max(int(seq * top_k * factor / n_experts) + 1, 4)


def route(probs: Tensor, top_k: int, cap: int
          ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """(gates (B,S,K) float32 renormalized, expert (B,S,K) int64, slot
    (B,S,K) int64, kept (B,S,K) bool) from the router's ``probs``."""
    b, s, n_experts = probs.shape
    expert = torch.sort(probs, dim=-1, descending=True,
                        stable=True).indices[..., :top_k]
    gates = torch.gather(probs, -1, expert)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat = expert.reshape(b, s * top_k)
    onehot = (flat[..., None] == torch.arange(
        n_experts, device=probs.device)).to(torch.int32)        # (B,SK,E)
    before = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(before, -1, flat[..., None])[..., 0].to(torch.int64)
    slot = slot.reshape(b, s, top_k)
    return gates, expert, slot, slot < cap


def moe_ffn(p: Dict, x: Tensor, *, top_k: int, capacity_factor: float,
            mlp_type: str, compute_dtype, decode_mode: bool = False,
            par=None) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, the aux loss, a float32
    scalar)."""
    orig_shape = x.shape
    if decode_mode and x.shape[1] == 1 and x.shape[0] > 1:
        x = x.reshape(1, orig_shape[0], orig_shape[2])
    b, s, d = x.shape
    n_experts = p["router"]["w"].shape[-1]
    if decode_mode:
        cap = max(2, int(s * top_k * capacity_factor / n_experts) + 1)
    else:
        cap = capacity_per_row(s, n_experts, top_k, capacity_factor)
    cdt = compute_dtype

    logits = torch.matmul(x.to(torch.float32),
                          p["router"]["w"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                       # (B,S,E)
    gates, expert, slot, kept = route(probs, top_k, cap)

    # dispatch: each kept choice's token row into its (b, e, c) slot;
    # a dropped choice adds zeros to a clamped slot
    row = (torch.arange(b, device=x.device)[:, None, None] * n_experts
           + expert) * cap + torch.clamp(slot, max=cap - 1)     # (B,S,K)
    xc = x.to(cdt)
    src = torch.where(kept[..., None], xc[:, :, None, :], 0.0)
    expert_in = torch.zeros((b * n_experts * cap, d), dtype=cdt,
                            device=x.device).index_put(
        (row.reshape(-1),), src.reshape(-1, d), accumulate=True)
    expert_in = expert_in.reshape(b, n_experts, cap, d)
    pinned = par is not None and par.experts
    split = par is not None and par.splits("moe")
    if split:
        expert_in = par.partial(expert_in)
    if pinned:
        expert_in = slice_dim(expert_in, par.mesh, par.experts, 1)

    if mlp_type == "swiglu":
        gate = F.silu(torch.einsum("becd,edf->becf", expert_in,
                                   p["wg"].to(cdt)))
        up = torch.einsum("becd,edf->becf", expert_in, p["wu"].to(cdt))
        hidden = gate * up
    else:
        hidden = F.gelu(torch.einsum("becd,edf->becf", expert_in,
                                     p["wu"].to(cdt)), approximate="tanh")
    if split:
        hidden = gather_seq(hidden, par.mesh, par.tp, -1)
    expert_out = torch.einsum("becf,efd->becd", hidden, p["wd"].to(cdt))
    if pinned:
        expert_out = gather_dim(expert_out, par.mesh, par.experts, 1)

    # combine: each token's K expert rows, weighted by its gate in the
    # compute dtype, summed in float32 and rounded once
    picked = expert_out.reshape(b * n_experts * cap, -1)[row.reshape(-1)]
    weight = torch.where(kept, gates.to(cdt), 0.0).to(torch.float32)
    if split:
        weight = par.partial(weight)
    d_out = expert_out.shape[-1]
    out = (picked.reshape(b, s, top_k, d_out).to(torch.float32)
           * weight[..., None]).sum(2).to(cdt)
    if split:
        out = gather_dim(out, par.mesh, par.tp, -1)

    # Switch-transformer load-balance auxiliary loss
    frac_tokens = (expert[..., 0:1] == torch.arange(
        n_experts, device=x.device)).to(torch.float32).mean(dim=(0, 1))
    if par is not None and not decode_mode:
        frac_tokens = par.row_mean(frac_tokens)
    frac_probs = probs.mean(dim=(0, 1))
    aux = n_experts * torch.sum(frac_tokens * frac_probs)
    return out.reshape(orig_shape).to(x.dtype), aux
