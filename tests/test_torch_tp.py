"""The tensor-parallel primitives of ``repro_torch.models.parallel`` and the
split parts of the model that use them, on 4 gloo ranks (one group for
the file, through ``tests/rankutil.py``), each against the whole
computation on one rank, forward and backward, in float32, to 1e-6
relative (L2):

* column-parallel (``copy_to``: the input's gradient summed over
  ``model``) and row-parallel (``reduce_from``: the output summed), with
  and without the sequence slice (``gather_seq`` / ``scatter_seq``);
* the vocab-parallel embedding lookup (``transformer._embed``: masked to
  the rank's block, summed over ``model``) and cross-entropy
  (``transformer._vocab_parallel_nll``: float32 all-reduces of the
  maximum, the sum of exponentials and the target logit);
* the Mamba-2 gated RMSNorm over the rank's channels
  (``mamba2._split_gated_norm``: the sum of squares all-reduced);
* the per-block gradient reduce-scatter (``gather_param``'s backward) on
  a (2, 2) mesh: the rank's block of the gradient summed over the batch
  axis lands in a sink of the local shape, with ``model`` gathered and
  narrowed, and with ``model`` kept local (a split leaf);
* the sharded ``grads_fn`` of reduced ``granite-moe-3b-a800m`` on a
  (1, 4) mesh, one expert a rank (the "experts" split, which the
  reference does not pin): the loss (relative) and the rank's blocks of
  the gradient tree (relative L2 over the tree) against the single
  process's ``grads_fn`` on the same global batch, to 1e-5, the
  tolerances ``chip_smoke.py``'s sharded phase holds the split step to
  on the card (a whole step sums in other orders than one primitive:
  measured 1.2e-6 on the CPU).

The whole computation runs on every rank from the same seeded inputs;
each rank compares its own block.
"""

import json

import pytest
from rankutil import run_ranks

pytestmark = pytest.mark.sharded

TOL = 1e-6
STEP_TOL = 1e-5

SCRIPT = r"""
import dataclasses, json
import torch
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mamba2, transformer as tr
from repro_torch.models.layers import rmsnorm
from repro_torch.models.parallel import (Parallel, copy_to, gather_param,
                                         gather_seq, reduce_from,
                                         scatter_seq)

torch.manual_seed(0)
tp_mesh = make_mesh((1, 4), ("data", "model"), "cpu")
dp_mesh = make_mesh((2, 2), ("data", "model"), "cpu")
TP = ("model",)
r = RANK
B, S, D, F = 2, 8, 12, 16
out = {}


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def leaf(t):
    return t.clone().requires_grad_(True)


def blk(t, dim, n=4, i=None):
    i = r if i is None else i
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


x, w = torch.randn(B, S, D), torch.randn(D, F)
w2, dy = torch.randn(F, D), torch.randn(B, S, F)
dy2 = torch.randn(B, S, D)
xf, wf = leaf(x), leaf(w)
(xf @ wf * dy).sum().backward()

# column-parallel
xl, wl = leaf(x), leaf(blk(w, 1))
y = copy_to(xl, tp_mesh, TP) @ wl
(y * blk(dy, 2)).sum().backward()
out["column forward"] = rel(y, blk(xf @ wf, 2))
out["column input grad"] = rel(xl.grad, xf.grad)
out["column weight grad"] = rel(wl.grad, blk(wf.grad, 1))

# sequence-parallel column input: the slice gathered, its gradient
# reduce-scattered
xs, wl = leaf(blk(x, 1)), leaf(blk(w, 1))
y = gather_seq(xs, tp_mesh, TP) @ wl
(y * blk(dy, 2)).sum().backward()
out["sp column forward"] = rel(y, blk(xf @ wf, 2))
out["sp column input grad"] = rel(xs.grad, blk(xf.grad, 1))

# row-parallel, whole and as the sequence slice
h = torch.randn(B, S, F)
hf, w2f = leaf(h), leaf(w2)
(hf @ w2f * dy2).sum().backward()
for name, sp in (("row", False), ("sp row", True)):
    hl, wl = leaf(blk(h, 2)), leaf(blk(w2, 0))
    part = hl @ wl
    y = scatter_seq(part, tp_mesh, TP) if sp else reduce_from(part, tp_mesh,
                                                              TP)
    want = blk(hf @ w2f, 1) if sp else hf @ w2f
    (y * (blk(dy2, 1) if sp else dy2)).sum().backward()
    out[f"{name} forward"] = rel(y, want)
    out[f"{name} input grad"] = rel(hl.grad, blk(hf.grad, 2))
    out[f"{name} weight grad"] = rel(wl.grad, blk(w2f.grad, 0))

# the vocab-parallel lookup and cross-entropy
cfg = dataclasses.replace(get_config("qwen2.5-32b", reduced_variant=True),
                          compute_dtype="float32")
V = cfg.vocab
par = Parallel(tp_mesh, tp=TP, split=frozenset({"vocab"}))
emb = torch.randn(V, D)
tokens = torch.randint(0, V, (B, S), dtype=torch.int32)
ef, el = leaf(emb), leaf(blk(emb, 0))
xe = tr._embed({"embed": ef}, cfg, tokens)
(xe * dy2).sum().backward()
ye = tr._embed({"embed": el}, cfg, tokens, par)
(ye * dy2).sum().backward()
out["vocab lookup forward"] = rel(ye, xe)
out["vocab lookup grad"] = rel(el.grad, blk(ef.grad, 0))
logits, labels = 3 * torch.randn(B, S, V), torch.randint(0, V, (B, S))
lf, ll = leaf(logits), leaf(blk(logits, 2))
want = -torch.gather(torch.log_softmax(lf, -1), -1, labels[..., None])[..., 0]
want.sum().backward()
nll = tr._vocab_parallel_nll(ll, labels, par)
nll.sum().backward()
out["vocab cross-entropy forward"] = rel(nll, want)
out["vocab cross-entropy grad"] = rel(ll.grad, blk(lf.grad, 2))

# the Mamba-2 gated norm over the rank's channels
mcfg = get_config("mamba2-370m", reduced_variant=True)
C = mcfg.d_inner
yg, scale, dyg = torch.randn(B, S, C), 1 + torch.rand(C), torch.randn(B, S, C)
yf, sf = leaf(yg), leaf(scale)
(rmsnorm({"scale": sf}, yf, mcfg.norm_eps) * dyg).sum().backward()
yl, sl = leaf(blk(yg, 2)), leaf(scale)
got = mamba2._split_gated_norm({"scale": sl}, yl, mcfg,
                               Parallel(tp_mesh, tp=TP))
(got * blk(dyg, 2)).sum().backward()
out["gated norm forward"] = rel(got, blk(rmsnorm({"scale": scale}, yg,
                                                 mcfg.norm_eps), 2))
out["gated norm input grad"] = rel(yl.grad, blk(yf.grad, 2))
out["gated norm scale grad"] = rel(sl.grad, sf.grad)

# the per-block gradient reduce-scatter into a sink of the local shape
d_i, m_i = r // 2, r % 2
W = torch.randn(8, 6)
G = [torch.randn(8, 6) for _ in range(2)]          # each data row's grad
ROWS = ("data",)
for name, entries, local in (
        ("sink, model gathered", [(0, ROWS), (1, TP)], False),
        ("sink, model local", [(0, ROWS)], True)):
    x_blk = leaf(blk(blk(W, 0, 2, d_i), 1, 2, m_i))
    sink = torch.zeros_like(x_blk)
    whole = gather_param(x_blk, dp_mesh, entries, sink, ROWS)
    g = blk(G[d_i], 1, 2, m_i) if local else G[d_i]
    (whole * g).sum().backward()
    want = blk(blk(G[0] + G[1], 0, 2, d_i), 1, 2, m_i)
    out[name] = rel(sink, want)
    out[name + " hands nothing on"] = float(x_blk.grad is not None)
    out[name + " gathered"] = rel(whole, W if not local
                                  else blk(W, 1, 2, m_i))

# one expert a rank: the sharded grads_fn against the single process's
from repro_torch import tree as tree_util
from repro_torch.configs import InputShape
from repro_torch.launch import sharding, steps
mcfg = dataclasses.replace(get_config("granite-moe-3b-a800m",
                                      reduced_variant=True),
                           compute_dtype="float32")
shape = InputShape("t", 32, 4, "train")
single = steps.make_train_step(mcfg, shape, None, n_micro=2, device="cpu")
split = steps.make_train_step(mcfg, shape, tp_mesh, n_micro=2, device="cpu")
params = tr.init_lm_seeded(mcfg, 0, "cpu")
batch = {k: torch.randint(0, mcfg.vocab, (2, 2, 32), dtype=torch.int32)
         for k in ("tokens", "labels")}
loss1, g1 = single.grads_fn(params, batch)
loss2, g2 = split.grads_fn(sharding.local_tree(params, split.in_specs[0],
                                               tp_mesh), batch)
want = sharding.local_tree(g1, split.in_specs[0], tp_mesh)
pairs = list(zip(tree_util.leaves(g2), tree_util.leaves(want)))
out["one expert a rank: loss"] = abs(float(loss2 - loss1) / float(loss1))
out["one expert a rank: gradients"] = float(sum(
    ((a.double() - b.double()) ** 2).sum() for (_, a), (_, b) in pairs)
    ** 0.5 / sum((b.double() ** 2).sum() for _, (_, b) in pairs) ** 0.5)
out["one expert a rank: split"] = split.meta["tensor_parallel"]

print(json.dumps(out))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    outs = run_ranks(SCRIPT, 4, str(tmp_path_factory.mktemp("tp")))
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


CHECKS = ["column forward", "column input grad", "column weight grad",
          "sp column forward", "sp column input grad",
          "row forward", "row input grad", "row weight grad",
          "sp row forward", "sp row input grad", "sp row weight grad",
          "vocab lookup forward", "vocab lookup grad",
          "vocab cross-entropy forward", "vocab cross-entropy grad",
          "gated norm forward", "gated norm input grad",
          "gated norm scale grad",
          "sink, model gathered", "sink, model gathered gathered",
          "sink, model local", "sink, model local gathered"]


@pytest.mark.parametrize("name", CHECKS)
def test_matches_the_whole_computation(results, name):
    for rank, res in enumerate(results):
        assert res[name] <= TOL, (rank, name, res[name])


@pytest.mark.parametrize("name", ["one expert a rank: loss",
                                  "one expert a rank: gradients"])
def test_one_expert_a_rank_matches_the_single_process(results, name):
    for rank, res in enumerate(results):
        assert res["one expert a rank: split"] == ["attn", "experts",
                                                   "vocab"]
        assert res[name] <= STEP_TOL, (rank, name, res[name])


@pytest.mark.parametrize("name", ["sink, model gathered hands nothing on",
                                  "sink, model local hands nothing on"])
def test_gathered_leaf_gradient_goes_only_to_the_sink(results, name):
    for res in results:
        assert res[name] == 0.0


# ---------------------------------------------------------------------------
# the serving steps' gather plan on the production meshes (no process group)
# ---------------------------------------------------------------------------

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _serving_and_train(arch, mesh_name):
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tr
    mesh = AbstractMesh(*MESHES[mesh_name])
    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    cache_abs = tr.cache_specs(cfg, shape.global_batch, shape.seq_len)
    serving = steps._sharded_serving(cfg, mesh, shape.global_batch,
                                     cache_abs)
    train = steps.make_train_step(cfg, SHAPES["train_4k"], mesh, oac=None,
                                  device="cpu")
    return mesh, serving, train


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", [
    "arctic-480b", "deepseek-67b", "granite-34b", "granite-moe-3b-a800m",
    "internvl2-1b", "jamba-1.5-large-398b", "mamba2-370m",
    "mistral-large-123b", "qwen2.5-32b", "whisper-base"])
def test_serving_plan_keeps_split_leaves_on_their_model_block(arch,
                                                              mesh_name):
    """The sharded serving steps' gather plan on a fake production mesh:
    no leaf of a part in ``tp_split`` is gathered over ``model`` (an
    expert leaf belongs to "experts" or "moe"), the plan is the train
    step's leaf by leaf (``steps._partition`` of the pinned config, the
    train step's parameter specs and split), and ``model`` carries the
    split parts as ``tp``."""
    from repro_torch import tree as tree_util
    from repro_torch.launch import sharding, steps
    from repro_torch.models.parallel import tp_split
    mesh, (cfg, p_specs, _, plan, par), train = _serving_and_train(
        arch, mesh_name)
    split = tp_split(cfg, mesh)
    assert par.split == split and split
    assert par.tp == ("model",) and par.float32_sums
    assert train.meta["tensor_parallel"] == sorted(split)
    assert train.in_specs[0] == p_specs
    assert plan == steps._partition(cfg, mesh)[4]
    pairs = tree_util.leaves(steps.abstract_params(cfg))
    assert len(plan) == len(pairs)
    kept = 0
    for (path, leaf), (_, entries) in zip(pairs, plan):
        part = steps._tp_part(sharding.path_str(path), leaf.dim())
        if part in split or (part == "moe" and "experts" in split):
            kept += 1
            assert all("model" not in axes for _, axes in entries), path
    assert kept > 0


# ---------------------------------------------------------------------------
# attention's split over ``model``: even heads and uneven runs of whole heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [4, 16])
@pytest.mark.parametrize("n_heads", [2, 6, 8, 14, 24, 40, 56])
def test_head_ranges_cover_every_head_once(n_heads, m):
    """``parallel.head_range``: the ranks' runs are contiguous, in rank
    order, cover every head exactly once and hold ⌊H/m⌋ or ⌈H/m⌉ heads
    each (none on some ranks where H < m)."""
    from repro_torch.models.parallel import head_range
    runs = [head_range(n_heads, r, m) for r in range(m)]
    assert runs[0][0] == 0 and runs[-1][1] == n_heads
    for (_, h1), (h0, _) in zip(runs, runs[1:]):
        assert h1 == h0
    sizes = {h1 - h0 for h0, h1 in runs}
    assert sizes <= {n_heads // m, -(-n_heads // m)}
    covered = [h for h0, h1 in runs for h in range(h0, h1)]
    assert covered == list(range(n_heads))


# the parts split over ``model`` on the production meshes: "attn"
# wherever ``n_heads·head_dim`` divides the 16 ranks
SPLITS = {
    "arctic-480b": ["attn", "experts", "ffn", "vocab"],
    "deepseek-67b": ["attn", "ffn", "vocab"],
    "granite-34b": ["attn", "ffn", "vocab"],
    "granite-moe-3b-a800m": ["attn", "moe"],
    "internvl2-1b": ["attn", "ffn"],
    "jamba-1.5-large-398b": ["attn", "experts", "ffn", "ssm", "vocab"],
    "mamba2-370m": ["ssm"],
    "mistral-large-123b": ["attn", "ffn", "vocab"],
    "qwen2.5-32b": ["attn", "ffn", "vocab"],
    "whisper-base": ["attn", "ffn"],
}
# heads that split evenly over 16 with whole kv groups (the even path)
EVEN_HEADS = ("deepseek-67b", "granite-34b", "jamba-1.5-large-398b",
              "mistral-large-123b")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(SPLITS))
def test_attention_splits_wherever_the_spec_splits_wq(arch, mesh_name):
    """On a fake production mesh ``tp_split`` names "attn" exactly where
    the spec puts ``model`` on ``wq``'s columns (``n_heads·head_dim``
    dividing it) — the even path (``heads_split``) for the models whose
    heads divide, uneven runs for qwen2.5-32b, arctic-480b, internvl2-1b,
    granite-moe-3b-a800m and whisper-base — and the plan keeps every
    ``wq`` / ``wo`` on its ``model`` block, gathered over the FSDP axes
    only, as the even path's always was.  The dry run traces rank 0, or
    for uneven runs the first rank with the most heads."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, sharding, steps
    from repro_torch.launch.mesh import AbstractMesh, fsdp_axes
    from repro_torch.models.parallel import head_range, heads_split
    mesh = AbstractMesh(*MESHES[mesh_name])
    cfg = steps._with_expert_axis(get_config(arch), mesh)
    params_abs, p_specs, split, _, plan = steps._partition(cfg, mesh)
    assert sorted(split) == SPLITS[arch]
    divides = bool(cfg.n_heads) and cfg.n_heads * cfg.head_dim % 16 == 0
    assert ("attn" in split) == divides
    even = heads_split(cfg.n_heads, cfg.n_kv_heads, 16)
    assert even == (arch in EVEN_HEADS)
    rank = dryrun.traced_rank(cfg, multi_pod=mesh_name == "2x16x16")
    if even or "attn" not in split:
        assert rank == 0
    else:
        runs = [hi - lo for lo, hi in (head_range(cfg.n_heads, r, 16)
                                       for r in range(16))]
        assert runs[rank] == max(runs) > runs[0]
    fsdp = fsdp_axes(mesh)
    seen = 0
    for (path, _), spec, (_, entries) in zip(tree_util.leaves(params_abs),
                                             sharding.spec_leaves(p_specs),
                                             plan):
        s = sharding.path_str(path)
        if not s.endswith(("wq/w", "wo/w")):
            continue
        seen += 1
        # (stack, D, H·hd) / (stack, H·hd, D): model on the heads' side
        body = tuple(spec)[1:]
        heads_dim = 1 if s.endswith("wq/w") else 0
        assert sharding.entry_axes(body[heads_dim]) == ("model",), s
        assert entries == [(1 - heads_dim, fsdp)], (s, entries)
    assert (seen > 0) == (arch != "mamba2-370m")
