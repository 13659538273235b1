"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and carries the ``gpu`` marker; the
``cuda`` fixture decides at run time whether one is present and skips
otherwise.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Exactness as in ``chip_smoke.py``: ``g_t``, ``residual'``, merged values
and top-k values bit for bit; ages, counts, histograms, signs, energies
and top-k indices exactly.  Imports neither JAX
nor the JAX package, so it runs where only PyTorch is installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine
from repro_torch.kernels import aou_merge, block_topk, fairk_update, ops
from repro_torch.kernels import ref, sign_mv

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    assert torch.equal(nan_a, nan_b)
    if a.dtype == torch.float32:
        assert torch.equal(a[~nan_a].view(torch.int32),
                           b[~nan_b].view(torch.int32))
    else:
        assert torch.equal(a, b)


def _device_ops(fn):
    """The device operations of one warm call of ``fn`` by name, from
    ``torch.profiler``.  A session with no device records at all is the
    tracer dropping them (the kernel surely ran; most often when the
    session's only work is one launch made right after it starts): the
    call waits 10 ms into the session, and an empty session is asked
    again, up to five times."""
    import time
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
        ops_on_card = {ev.key: ev.count for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA}
        if ops_on_card:
            break
    return ops_on_card


def _inputs(d, seed, dev, nonfinite=False):
    rng = np.random.default_rng(seed)
    g = (rng.standard_t(3, size=d) * 0.1).astype(np.float32)
    g[rng.choice(d, max(1, d // 200), replace=False)] = -0.0
    age = rng.integers(0, 131, size=d).astype(np.float32)
    if d > 600:
        age[300:341] = -1.0
    age[-3:] = -1.0
    fresh = np.where(rng.random(d) < 0.5, 1.0, -1.0).astype(np.float32)
    if nonfinite:
        pos = rng.choice(d, min(d, 3 * max(1, d // 300)), replace=False)
        g[pos[0::3]] = np.nan
        g[pos[1::3]] = np.inf
        g[pos[2::3]] = -np.inf
        fresh[rng.choice(d, max(1, d // 500), replace=False)] = np.nan
    to = lambda a: torch.as_tensor(a, device=dev)
    return {"g": to(g), "g_prev": to(rng.normal(size=d).astype(np.float32)),
            "age": to(age),
            "res": to((rng.normal(size=d) * 0.05).astype(np.float32)),
            "fresh": to(fresh),
            "tm": float(np.quantile(np.abs(np.nan_to_num(g, posinf=0.0,
                                                         neginf=0.0)), 0.9)),
            "ta": 60.5}


@pytest.mark.parametrize("d", [1, 255, 5000, 109_210, 1_000_003])
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("res,fresh,sanitize", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, True)])
def test_fairk_kernel_matches_plain(cuda, d, stats, res, fresh, sanitize):
    x = _inputs(d, seed=d, dev=cuda, nonfinite=sanitize)
    fn = ops.fairk_stats_update if stats else ops.fairk_ef_update
    for tm, ta in ((0.0, 0.0), (x["tm"], x["ta"]), (float("inf"), x["ta"])):
        kw = dict(residual=x["res"] if res else None,
                  fresh=x["fresh"] if fresh else None, sanitize=sanitize)
        k = fn(x["g"], x["g_prev"], x["age"], tm, ta, mode="kernel", **kw)
        p = fn(x["g"], x["g_prev"], x["age"], tm, ta, mode="plain", **kw)
        _same(k[0], p[0])
        _same(k[1], p[1])
        if res:
            _same(k[2], p[2])
        if stats:
            for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
                _same(k[3][key], p[3][key])


@pytest.mark.parametrize("n,k", [(1, 7), (10, 109_210), (50, 109_210),
                                 (3, 1_000_003)])
@pytest.mark.parametrize("noisy", [False, True])
def test_sign_kernels_match_plain(cuda, n, k, noisy):
    rng = np.random.default_rng(n + k)
    v = np.sign(rng.normal(size=(n, k))).astype(np.float32)
    v[rng.random((n, k)) < 0.05] = 0.0
    v[rng.random((n, k)) < 0.05] = -0.0
    votes = torch.as_tensor(v, device=cuda)
    noise = (torch.as_tensor(rng.normal(size=k).astype(np.float32),
                             device=cuda) if noisy else None)
    for a, b in zip(ops.sign_mv(votes, noise, mode="kernel"),
                    ops.sign_mv(votes, noise, mode="plain")):
        _same(a, b)
    energy = torch.as_tensor((2.0 * rng.integers(-n, n + 1, size=k)
                              ).astype(np.float32), device=cuda)
    for a, b in zip(ops.sign_from_energy(energy, noise, mode="kernel"),
                    ops.sign_from_energy(energy, noise, mode="plain")):
        _same(a, b)


def _chunk(c, d, dev, seed):
    """(c, d) effective gradients with NaN, ±0.0 and ±inf, made on the
    card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(c, d, generator=gen, device=dev)
    u = torch.rand(c, d, generator=gen, device=dev)
    x[u < 0.05] = 0.0
    x[(u >= 0.05) & (u < 0.1)] = -0.0
    x[(u >= 0.1) & (u < 0.11)] = float("nan")
    x[(u >= 0.11) & (u < 0.115)] = float("inf")
    x[(u >= 0.115) & (u < 0.12)] = -float("inf")
    return x


def _acc(k, dev, seed):
    """A non-zero accumulator: arbitrary floats, ±0.0 among them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randn(k, generator=gen, device=dev) * 7.0
    acc[: min(k, 2)] = torch.tensor([0.0, -0.0], device=dev)[: min(k, 2)]
    return acc


def _fold_both(acc, x, idx=None):
    """The fold's kernel and plain results on copies of ``acc``; the
    kernel's is the same tensor it was given."""
    k_acc, p_acc = acc.clone(), acc.clone()
    assert ops.vote_fold(k_acc, x, idx, mode="kernel") is k_acc
    ops.vote_fold(p_acc, x, idx, mode="plain")
    torch.cuda.synchronize()
    return k_acc, p_acc


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("c", [1, 10, 50])
@pytest.mark.parametrize("d", [1, 7, 109_210, 1_000_003])
def test_vote_fold_kernel_matches_plain(cuda, d, c, gathered):
    x = _chunk(c, d, cuda, seed=d + c)
    idx = None
    if gathered:                 # unsorted, about a fifth of the columns
        gen = torch.Generator(device=cuda).manual_seed(d)
        idx = torch.randperm(d, generator=gen, device=cuda)[:max(1, d // 5)]
    k = d if idx is None else idx.shape[0]
    _same(*_fold_both(_acc(k, cuda, seed=c), x, idx))


def test_vote_fold_kernel_takes_odd_views_and_selections(cuda):
    """Chunk views off an 8-byte boundary and with an odd row stride take
    the scalar path; a selection of one, repeated and unsorted indices."""
    d, c = 109_210, 10
    buf = _chunk(1, c * d + 3, cuda, seed=1)[0]
    wide = _chunk(c, d + 1, cuda, seed=2)
    views = {"offset by one float": buf[1:1 + c * d].view(c, d),
             "offset by two floats": buf[2:2 + c * d].view(c, d),
             "odd row stride": wide[:, :d],
             "odd row stride, offset": wide[:, 1:]}
    idxs = [None, torch.tensor([5], device=cuda),
            torch.tensor([d - 1, 0, 3, 3, 17], device=cuda),
            torch.randperm(d, device=cuda)[:21_842]]
    for name, x in views.items():
        assert x.stride(1) == 1, name
        for idx in idxs:
            k = d if idx is None else idx.shape[0]
            _same(*_fold_both(_acc(k, cuda, seed=3), x, idx))


@pytest.mark.parametrize("c,d", [(10, 109_210), (50, 21_842)])
def test_vote_fold_kernel_equals_the_composition_it_replaces(cuda, c, d):
    """``acc + sign_mv(one_bit(x[:, idx]))[1]``, the fold the trainer ran
    before, on the kernels: the same bits."""
    from repro_torch.core import quantize
    x = _chunk(c, d, cuda, seed=c)
    for idx in (None, torch.randperm(d, device=cuda)[:d // 5]):
        acc = _acc(d if idx is None else idx.shape[0], cuda, seed=4)
        sent = x if idx is None else x[:, idx]
        want = acc + ops.sign_mv(quantize.one_bit(sent).contiguous(),
                                 mode="kernel")[1]
        _same(ops.vote_fold(acc, x, idx, mode="kernel"), want)


@pytest.mark.parametrize("score", [False, True])
@pytest.mark.parametrize("noise", ["none", "noise", "z"])
@pytest.mark.parametrize("k", [1, 7, 21_842, 109_210, 1_000_003])
def test_sign_from_energy_fused_matches_plain(cuda, k, noise, score):
    gen = torch.Generator(device=cuda).manual_seed(k)
    energy = 2.0 * torch.randint(-25, 26, (k,), generator=gen,
                                 device=cuda).float()
    energy[: min(k, 2)] = torch.tensor([0.0, -0.0], device=cuda)[: min(k, 2)]
    if k > 5:
        energy[2:5] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf")], device=cuda)
    draw = torch.randn(k, generator=gen, device=cuda)
    kw = {"none": {}, "noise": {"noise": draw * 2.0},
          "z": {"z": draw, "noise_std": 2.0}}[noise]
    k_out = ops.sign_from_energy(energy, mode="kernel", score=score, **kw)
    p_out = ops.sign_from_energy(energy, mode="plain", score=score, **kw)
    assert len(k_out) == len(p_out) == (3 if score else 2)
    for a, b in zip(k_out, p_out):
        _same(a, b)


def test_one_bit_call_sites_are_one_device_operation(cuda):
    """After warm-up, one ``ops.vote_fold`` call (dense or gathered), the
    exact path's detection and the packed path's detection with its score
    each make exactly one device operation: the kernel."""
    from repro_torch.core import quantize
    d, k = 109_210, 21_842
    x = _chunk(10, d, cuda, seed=5)
    idx = torch.randperm(d, device=cuda)[:k]
    acc_d, acc_k = _acc(d, cuda, seed=6), _acc(k, cuda, seed=7)
    energy = 2.0 * torch.randint(-25, 26, (d,), device=cuda).float()
    z = torch.randn(d, device=cuda)
    calls = {
        "sign_mv_kernel": [lambda: ops.vote_fold(acc_d, x),
                           lambda: ops.vote_fold(acc_k, x, idx)],
        "sign_from_energy_kernel": [
            lambda: quantize.fsk_majority_from_energy(energy[:k], z[:k],
                                                      2.0),
            lambda: ops.sign_from_energy(energy, z=z, noise_std=2.0,
                                         score=True)]}
    for kernel, fns in calls.items():
        for fn in fns:
            ops_on_card = _device_ops(fn)
            assert sum(ops_on_card.values()) == 1, ops_on_card
            assert kernel in next(iter(ops_on_card)), ops_on_card


@pytest.mark.parametrize("d", [1, 255, 5000, 109_210, 1_000_003])
def test_aou_merge_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(d)
    g_new = rng.normal(size=d).astype(np.float32)
    g_new[rng.random(d) < 0.05] = -0.0
    g_new[: min(d, 3)] = [np.nan, np.inf, -np.inf][: min(d, 3)]
    age = rng.integers(0, 131, size=d).astype(np.float32)
    age[-1] = np.nan
    mask = (rng.random(d) < 0.3).astype(np.float32)
    mask[rng.random(d) < 0.01] = 0.5
    args = [torch.as_tensor(a, device=cuda) for a in (
        g_new, rng.normal(size=d).astype(np.float32), age, mask)]
    for a, b in zip(ops.aou_merge(*args, mode="kernel"),
                    ops.aou_merge(*args, mode="plain")):
        _same(a, b)


def _trapped(d, dev, gen, scale=1.0, offset=0):
    """A (d,) row of N(0, scale²) values with −0.0, NaN and ±inf, made on
    the card; with ``offset`` a view that many floats past the start of
    its storage (off a 16-byte boundary for 1-3)."""
    x = (torch.randn(d + offset, generator=gen, device=dev) * scale)[offset:]
    u = torch.rand(d, generator=gen, device=dev)
    x[u < 0.01] = -0.0
    x[(u >= 0.01) & (u < 0.012)] = float("nan")
    x[(u >= 0.012) & (u < 0.014)] = float("inf")
    x[(u >= 0.014) & (u < 0.016)] = -float("inf")
    return x


def _merge_state(d, k, dev, seed, offset=0):
    """A selection of k distinct unsorted coordinates and the state rows
    of both index forms, with the traps of the CPU tests: −0.0, NaN and
    ±inf in the fresh row, ``g_prev``, ``sent``, ``ef_sum`` and the score
    (on selected coordinates too); NaN ages, ages at and past ``AGE_CAP``
    and below −1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randperm(d, generator=gen, device=dev)[:k]
    age = torch.randint(0, 131, (d + offset,), generator=gen,
                        device=dev).float()[offset:]
    special = torch.tensor([float("nan"), 119.0, 120.0, 121.0, 130.0, -1.0,
                            -2.5], device=dev)
    age[idx[:len(special)]] = special[:min(k, len(special))]
    age[torch.rand(d, generator=gen, device=dev) < 0.01] = float("nan")
    x = {"idx": idx, "age": age,
         "sel_count": torch.randint(0, 9, (d + offset,), generator=gen,
                                    device=dev).float()[offset:]}
    for name, scale in (("g_prev", 1.0), ("ef_sum", 3.0), ("sent", 1.0),
                        ("noise", 1.0), ("score", 1.0)):
        x[name] = _trapped(d, dev, gen, scale, offset)
    traps = torch.tensor([-0.0, float("nan"), float("inf"), -float("inf")],
                         device=dev)
    x["g_prev"][idx[:4]] = traps[:min(k, 4)]
    x["sent"][idx[-4:]] = traps[-min(k, 4):]
    x["fresh"] = _trapped(k, dev, gen)
    x["z"] = torch.randn(k, generator=gen, device=dev)
    return x


TRAINER_FORMS = {"coherent": dict(superposed=True, noise_std=0.1),
                 "coherent_ef": dict(superposed=True, noise_std=0.1,
                                     ef=True),
                 "noiseless": dict(superposed=True, noise_std=0.0),
                 "one_bit_ef": dict(superposed=False, ef=True)}


def _trainer_both(x, superposed, noise_std=0.0, ef=False):
    kw = dict(n_clients=50, superposed=superposed, z=x["z"],
              noise_std=noise_std, ef_sum=x["ef_sum"] if ef else None)
    return [ops.aou_merge_by_indices(x["idx"], x["fresh"], x["g_prev"],
                                     x["age"], x["sel_count"], mode=m, **kw)
            for m in ("kernel", "plain")]


def _engine_both(x, noise, res):
    kw = dict(noise=x["noise"] if noise else None, noise_scale=0.1 / 50,
              score=x["score"] if res else None)
    return [ops.masked_merge_by_indices(x["idx"], x["sent"], x["g_prev"],
                                        x["age"], mode=m, **kw)
            for m in ("kernel", "plain")]


MERGE_SHAPES = [(1, 1), (7, 1), (7, 7), (109_210, 1), (109_210, 10_921),
                (109_210, 21_842), (109_210, 109_210), (2**24 + 3, 1),
                (2**24 + 3, 10_921), (2**24 + 3, 21_842),
                (2**24 + 3, 2**24 + 3)]


@pytest.mark.parametrize("d,k", MERGE_SHAPES)
def test_aou_merge_by_indices_kernel_matches_plain(cuda, d, k):
    x = _merge_state(d, k, cuda, seed=d + k)
    for form, kw in TRAINER_FORMS.items():
        k_out, p_out = _trainer_both(x, **kw)
        assert (k_out[4] is None) == (p_out[4] is None), form
        for a, b in zip(k_out, p_out):
            if a is not None:
                _same(a, b)


@pytest.mark.parametrize("d,k", MERGE_SHAPES)
def test_masked_merge_by_indices_kernel_matches_plain(cuda, d, k):
    x = _merge_state(d, k, cuda, seed=2 * d + k)
    for noise in (False, True):
        for res in (False, True):
            k_out, p_out = _engine_both(x, noise, res)
            assert (k_out[2] is None) == (not res)
            for a, b in zip(k_out, p_out):
                if a is not None:
                    _same(a, b)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_index_forms_take_views_off_a_16_byte_boundary(cuda, offset):
    """Every (d,) row a view 1-3 floats into its storage: the scalar
    path, the same bits."""
    x = _merge_state(109_210, 10_921, cuda, seed=offset, offset=offset)
    assert x["g_prev"].data_ptr() % 16 != 0
    for kw in TRAINER_FORMS.values():
        for a, b in zip(*_trainer_both(x, **kw)):
            if a is not None:
                _same(a, b)
    for a, b in zip(*_engine_both(x, True, True)):
        _same(a, b)


def test_index_forms_are_one_device_operation_and_one_launch(cuda):
    """After warm-up, one call of either index form at the exact path's
    shapes makes one device operation, the merge kernel, and counts one
    ``aou_merge`` launch; the plain mode counts none."""
    x = _merge_state(109_210, 10_921, cuda, seed=12)
    calls = [lambda: ops.aou_merge_by_indices(
                 x["idx"], x["fresh"], x["g_prev"], x["age"],
                 x["sel_count"], n_clients=50, superposed=True, z=x["z"],
                 noise_std=0.1, ef_sum=x["ef_sum"]),
             lambda: ops.masked_merge_by_indices(
                 x["idx"], x["sent"], x["g_prev"], x["age"],
                 noise=x["noise"], noise_scale=0.002, score=x["score"])]
    for fn in calls:
        ops_on_card = _device_ops(fn)
        assert sum(ops_on_card.values()) == 1, ops_on_card
        assert "aou_merge_idx_kernel" in next(iter(ops_on_card))
        before = aou_merge.LAUNCHES
        fn()
        assert aou_merge.LAUNCHES == before + 1
    before = aou_merge.LAUNCHES
    _trainer_both(x, superposed=False)
    _engine_both(x, True, True)
    assert aou_merge.LAUNCHES == before + 2


def test_index_form_equals_the_composition_it_replaces(cuda):
    """The trainer's old composition on the card, Eq. 7's tail as
    ``oac.finish_aggregate``, ``oac.reconstruct``, the mask,
    ``aou.update_age_by_indices``, the count and the EF residual: the
    same bits as one kernel call (so PyTorch's ``x / N`` on the card is
    ``x * (1 / N)``, as the kernel computes it)."""
    from repro_torch.core import aou, oac, selection
    x = _merge_state(109_210, 10_921, cuda, seed=13)
    idx, n = x["idx"], 50
    cfg = oac.ChannelConfig(fading="none", noise_std=0.1)
    fresh = oac.finish_aggregate(x["fresh"], x["z"], n, cfg)
    mask = selection.mask_from_indices(idx, 109_210)
    want = (oac.reconstruct(x["g_prev"], idx, fresh),
            aou.update_age_by_indices(x["age"], idx), mask,
            x["sel_count"] + mask, (x["ef_sum"] / n) * (1.0 - mask))
    got = ops.aou_merge_by_indices(idx, x["fresh"], x["g_prev"], x["age"],
                                   x["sel_count"], n_clients=n,
                                   superposed=True, z=x["z"], noise_std=0.1,
                                   ef_sum=x["ef_sum"], mode="kernel")
    for a, b in zip(got, want):
        _same(a, b)


def _topk_case(d, bs, m, kind):
    """Ties inside and across blocks (both signs, exact zeros) plus, by
    ``kind``: NaNs of both signs, infinities of both signs, every value
    of a block equal, or nothing more (``"ties"``)."""
    rng = np.random.default_rng(d + m)
    x = rng.normal(size=d).astype(np.float32)
    x[rng.random(d) < 0.2] = 1.25
    x[rng.random(d) < 0.1] = -1.25
    x[rng.random(d) < 0.05] = -0.0
    if kind == "nan":
        x[rng.random(d) < 0.01] = np.nan
        x[rng.random(d) < 0.01] = -np.nan
        x[:8] = [1.0, np.nan, 3.0, -np.nan, 3.0, 0.0, -0.0, 2.0]
    elif kind == "inf":
        x[rng.random(d) < 0.01] = np.inf
        x[rng.random(d) < 0.01] = -np.inf
    elif kind == "equal":
        x[:bs] = -2.5                      # first block: all one magnitude
        x[bs:2 * bs] = 0.0
    return x


@pytest.mark.parametrize("kind", ["ties", "nan", "inf", "equal"])
@pytest.mark.parametrize("d,bs,m", [(2**20, 4096, 16), (2**20, 4096, 164),
                                    (2**20, 1024, 8), (65_536, 256, 256),
                                    (3 * 16_384, 16_384, 33),
                                    (2 * 57_344, 57_344, 5), (1000, 1000, 1),
                                    (4 * 4096, 4096, 4096),
                                    (2 * 57_344, 57_344, 57_344),
                                    (4 * 2000, 2000, 1000),
                                    (3 * 1001, 1001, 7)])
def test_block_topk_kernel_matches_plain(cuda, d, bs, m, kind):
    xt = torch.as_tensor(_topk_case(d, bs, m, kind), device=cuda)
    kv, ki = ops.block_topk(xt, bs, m, mode="kernel")
    pv, pi = ops.block_topk(xt, bs, m, mode="plain")
    _same(kv, pv)
    _same(ki, pi)


def test_two_stage_topk_is_the_stable_top_k(cuda):
    d = 2**22
    x = torch.randn(d, generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    k = d // 100
    vals, idxs = ops.two_stage_topk(x, k, mode="kernel")
    ref_vals, ref_idx = torch.sort(x.abs(), descending=True, stable=True)
    _same(vals, ref_vals[:k])
    assert torch.equal(idxs.long(), ref_idx[:k])


@pytest.mark.parametrize("stats", [False, True])
def test_fairk_kernel_takes_unaligned_operands(cuda, stats):
    """Views one float past a 16-byte boundary take the scalar path."""
    x = _inputs(5001, seed=9, dev=cuda)
    g, g_prev, age, res = (x[k][1:] for k in ("g", "g_prev", "age", "res"))
    fn = ops.fairk_stats_update if stats else ops.fairk_ef_update
    k = fn(g, g_prev, age, x["tm"], x["ta"], residual=res, mode="kernel")
    p = fn(g, g_prev, age, x["tm"], x["ta"], residual=res, mode="plain")
    for a, b in zip(k[:3], p[:3]):
        _same(a, b)
    if stats:
        for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
            _same(k[3][key], p[3][key])


def test_fairk_stats_row_resets_between_calls(cuda):
    """Three calls in a row, each on other thresholds: the float32 row
    equals the plain version's every time, so the accumulator and the
    ticket the last block resets start at zero for the next call."""
    x = _inputs(109_210, seed=11, dev=cuda)
    for tm, ta in ((x["tm"], x["ta"]), (0.0, 0.0), (x["tm"] * 2, 30.5)):
        k = ops.fairk_stats_update(x["g"], x["g_prev"], x["age"], tm, ta,
                                   residual=x["res"], mode="kernel")
        p = ops.fairk_stats_update(x["g"], x["g_prev"], x["age"], tm, ta,
                                   residual=x["res"], mode="plain")
        for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
            assert k[3][key].dtype == torch.float32
            _same(k[3][key], p[3][key])


@pytest.mark.parametrize("d", [109_210, 2**22])
def test_fairk_stats_update_is_one_device_kernel(cuda, d):
    x = _inputs(d, seed=5, dev=cuda)
    tm = torch.tensor(x["tm"], device=cuda)
    ta = torch.tensor(x["ta"], device=cuda)
    ops_on_card = _device_ops(lambda: ops.fairk_stats_update(
        x["g"], x["g_prev"], x["age"], tm, ta, residual=x["res"]))
    assert sum(ops_on_card.values()) == 1, ops_on_card
    assert "fairk_kernel" in next(iter(ops_on_card))


def test_exact_engine_kernel_matches_plain(cuda):
    d = 109_210
    rng = np.random.default_rng(0)
    g_prev = torch.zeros(d, device=cuda)
    age = torch.zeros(d, device=cuda)
    engines = {m: engine.SelectionEngine(engine.EngineConfig(
        backend="exact", noise_std=0.1, n_clients=50, fused_stats=True,
        kernel_mode=m), d) for m in ("kernel", "plain")}
    for _ in range(5):
        g = torch.as_tensor(rng.normal(size=d).astype(np.float32),
                            device=cuda)
        noise = torch.as_tensor(rng.normal(size=d).astype(np.float32),
                                device=cuda)
        out = {m: e.select_and_merge(g, g_prev, age, noise=noise)
               for m, e in engines.items()}
        for a, b in zip(out["kernel"][:2], out["plain"][:2]):
            _same(a, b)
        g_prev, age = out["kernel"][:2]


def test_dispatch_launches_on_cuda_and_counts(cuda):
    x = _inputs(4096, seed=1, dev=cuda)
    before = (fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
              sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
              block_topk.LAUNCHES)
    ops.fairk_stats_update(x["g"], x["g_prev"], x["age"], 0.1, 3.0)
    ops.sign_mv(x["fresh"][None])
    ops.sign_from_energy(x["g"])
    ops.aou_merge(x["g"], x["g_prev"], x["age"], x["fresh"])
    ops.two_stage_topk(x["g"], 40, block_size=1024)
    ops.fairk_stats_update(x["g"], x["g_prev"], x["age"], 0.1, 3.0,
                           mode="plain")
    ops.aou_merge(x["g"], x["g_prev"], x["age"], x["fresh"], mode="plain")
    ops.block_topk(x["g"], 1024, 4, mode="plain")
    torch.cuda.synchronize()
    after = (fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES,
             sign_mv.SIGN_FROM_ENERGY_LAUNCHES, aou_merge.LAUNCHES,
             block_topk.LAUNCHES)
    assert after == tuple(b + 1 for b in before)


def test_fold_and_fused_detection_count_as_their_kernels(cuda):
    """``ops.vote_fold`` counts as a ``sign_mv`` launch and the fused
    detection as a ``sign_from_energy`` launch; their plain modes count
    nothing."""
    x = _chunk(4, 4096, cuda, seed=8)
    acc = torch.zeros(4096, device=cuda)
    before = (sign_mv.SIGN_MV_LAUNCHES, sign_mv.SIGN_FROM_ENERGY_LAUNCHES)
    ops.vote_fold(acc, x)
    ops.vote_fold(acc[:3], x, torch.tensor([4, 1, 9], device=cuda))
    ops.sign_from_energy(acc, z=x[0], noise_std=0.5, score=True)
    ops.vote_fold(acc, x, mode="plain")
    ops.sign_from_energy(acc, z=x[0], noise_std=0.5, mode="plain")
    torch.cuda.synchronize()
    assert (sign_mv.SIGN_MV_LAUNCHES, sign_mv.SIGN_FROM_ENERGY_LAUNCHES) == (
        before[0] + 2, before[1] + 1)


def test_wrappers_check_their_operands(cuda):
    x = _inputs(64, seed=2, dev=cuda)
    theta = torch.zeros((), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        fairk_update.fairk_update_cuda(x["g"].double(), x["g_prev"],
                                       x["age"], theta, theta)
    with pytest.raises(ValueError, match="shape"):
        fairk_update.fairk_update_cuda(x["g"], x["g_prev"][:10], x["age"],
                                       theta, theta)
    with pytest.raises(ValueError, match="one float32 value"):
        fairk_update.fairk_update_cuda(x["g"], x["g_prev"], x["age"],
                                       torch.zeros(2, device=cuda), theta)
    with pytest.raises(ValueError, match="contiguous"):
        sign_mv.sign_mv_cuda(torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="contiguous rows"):
        sign_mv.vote_fold_cuda(torch.zeros(8, device=cuda),
                               torch.zeros(8, 4, device=cuda).t())
    with pytest.raises(ValueError, match="int64"):
        sign_mv.vote_fold_cuda(torch.zeros(2, device=cuda),
                               torch.zeros(3, 8, device=cuda),
                               torch.tensor([1, 2], dtype=torch.int32,
                                            device=cuda))
    with pytest.raises(ValueError, match="shape"):
        sign_mv.vote_fold_cuda(torch.zeros(7, device=cuda),
                               torch.zeros(3, 8, device=cuda))
    with pytest.raises(ValueError, match="not both"):
        sign_mv.sign_from_energy_cuda(x["g"], x["g"], z=x["g"])
    with pytest.raises(ValueError, match="shape"):
        aou_merge.aou_merge_cuda(x["g"], x["g_prev"], x["age"][:10],
                                 x["fresh"])
    with pytest.raises(ValueError, match="divisible"):
        block_topk.block_topk_cuda(x["g"], 48, 4)
    with pytest.raises(ValueError, match="shared-memory"):
        block_topk.block_topk_cuda(torch.zeros(2**16, device=cuda), 2**16,
                                   4)


def test_index_form_wrapper_checks_its_operands(cuda):
    x = _merge_state(64, 8, cuda, seed=3)
    idx, row = x["idx"], x["fresh"]
    with pytest.raises(ValueError, match="int64"):
        aou_merge.merge_by_indices_cuda(idx.int(), row, x["g_prev"],
                                        x["age"], sel_count=x["sel_count"])
    with pytest.raises(ValueError, match="contiguous"):
        aou_merge.merge_by_indices_cuda(torch.stack([idx, idx], 1)[:, 0],
                                        row, x["g_prev"], x["age"],
                                        sel_count=x["sel_count"])
    with pytest.raises(ValueError, match="sel_count"):
        aou_merge.merge_by_indices_cuda(idx, row, x["g_prev"], x["age"])
    with pytest.raises(ValueError, match="shape"):
        aou_merge.merge_by_indices_cuda(idx, x["sent"], x["g_prev"],
                                        x["age"], sel_count=x["sel_count"])
    with pytest.raises(ValueError, match="shape"):
        aou_merge.merge_by_indices_cuda(idx, row, x["g_prev"], x["age"],
                                        arith=True)
    with pytest.raises(ValueError, match="float32"):
        aou_merge.merge_by_indices_cuda(idx, x["sent"], x["g_prev"],
                                        x["age"].double(), arith=True)


# --- the adaptive split and the sweep: kernel against plain trajectories --

def _small_task(cuda):
    """A narrow prototype CNN (16x16x1, widths (4, 6, 8), fc 16, 10
    classes) over 4 clients with H = 2, B = 3, from the port's own data
    and a seeded generator."""
    from repro_torch.data import partition, synthetic
    from repro_torch.models import cnn
    spec = synthetic.DatasetSpec("t", (16, 16, 1), 10, 400, 50,
                                 sparsity=0.1)
    (xtr, ytr), _ = synthetic.make_dataset(spec, seed=0)
    parts = partition.dirichlet_partition(ytr, 4, 0.3, seed=0)
    params = cnn.init_prototype_cnn(
        torch.Generator(device=cuda).manual_seed(1), (16, 16, 1), 10,
        (4, 6, 8), 16, device=cuda)

    def loss_fn(p, x, y):
        return cnn.softmax_xent(cnn.prototype_cnn(p, x), y)

    return params, loss_fn, lambda t: partition.client_batches(
        xtr, ytr, parts, 3, 2, seed=t)


@pytest.mark.parametrize("backend", ["exact", "packed"])
def test_adaptive_kernel_and_plain_trajectories_are_identical(cuda,
                                                              backend):
    from repro_torch.core.oac import ChannelConfig
    from repro_torch.fl import FLConfig, train
    torch.backends.cudnn.deterministic = True
    params, loss_fn, sample_round = _small_task(cuda)
    fl = FLConfig(n_clients=4, local_steps=2, batch_size=3, local_lr=0.05,
                  global_lr=0.05, rounds=8, backend=backend,
                  client_chunk=2, compression_ratio=0.2, policy="fairk_auto",
                  channel=ChannelConfig(fading="rayleigh", mean=1.0,
                                        noise_std=0.1))
    before = (aou_merge.LAUNCHES, fairk_update.LAUNCHES)
    runs = {m: train(fl, params, loss_fn, sample_round, device=cuda,
                     kernel_mode=m) for m in (None, "plain")}
    launched = (aou_merge.LAUNCHES - before[0],
                fairk_update.LAUNCHES - before[1])
    assert launched == ((8, 0) if backend == "exact" else (0, 8))
    k, p = runs[None], runs["plain"]
    assert k["km_frac"] == p["km_frac"]
    for name in ("w", "age", "g", "sel_count"):
        _same(getattr(k["state"], name), getattr(p["state"], name))
    for key in k["state"].ctrl:
        _same(k["state"].ctrl[key], p["state"].ctrl[key])


def test_adaptive_server_steps_make_no_host_sync(cuda):
    """The traced split, the index-form merge and the controller step of a
    warm exact round, and the packed round's thresholds, fused pass and
    controller step, with PyTorch's sync debug mode raising on any
    synchronising call."""
    from repro_torch.fl import FLConfig, init_server, make_fl_step
    params, loss_fn, _ = _small_task(cuda)
    for backend in ("exact", "packed"):
        fl = FLConfig(n_clients=4, backend=backend, policy="fairk_auto",
                      compression_ratio=0.2)
        state, unravel = init_server(params, fl, device=cuda)
        d = state.w.shape[0]
        step = make_fl_step(fl, unravel, loss_fn, d, device=cuda)
        k = fl.budgets(d)[0]
        n_agg = k if backend == "exact" else d
        agg = torch.randn(n_agg, device=cuda)
        draws = {"z": torch.randn(n_agg, device=cuda)}
        args = (state.w, agg, None, state.g, state.age, state.sel_count,
                state.residual, state.theta, draws)
        out = step.server_phase(*args, cstate=state.ctrl)     # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                out = step.server_phase(*args, cstate=out[7])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        assert torch.isfinite(out[0]).all()


def test_sweep_kernel_and_plain_grids_are_identical(cuda):
    from repro_torch.fl import sweep
    cfg = sweep.SweepConfig(d=2048, n_clients=16, rho=0.2, rounds=12)
    before = aou_merge.LAUNCHES
    grids = {m: sweep.run_sweep(cfg, ("fairk", "topk", "randk",
                                      "fairk_auto"), (0.25, 0.75), 3,
                                device=cuda, kernel_mode=m)
             for m in (None, "plain")}
    assert aou_merge.LAUNCHES - before == cfg.rounds
    for key in ("loss", "mean_age", "max_age", "frac_fresh", "km_frac",
                "res_norm"):
        np.testing.assert_array_equal(grids[None][key], grids["plain"][key])
    np.testing.assert_array_equal(grids[None]["frac_fresh"],
                                  cfg.k / cfg.d)


@pytest.mark.parametrize("d", [255, 109_210, 1_000_003])
def test_no_residual_fairk_update_matches_plain(cuda, d):
    """``ops.fairk_update`` (no residual, no ``fresh``): the same kernel
    launch as ``fairk_ef_update``, equal to its plain version and to
    ``ref.fairk_update_ref``."""
    x = _inputs(d, seed=d + 1, dev=cuda)
    for tm, ta in ((0.0, 0.0), (x["tm"], x["ta"]), (float("inf"), x["ta"])):
        before = fairk_update.LAUNCHES
        k = ops.fairk_update(x["g"], x["g_prev"], x["age"], tm, ta,
                             mode="kernel")
        assert fairk_update.LAUNCHES == before + 1
        p = ops.fairk_update(x["g"], x["g_prev"], x["age"], tm, ta,
                             mode="plain")
        r = ref.fairk_update_ref(x["g"], x["g_prev"], x["age"],
                                 torch.tensor(tm, device=cuda),
                                 torch.tensor(ta, device=cuda))
        assert len(k) == 2
        for a, b, c in zip(k, p, r):
            _same(a, b)
            _same(a, c)


@pytest.mark.parametrize("route", ["stats", "ef", "plain"])
def test_fairk_kernel_on_the_padded_tree_buffer(cuda, route):
    """The fast transformer tree's packed buffer (99 leaves, 8,460,544
    coordinates, pads after every leaf): pads are never selected, their
    age, ``g_prev`` and residual pass through, they weigh nothing in the
    histograms — kernel equal to plain, counts and histograms included."""
    from benchmarks import torch_packed_bench as bench
    from repro_torch.core import packing
    tree = bench.make_transformer_tree(*bench.FAST_TREE, device=cuda)
    g_prev, age = bench.server_state(tree)
    lay = packing.PackedLayout.from_tree(tree)
    assert (lay.n_leaves, lay.d_packed) == (99, 8_460_544)
    g = lay.pack(tree)
    gp = lay.pack(g_prev)
    ag = lay.pack_age(age)
    res = torch.randn(lay.d_packed, device=cuda) * 0.05
    res = res * lay.valid_mask(cuda)
    pads = ~lay.valid_mask(cuda)
    for tm, ta in ((0.0, 0.0), (1.6, 30.5)):
        if route == "stats":
            k = ops.fairk_stats_update(g, gp, ag, tm, ta, residual=res,
                                       mode="kernel")
            p = ops.fairk_stats_update(g, gp, ag, tm, ta, residual=res,
                                       mode="plain")
            for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
                _same(k[3][key], p[3][key])
            assert float(k[3]["n_sel"]) <= lay.d_valid
        elif route == "ef":
            k = ops.fairk_ef_update(g, gp, ag, tm, ta, residual=res,
                                    mode="kernel")
            p = ops.fairk_ef_update(g, gp, ag, tm, ta, residual=res,
                                    mode="plain")
        else:
            k = ops.fairk_update(g, gp, ag, tm, ta, mode="kernel")
            p = ops.fairk_update(g, gp, ag, tm, ta, mode="plain")
        for a, b in zip(k[:3], p[:3]):
            if a is not None:
                _same(a, b)
        assert torch.equal(k[1][pads], ag[pads])              # age -1 kept
        assert torch.equal(k[0][pads], gp[pads])              # g_prev kept
        assert not bool((k[1][pads] == 0.0).any())            # never chosen
        if route != "plain":
            assert torch.equal(k[2][pads], res[pads])


# --- the scenario layers -----------------------------------------------------

def _rows(c, dev, seed):
    """A (c,) vote-weight row with 0.0, −0.0, negative and NaN weights."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    row = torch.rand(c, generator=gen, device=dev) * 2.0 - 0.5
    special = torch.tensor([0.0, -0.0, -0.7, float("nan")], device=dev)
    row[:min(c, 4)] = special[:min(c, 4)]
    return row


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("c", [1, 10, 50])
@pytest.mark.parametrize("d", [7, 109_210])
def test_weighted_vote_fold_matches_plain(cuda, d, c, gathered):
    """The wireless fold: each row's votes weighted before the re-sign,
    kernel against ``vote_fold_ref`` bit for bit, and equal to the
    reference trainer's ``sign_mv(one_bit(x) · row)`` on the card."""
    from repro_torch.core import quantize
    x = _chunk(c, d, cuda, seed=d + c)
    row = _rows(c, cuda, seed=c)
    idx = (torch.randperm(d, generator=torch.Generator(
        device=cuda).manual_seed(d), device=cuda)[:max(1, d // 5)]
        if gathered else None)
    acc = _acc(d if idx is None else idx.shape[0], cuda, seed=c)
    k_acc, p_acc = acc.clone(), acc.clone()
    assert ops.vote_fold(k_acc, x, idx, mode="kernel", row=row) is k_acc
    ops.vote_fold(p_acc, x, idx, mode="plain", row=row)
    _same(k_acc, p_acc)
    sent = x if idx is None else x[:, idx]
    want = acc + ops.sign_mv((quantize.one_bit(sent) * row[:, None])
                             .contiguous(), mode="plain")[1]
    _same(k_acc, want)


def test_weighted_vote_fold_is_one_device_operation(cuda):
    x = _chunk(10, 109_210, cuda, seed=5)
    row = _rows(10, cuda, seed=5)
    acc = _acc(109_210, cuda, seed=5)
    before = sign_mv.SIGN_MV_LAUNCHES
    ops.vote_fold(acc, x, row=row)
    assert sign_mv.SIGN_MV_LAUNCHES - before == 1
    on_card = _device_ops(lambda: ops.vote_fold(acc, x, row=row))
    assert not on_card or (sum(on_card.values()) == 1
                           and "sign_mv_kernel" in next(iter(on_card)))
    with pytest.raises(ValueError):
        sign_mv.vote_fold_cuda(acc, x, row=row[:9])


def test_sanitized_chaos_round_matches_its_plain_rerun(cuda):
    """A chaos server phase at d = 109,210 (corrupted aggregate, fade
    erasures, the SANITIZE fused pass with statistics and warm start) on
    the kernels and on the plain versions: the same outputs."""
    from repro_torch.core import faults, packing
    d = 109_210
    fc = faults.FaultConfig(fade=0.05, nan_rate=1e-3)
    gen = torch.Generator(device=cuda).manual_seed(9)
    g = torch.randn(d, generator=gen, device=cuda)
    g = faults.corrupt(g, torch.rand(d, generator=gen, device=cuda), fc)
    erase = faults.fade_mask(torch.rand(-(-d // 128), generator=gen,
                                        device=cuda), d, fc)
    g_prev = torch.randn(d, generator=gen, device=cuda)
    age = torch.randint(0, 40, (d,), generator=gen, device=cuda).float()
    lay = packing.PackedLayout.from_tree(torch.empty(d, device="meta"),
                                         lane=1)
    outs = {}
    for mode in (None, "plain"):
        eng = engine.make_engine("fairk", "packed", layout=lay,
                                 fused_stats=True, warm_start=True,
                                 kernel_mode=mode)
        ts = packing.init_threshold_state(cuda)
        for _ in range(3):
            g_t, age_next, stats = eng.select_and_merge(
                g, g_prev, age, tstate=ts, erase=erase, sanitize=True)
            ts = stats["tstate"]
        outs[mode] = (g_t, age_next, ts)
    k, p = outs[None], outs["plain"]
    _same(k[0], p[0])
    _same(k[1], p[1])
    for key in k[2]:
        _same(k[2][key], p[2][key])
    assert torch.isfinite(k[0]).all()
    assert not ((k[1] == 0.0) & ((erase > 0) | ~torch.isfinite(g))).any()


def test_population_step_at_a_million_matches_the_cpu(cuda):
    """10^6 virtual clients, the same uniforms and cohort on the card and
    on the CPU: grids, counters and every statistic equal, in the
    Gilbert–Elliott and the diurnal modes."""
    from repro_torch.core import population
    for mode in ("ge", "diurnal"):
        cfg = population.PopulationConfig(n_clients=1_000_000,
                                          participants=50, mode=mode)
        gen = torch.Generator().manual_seed(2)
        u0 = torch.rand(cfg.n_clients, generator=gen)
        st = {"cpu": population.init_population_state(u0, cfg),
              "cuda": population.init_population_state(u0.to(cuda), cfg)}
        for _ in range(4):
            u, ids = population.draw_round(gen, cfg, "cpu")
            st["cpu"], ps_c = population.population_round(st["cpu"], u, ids,
                                                          cfg)
            st["cuda"], ps_g = population.population_round(
                st["cuda"], u.to(cuda), ids.to(cuda), cfg)
            assert torch.equal(st["cpu"]["avail"], st["cuda"]["avail"].cpu())
            assert int(st["cpu"]["t"]) == int(st["cuda"]["t"])
            for key in ps_c:
                _same(ps_g[key].cpu(), ps_c[key])


# --- the launch path: 32-bit offsets and the train step -------------------

BIG_D = (1 << 29) + 4099          # past 2^29 coordinates; 4·d > 2^31 bytes


def test_fairk_update_past_2_pow_29_matches_plain(cuda):
    """``fairk_update`` [stats+res] on more than 2^29 coordinates (byte
    offsets past 2^31): the tail, the pads and the statistics equal the
    plain version."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    d = BIG_D
    g = torch.randn(d, generator=gen, device=cuda) * 0.1
    g_prev = torch.randn(d, generator=gen, device=cuda)
    age = torch.randint(0, 60, (d,), generator=gen, device=cuda).float()
    age[-300:] = -1.0
    age[(1 << 29) - 7:(1 << 29) + 9] = -1.0
    res = torch.randn(d, generator=gen, device=cuda) * 0.01
    tm, ta = (torch.tensor(v, device=cuda) for v in (0.16, 40.5))
    k = ops.fairk_stats_update(g, g_prev, age, tm, ta, residual=res,
                               mode="kernel")
    p = ops.fairk_stats_update(g, g_prev, age, tm, ta, residual=res,
                               mode="plain")
    for a, b in zip(k[:3], p[:3]):
        _same(a, b)
    for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
        _same(k[3][key], p[3][key])
    assert bool((k[1][-300:] == -1.0).all())
    assert float(k[3]["n_sel"]) > 0.1 * d


def test_sign_mv_one_row_past_2_pow_29_matches_plain(cuda):
    """``sign_mv`` on the launch path's (1, d) vote row with noise, d past
    2^29."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    votes = torch.randn(1, BIG_D, generator=gen, device=cuda)
    votes[0, -5:] = -0.0
    noise = torch.randn(BIG_D, generator=gen, device=cuda) * 0.5
    for nz in (None, noise):
        ks, ke = ops.sign_mv(votes, nz, mode="kernel")
        ps, pe = ops.sign_mv(votes, nz, mode="plain")
        _same(ks, ps)
        _same(ke, pe)


@pytest.mark.parametrize("oac_kw", [{}, dict(one_bit=True,
                                             error_feedback=True,
                                             noise_std=0.5),
                                    dict(adaptive_km=True, async_agg=True,
                                         sanitize=True, fade=0.05)])
def test_launch_step_kernel_and_plain_are_identical(cuda, oac_kw):
    """The reduced ``internvl2-1b`` train step on the card: the update
    phase through the kernels and through the plain versions, from one
    state and one recorded gradient tree, gives identical parameters,
    optimizer state and server buffers; one ``fairk_update`` launch (and
    one ``sign_mv`` with ``one_bit``) per step."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps, train
    from repro_torch.optim import make_optimizer
    cfg = get_config("internvl2-1b", reduced_variant=True)
    shape = InputShape("custom", 48, 4, "train")
    oac = steps.OacServerConfig(**oac_kw)
    kern = steps.make_train_step(cfg, shape, n_micro=2, oac=oac, device=cuda)
    plain = steps.make_train_step(cfg, shape, n_micro=2, oac=oac,
                                  kernel_mode="plain", device=cuda)
    params = steps.tr.init_lm_seeded(cfg, 0, cuda)
    opt = make_optimizer("adamw", 1e-3)
    st = opt.init(params)
    srv = steps.init_server_state(params, oac=oac)
    for t in range(3):
        batch = train.make_batch(cfg, 0, t, 4, 32, 2, cuda)
        _, grads = kern.grads_fn(params, batch)
        copy = tree_util.tree_map(lambda x: x.clone(), (params, st, srv))
        f0, s0 = fairk_update.LAUNCHES, sign_mv.SIGN_MV_LAUNCHES
        kern.update(params, st, srv, grads, t)
        assert fairk_update.LAUNCHES - f0 == 1
        assert sign_mv.SIGN_MV_LAUNCHES - s0 == (1 if oac.one_bit else 0)
        plain.update(*copy, grads, t)
        for (path, a), (_, b) in zip(tree_util.leaves((params, st, srv)),
                                     tree_util.leaves(copy)):
            if a.dtype == torch.bfloat16:
                assert torch.equal(a.view(torch.int16), b.view(torch.int16))
            else:
                _same(a, b)
        lay = kern.layout
        pads = ~lay.valid_mask(cuda)
        assert bool((srv["age"][pads] == -1).all())


def test_launch_entry_points_on_the_card(cuda, tmp_path):
    """The new entry points default to the card: the model, the step, the
    server state, the draws and the checkpoints."""
    from repro_torch import checkpoint
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import steps, train
    from repro_torch.models import transformer
    cfg = get_config("qwen2.5-32b", reduced_variant=True)
    params = transformer.init_lm_seeded(cfg, 0)
    assert params["embed"].is_cuda
    bundle = steps.make_train_step(cfg, InputShape("custom", 16, 2, "train"),
                                   n_micro=1)
    batch = train.make_batch(cfg, 0, 0, 2, 16, 1, cuda)
    loss, grads = bundle.grads_fn(params, batch)
    assert loss.is_cuda and bool(torch.isfinite(loss))
    srv = steps.init_server_state(params)
    assert srv["g"].is_cuda and srv["g"].dtype == torch.bfloat16
    path = checkpoint.save_server_state(str(tmp_path), srv,
                                        layout=bundle.layout, step=1)
    back, _ = checkpoint.restore_server_state(path, layout=bundle.layout)
    assert back["age"].is_cuda and torch.equal(back["age"], srv["age"])
    out = train.main(["--arch", "qwen2.5-32b", "--steps", "2", "--batch",
                      "2", "--seq", "16"])
    assert out["params"]["embed"].is_cuda and len(out["losses"]) == 2
