#!/usr/bin/env python3
"""Time the port's kernels and the one-bit and exact call sites of one tree
on one NVIDIA GPU, so that two trees (a parent commit and its change) can
be compared on one card in one run.

    python3 tools/torch_kernel_ab.py --root DIR --label NAME

``DIR`` is the root of a checkout whose ``src/repro_torch`` is measured
(its kernels build into ``DIR/build``); the timing helpers come from this
checkout's ``chip_smoke.py``.  Every measured call is first held against
its plain version (bit for bit).  Measures, with CUDA-graph replay (device
time) and eager calls (host time):

- the launch floor: one graph-replayed ``t.add_(0)`` on a one-element
  tensor;
- ``ops.fairk_stats_update`` [stats] and [stats+res] at d = 109,210 and
  2^24, and the device operations one warm call makes (``torch.profiler``);
- ``ops.block_topk`` at 2^24 for every ``chip_smoke.TOPK_CASES`` shape,
  beside ``torch.topk`` on the same rows;
- ``ops.two_stage_topk(x, d/100)`` at 2^24 beside ``torch.topk(x.abs(),
  k)``;
- the one-bit uplink's call sites at the paths' shapes, each as one call
  where the tree has ``ops.vote_fold`` and the fused detection, and as the
  composition of operations the trainer ran before where it has not: the
  chunk fold of (10, 109,210) dense and gathered at 21,842 unsorted
  coordinates, the packed detection with its score (109,210, noise 2.0
  times a draw ``z``), the exact detection (21,842); and ``ops.sign_mv``
  at (10, 21,842), (10, 109,210) and (50, 109,210).  Each result is held
  against plain PyTorch arithmetic that does not depend on the tree.
- ``ops.aou_merge`` (the mask form) at d = 109,210 and 2^24;
- the exact path's state updates at d = 109,210, each as one call where
  the tree has the index form (``ops.aou_merge_by_indices``,
  ``ops.masked_merge_by_indices``) and as the composition of operations
  the call sites ran before where it has not: the trainer's coherent
  update at k = 10,921 with and without error feedback and its one-bit
  update with it at k = 21,842, and the engine's update with noise and
  residual at k = 10,921 (the tree's ``ops.aou_merge`` in the middle).
  Device operations are also counted as the nodes of a captured CUDA
  graph (``chip_smoke._graph_ops``).

Prints one line per measurement and writes them all to
``chiprun_out/kernel_ab_<NAME>.json``.  Run alternately on two roots
(parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _short(on_card):
    """Device operations by the first 60 characters of their names."""
    out = {}
    for key, cnt in on_card.items():
        out[key[:60]] = out.get(key[:60], 0) + cnt
    return out


def one_bit_sites(cs, ops, dev, rng, put) -> None:
    """The one-bit uplink's call sites (module docstring), timed and
    checked; ``composed`` in a row says which form the tree ran."""
    import numpy as np
    import torch
    from repro_torch.core import quantize
    from repro_torch.core.engine import index_jitter

    fused = hasattr(ops, "vote_fold")
    d, k, c = cs.D, cs.K_ONE_BIT, cs.CHUNK
    x = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                        device=dev)
    x[0, :5] = torch.tensor([0.0, -0.0, float("nan"), float("inf"),
                             -float("inf")])
    idx = torch.as_tensor(rng.permutation(d)[:k], device=dev)
    energy = torch.as_tensor(2.0 * rng.integers(-25, 26, size=d),
                             dtype=torch.float32, device=dev)
    z = torch.as_tensor(rng.normal(size=d).astype(np.float32), device=dev)

    def votes(sent):
        return torch.where(sent >= 0, 1.0, -1.0).sum(dim=0)

    def fold(acc, sel):
        if fused:
            return ops.vote_fold(acc, x, sel)
        sent = x if sel is None else x[:, sel]
        return acc + ops.sign_mv(quantize.one_bit(sent).contiguous())[1]

    def detect_packed():
        if fused:
            return ops.sign_from_energy(energy, z=z, noise_std=2.0,
                                        score=True)
        signs, e = ops.sign_from_energy(energy, noise=2.0 * z)
        return signs, e, e.abs() + index_jitter(d, device=dev)

    def detect_exact():
        return quantize.fsk_majority_from_energy(energy[:k], z[:k], 2.0)

    s_ref = energy + 2.0 * z
    sign_ref = torch.where(s_ref >= 0, 1.0, -1.0)
    score_ref = s_ref.abs() + index_jitter(d, device=dev)
    sites = {}
    for name, sel, n_bytes in (
            (f"fold[{c}x{d}]", None, 4 * c * d + 8 * d),
            (f"fold[{c}x{d} at {k}]", idx, 4 * c * k + 16 * k)):
        width = d if sel is None else k
        acc = torch.as_tensor((rng.normal(size=width) * 7.0).astype(
            np.float32), device=dev)
        want = acc + votes(x if sel is None else x[:, sel])
        cs._same(fold(acc.clone(), sel), want, name)
        sites[name] = (lambda acc=acc, sel=sel: fold(acc, sel), n_bytes,
                       2 * c * width)
    for got, want, what in zip(detect_packed(), (sign_ref, s_ref, score_ref),
                               ("signs", "energy", "score")):
        cs._same(got, want, f"packed detection {what}")
    cs._same(detect_exact(), sign_ref[:k], "exact detection")
    sites[f"detect+score[{d}]"] = (detect_packed, 20 * d, 8 * d)
    sites[f"detect[{k}]"] = (detect_exact, 16 * k, 4 * k)
    for n, width in ((c, k), (c, d), (50, d)):
        v = torch.as_tensor(np.sign(rng.normal(size=(n, width))).astype(
            np.float32), device=dev)
        e = votes(v)
        got = ops.sign_mv(v)
        cs._same(got[1], e, "sign_mv energy")
        cs._same(got[0], torch.where(e >= 0, 1.0, -1.0), "sign_mv signs")
        sites[f"sign_mv[{n}x{width}]"] = (lambda v=v: ops.sign_mv(v),
                                          4 * n * width + 8 * width,
                                          2 * n * width)
    for name, (fn, n_bytes, n_ops) in sites.items():
        ms, eager = cs._time_ms(fn)
        on_card = cs._device_ops(fn)
        put(name, composed=not fused and not name.startswith("sign_mv"),
            ms=ms, eager_ms=eager,
            bound_ms=cs._bound_ms(n_bytes, n_ops)[0],
            n_device_ops=sum(on_card.values()), device_ops=_short(on_card))


def merge_sites(cs, ops, dev, rng, put) -> None:
    """``aou_merge``'s mask form and the exact path's state updates
    (module docstring), timed and checked; ``composed`` in a row says
    which form the tree ran."""
    import numpy as np
    import torch
    from repro_torch.core import aou, oac, selection

    fused = hasattr(ops, "aou_merge_by_indices")
    d, n = cs.D, 50
    for size in (d, cs.BIG):
        a = [torch.as_tensor(rng.normal(size=size).astype(np.float32),
                             device=dev) for _ in range(3)]
        a.append(torch.as_tensor((rng.random(size) < 0.1).astype(
            np.float32), device=dev))
        keep = 1.0 - a[3]
        cs._same(ops.aou_merge(*a)[0], a[3] * a[0] + keep * a[1],
                 "aou_merge g")
        ms, eager = cs._time_ms(lambda: ops.aou_merge(*a),
                                blocks=50 if size == d else 10)
        put(f"aou_merge[{size}]", ms=ms, eager_ms=eager,
            bound_ms=cs._bound_ms(24 * size, 7 * size)[0],
            n_device_ops=sum(cs._graph_ops(lambda: ops.aou_merge(*a))
                             .values()))

    def vec(scale=1.0):
        x = (rng.normal(size=d) * scale).astype(np.float32)
        x[rng.choice(d, 20, replace=False)] = -0.0
        return torch.as_tensor(x, device=dev)

    g_prev, ef_sum, sent, score, noise = vec(), vec(3.0), vec(), vec(), vec()
    age = torch.as_tensor(rng.integers(0, 131, size=d).astype(np.float32),
                          device=dev)
    sel_count = torch.as_tensor(rng.integers(0, 9, size=d).astype(
        np.float32), device=dev)
    rows = {}
    for k in (cs.K_EXACT, cs.K_ONE_BIT):
        rows[k] = (torch.as_tensor(rng.permutation(d)[:k], device=dev),
                   torch.as_tensor(rng.normal(size=k).astype(np.float32),
                                   device=dev),
                   torch.as_tensor(rng.normal(size=k).astype(np.float32),
                                   device=dev))

    def trainer(k, superposed, ef):
        idx, row, z = rows[k]
        if fused:
            return lambda: ops.aou_merge_by_indices(
                idx, row, g_prev, age, sel_count, n_clients=n,
                superposed=superposed, z=z, noise_std=0.1,
                ef_sum=ef_sum if ef else None)[:4]

        def composed():
            fresh = row
            if superposed:
                fresh = oac.finish_aggregate(
                    row, z, n, oac.ChannelConfig(fading="none",
                                                 noise_std=0.1))
            g_t = oac.reconstruct(g_prev, idx, fresh)
            mask = selection.mask_from_indices(idx, d)
            if ef:
                composed.residual = (ef_sum / n) * (1.0 - mask)
            return (g_t, aou.update_age_by_indices(age, idx), mask,
                    sel_count + mask)
        return composed

    def engine():
        idx = rows[cs.K_EXACT][0]
        if fused:
            return ops.masked_merge_by_indices(
                idx, sent, g_prev, age, noise=noise, noise_scale=0.1 / n,
                score=score)[:2]
        mask = selection.mask_from_indices(idx, d)
        out = ops.aou_merge(sent + (0.1 / n) * noise, g_prev, age, mask)
        engine.residual = score - mask * sent
        return out

    sites = {
        f"trainer coherent+ef[{d} at {cs.K_EXACT}]": (
            trainer(cs.K_EXACT, True, True), 36 * d + 16 * cs.K_EXACT),
        f"trainer coherent[{d} at {cs.K_EXACT}]": (
            trainer(cs.K_EXACT, True, False), 28 * d + 16 * cs.K_EXACT),
        f"trainer one-bit+ef[{d} at {cs.K_ONE_BIT}]": (
            trainer(cs.K_ONE_BIT, False, True), 36 * d + 12 * cs.K_ONE_BIT),
        f"engine noise+res[{d} at {cs.K_EXACT}]": (
            engine, 32 * d + 8 * cs.K_EXACT)}
    for name, (fn, n_bytes) in sites.items():
        k = cs.K_ONE_BIT if "one-bit" in name else cs.K_EXACT
        idx, row, z = rows[k]
        mask = torch.zeros(d, device=dev)
        mask[idx] = 1.0
        got = fn()
        if name.startswith("engine"):
            want = (mask * (sent + (0.1 / n) * noise) + (1.0 - mask) * g_prev,
                    torch.clamp((age + 1.0) * (1.0 - mask), max=120.0))
        else:
            fresh = (row + 0.1 * z) / n if "coherent" in name else row
            g_t = g_prev.clone()
            g_t[idx] = fresh
            want = (g_t, torch.where(mask > 0, 0.0,
                                     torch.clamp(age + 1.0, max=120.0)),
                    mask, sel_count + mask)
        for a, b in zip(got, want):
            cs._same(a, b, name)
        ms, eager = cs._time_ms(fn)
        put(name, composed=not fused, ms=ms, eager_ms=eager,
            bound_ms=cs._bound_ms(n_bytes, 8 * d)[0],
            n_device_ops=sum(cs._graph_ops(fn).values()),
            profiler_ops=_short(cs._device_ops(fn)))


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(force=True)
    out = {"root": str(root), "card": cs.card_line(),
           "kind": torch.cuda.get_device_name(0), "rows": {}}

    def put(name, **row):
        out["rows"][name] = row
        print(f"{args.label} {name}: " + ", ".join(
            f"{k} {v}" for k, v in row.items()), flush=True)

    one = torch.zeros(1, device=dev)
    put("launch_floor", ms=cs._time_ms(lambda: one.add_(0))[0])

    rng = np.random.default_rng(0)
    for d in (cs.D, cs.BIG):
        blocks = 50 if d == cs.D else 10
        g = torch.as_tensor((rng.standard_t(3, size=d) * 0.1
                             ).astype(np.float32), device=dev)
        g_prev = torch.as_tensor(rng.normal(size=d).astype(np.float32),
                                 device=dev)
        age = torch.as_tensor(rng.integers(0, 131, size=d).astype(
            np.float32), device=dev)
        res = torch.as_tensor((rng.normal(size=d) * 0.05).astype(np.float32),
                              device=dev)
        tm = torch.quantile(g.abs()[:1 << 20], 0.9).reshape(())
        ta = torch.tensor(40.5, device=dev)
        for variant, r in (("stats", None), ("stats+res", res)):
            def call(mode):
                return ops.fairk_stats_update(g, g_prev, age, tm, ta,
                                              residual=r, mode=mode)
            k_out, p_out = call("kernel"), call("plain")
            for i in range(3 if r is not None else 2):
                cs._same(k_out[i], p_out[i], f"fairk {variant} out {i}")
            for key in ("n_sel", "n_sel_m", "mag_hist", "age_hist"):
                cs._same(k_out[3][key], p_out[3][key], f"fairk {key}")
            ms, eager = cs._time_ms(lambda: call("kernel"), blocks=blocks)
            plain = cs._time_ms(lambda: call("plain"), blocks=blocks)[0]
            n_bytes = 4 * d * (5 if r is None else 7) + 4 * 258 + 8
            bound, by = cs._bound_ms(n_bytes, (12 + (3 if r is not None
                                                     else 0)) * d)
            put(f"fairk_update[{variant}][{d}]", ms=ms, eager_ms=eager,
                plain_ms=plain, bound_ms=bound, bound_by=by,
                device_ops=_short(cs._device_ops(lambda: call("kernel"))))

    x = rng.normal(size=cs.BIG).astype(np.float32)
    x[rng.random(cs.BIG) < 0.01] = 1.25
    x[rng.random(cs.BIG) < 0.01] = -1.25
    xt = torch.as_tensor(x, device=dev)
    absx = xt.abs()
    for bs, m in cs.TOPK_CASES:
        kv, ki = ops.block_topk(xt, bs, m, mode="kernel")
        pv, pi = ops.block_topk(xt, bs, m, mode="plain")
        cs._same(kv, pv, "block_topk values")
        cs._same(ki, pi, "block_topk indices")
        ms = cs._time_ms(lambda: ops.block_topk(xt, bs, m, mode="kernel"),
                         blocks=10)[0]
        lib = cs._time_ms(lambda: torch.topk(absx.view(-1, bs), m, dim=1),
                          blocks=10)[0]
        nb = cs.BIG // bs
        put(f"block_topk[{cs.BIG}/{bs}x{m}]", ms=ms, library_ms=lib,
            bound_ms=cs._bound_ms(4 * cs.BIG + 8 * nb * m, 2 * cs.BIG)[0])
    k = cs.BIG // 100
    ms = cs._time_ms(lambda: ops.two_stage_topk(xt, k, mode="kernel"),
                     blocks=10)[0]
    lib = cs._time_ms(lambda: torch.topk(xt.abs(), k), blocks=10)[0]
    put(f"two_stage_topk[{cs.BIG}, k {k}]", ms=ms, library_ms=lib)
    one_bit_sites(cs, ops, dev, rng, put)
    merge_sites(cs, ops, dev, rng, put)

    out_dir = HERE / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"kernel_ab_{args.label}.json").write_text(
        json.dumps(out, indent=1))
    print(out["card"], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
