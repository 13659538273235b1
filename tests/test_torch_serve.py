"""The serving path (``repro_torch.models`` caches, ``prefill``,
``decode_step`` and ``launch.steps.make_prefill_step`` /
``make_serve_step``) against the JAX package's, on carried weights of the
reduced configurations of every layer family: attention with the VLM
prefix, dense attention, MoE, Mamba-2, the attention / Mamba / MoE
hybrid, MoE beside a dense branch, and the encoder-decoder.

* The caches: ``init_caches`` against the reference's (paths, shapes,
  dtypes and values) and against ``cache_specs`` (``meta`` tensors);
  ``cache_fill`` / ``cache_write`` with a ring smaller than the sequence
  and a full non-ring cache, bit for bit (float32 data).
* ``prefill`` of a 20-token prompt (Mamba chunk 8: the padded SSD path)
  then 4 ``decode_step`` calls, against the reference's jitted
  functions: the integer cache fields (``pos``, ``idx``, ``ring``)
  exactly; logits and the float cache fields in float32 compute within
  rtol 1e-4 / atol 2e-5 (the products accumulate in another order: the
  attention's, the SSD's cumsums and exps, XLA's ``exp`` / ``rsqrt`` one
  ulp off), in bf16 compute within 0.05 / 0.05 (a bf16 value off by one
  or two ulps) — for the two configurations with bf16 parameters (jamba,
  arctic) widened by twice the reference's own distance between its bf16
  and float32 runs: bf16 weights, jamba's 16 layers and the routing put
  the reference's bf16 logits up to 0.35 from its float32 ones (the
  port's: jamba 0.045, arctic 0.17).
* Each decoded token's logits against a teacher-forced ``forward_train``
  over prompt + decoded tokens, in the port itself: float32 within
  2e-4 / 2e-5, bf16 within 0.1 / 0.1 (decoding rounds the same sums in
  another grouping: cache-wise attention, the recurrent SSD step against
  the chunked scan, the SSM carry rounded to bf16 after each token), and
  each position's relative L2 error within 1e-5 / 0.02 (bf16 measured
  0.011 at most; ``chip_smoke.py`` holds the full-width models to 1e-4 /
  0.1).  The MoE families are exempt: ``decode_mode``'s merged routing
  group with a capacity floor of 2 drops other choices than the prompt's
  per-row capacity does, by the reference's design.
* The serving bundles' ``meta`` against the reference's on a 1×1 mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torchutil import to_np

from repro.configs import get_config as jax_get_config
from repro.configs.base import InputShape as JaxShape
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro_torch import tree as tree_util
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import steps
from repro_torch.models import attention, transformer

ARCHS = ("internvl2-1b", "qwen2.5-32b", "granite-moe-3b-a800m",
         "mamba2-370m", "jamba-1.5-large-398b", "arctic-480b",
         "whisper-base")
MOE = ("granite-moe-3b-a800m", "jamba-1.5-large-398b", "arctic-480b")
BF16_PARAMS = ("jamba-1.5-large-398b", "arctic-480b")
BATCH, PROMPT, N_DECODE = 2, 20, 4
MESH = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                         ("data", "model"))
INT_FIELDS = ("pos", "idx", "ring")


def _cfgs(arch, compute):
    kw = dict(compute_dtype=compute)
    if jax_get_config(arch).ssm_state:
        kw["ssm_chunk"] = 8                 # 20 tokens: a padded chunk
    return (dataclasses.replace(jax_get_config(arch, reduced_variant=True),
                                **kw),
            dataclasses.replace(get_config(arch, reduced_variant=True),
                                **kw))


def _np32(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return to_np(x.float() if x.is_floating_point() else x)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _prompt(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = (rng.normal(size=(BATCH, cfg.n_patches, cfg.d_model))
                         * 0.1).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = (rng.normal(size=(BATCH, cfg.encoder_seq,
                                          cfg.d_model)) * 0.1
                         ).astype(np.float32)
    decoded = rng.integers(0, cfg.vocab, (N_DECODE, BATCH, 1),
                           dtype=np.int32)
    return out, decoded


def _port_batch(nb, compute):
    out = {}
    for k, v in nb.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(getattr(torch, compute)) if k != "tokens" else t
    return out


def _close(t, j, tol, what, j32=None):
    """``t`` within ``tol`` of the reference's ``j``; with ``j32`` (the
    reference's float32 run) the atol widens by twice |j - j32|'s max."""
    tol = dict(tol)
    if j32 is not None:
        tol["atol"] += 2.0 * float(np.abs(_np32(j) - _np32(j32)).max())
    np.testing.assert_allclose(_np32(t), _np32(j), **tol, err_msg=what)


def _caches_close(t_caches, j_caches, tol, what, j32_caches=None):
    tl = tree_util.leaves(t_caches)
    jl = jax.tree_util.tree_leaves_with_path(j_caches)
    j32 = (jax.tree_util.tree_leaves(j32_caches) if j32_caches is not None
           else [None] * len(jl))
    assert len(tl) == len(jl), what
    for (path, t), (jpath, j), j3 in zip(tl, jl, j32):
        assert path == tuple(getattr(k, "key", getattr(k, "idx", None))
                             for k in jpath), what
        assert tuple(t.shape) == j.shape, (what, path)
        assert str(t.dtype) == "torch." + str(j.dtype), (what, path)
        if path[-1] in INT_FIELDS:
            np.testing.assert_array_equal(_np32(t), _np32(j),
                                          err_msg=f"{what} {path}")
        else:
            _close(t, j, tol, f"{what} {path}", j3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_match_the_reference_and_cache_specs(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    j_caches = jtr.init_caches(jcfg, BATCH, 24)
    t_caches = transformer.init_caches(tcfg, BATCH, 24, device="cpu")
    specs = transformer.cache_specs(tcfg, BATCH, 24)
    _caches_close(t_caches, j_caches, dict(rtol=0, atol=0), arch)
    for (pa, t), (pb, m) in zip(tree_util.leaves(t_caches),
                                tree_util.leaves(specs)):
        assert pa == pb and m.is_meta
        assert t.shape == m.shape and t.dtype == m.dtype
    assert isinstance(t_caches, list) and len(t_caches) == tcfg.scan_block
    ring = transformer.init_caches(tcfg, 1, 8, ring=True, device="cpu")
    j_ring = jtr.init_caches(jcfg, 1, 8, ring=True)
    _caches_close(ring, j_ring, dict(rtol=0, atol=0), f"{arch} ring")


@pytest.mark.parametrize("ring", [True, False])
def test_cache_fill_and_write_match_the_reference(ring):
    """A capacity-4 cache filled with 6 positions (the trailing window
    kept), then 5 single-token writes (the ring wraps; a full non-ring
    cache overwrites its last slot), and decode attention over it (a
    window of 3), bit for bit."""
    rng = np.random.default_rng(4)
    cap, b, kv, hd = 4, 2, 2, 8
    j_cache = jattn.init_cache(b, cap, kv, hd, jnp.float32, ring)
    t_cache = attention.init_cache(b, cap, kv, hd, torch.float32, ring)
    k_all, v_all = (rng.normal(size=(b, 6, kv, hd)).astype(np.float32)
                    for _ in range(2))
    j_cache = jax.jit(jattn.cache_fill)(j_cache, k_all, v_all,
                                        jnp.arange(6))
    out = attention.cache_fill(t_cache, torch.from_numpy(k_all),
                               torch.from_numpy(v_all), torch.arange(6))
    assert out is t_cache

    def same(what):
        for key in ("k", "v", "pos", "idx", "ring"):
            np.testing.assert_array_equal(_np32(t_cache[key]),
                                          _np32(j_cache[key]),
                                          err_msg=f"{what} {key}")
    same("fill")
    for step in range(5):
        k1, v1, q = (rng.normal(size=(b, 1, n, hd)).astype(np.float32)
                     for n in (kv, kv, 2 * kv))
        p = 6 + step
        j_cache = jax.jit(jattn.cache_write)(j_cache, k1, v1, jnp.int32(p))
        attention.cache_write(t_cache, torch.from_numpy(k1),
                              torch.from_numpy(v1),
                              torch.tensor(p, dtype=torch.int32))
        same(f"write {step}")
        want = jax.jit(lambda q_, c: jattn.decode_attend(
            q_, c, jnp.int32(p), window=3))(q, j_cache)
        got = attention.decode_attend(torch.from_numpy(q), t_cache,
                                      torch.tensor(p, dtype=torch.int32),
                                      window=3)
        np.testing.assert_allclose(_np32(got), _np32(want), rtol=1e-6,
                                   atol=1e-7)
    assert int(t_cache["idx"]) == 11


def _reference_serve(jcfg, params, nb, decoded, capacity):
    prefill = jax.jit(lambda p, c, b: jtr.prefill(
        p, jcfg, b["tokens"], c, embeds=b.get("embeds"),
        frames=b.get("frames")))
    decode = jax.jit(lambda p, c, t, pos: jtr.decode_step(p, jcfg, t, pos,
                                                          c))
    jb = {k: (jnp.asarray(v).astype(jnp.dtype(jcfg.compute_dtype))
              if k != "tokens" else jnp.asarray(v)) for k, v in nb.items()}
    caches = jtr.init_caches(jcfg, BATCH, capacity)
    logits, caches = prefill(params, caches, jb)
    out = [(logits, caches)]
    start = PROMPT + (jcfg.n_patches if jcfg.family == "vlm" else 0)
    for i, tok in enumerate(decoded):
        logits, caches = decode(params, caches, jnp.asarray(tok),
                                jnp.int32(start + i))
        out.append((logits, caches))
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(arch, compute):
    jcfg, tcfg = _cfgs(arch, compute)
    params = jtr.init_lm(jax.random.PRNGKey(5), jcfg)
    nb, decoded = _prompt(jcfg)
    start = PROMPT + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    capacity = start + N_DECODE
    want = _reference_serve(jcfg, params, nb, decoded, capacity)
    want32 = [(None, None)] * len(want)
    if compute == "bfloat16" and arch in BF16_PARAMS:
        jcfg32 = dataclasses.replace(jcfg, compute_dtype="float32")
        want32 = _reference_serve(jcfg32, params, nb, decoded, capacity)
    tol = (dict(rtol=1e-4, atol=2e-5) if compute == "float32"
           else dict(rtol=0.05, atol=0.05))

    tp = steps.state_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    pre = steps.make_prefill_step(tcfg, InputShape("custom", capacity,
                                                   BATCH, "prefill"))
    serve = steps.make_serve_step(tcfg, InputShape("custom", capacity,
                                                   BATCH, "decode"))
    assert (serve.meta["capacity"], serve.meta["ring"]) == (capacity, False)
    caches = transformer.init_caches(tcfg, BATCH, capacity, device="cpu")
    logits, out = pre.fn(tp, caches, _port_batch(nb, compute))
    assert out is caches and logits.shape == (BATCH, 1, tcfg.vocab)
    got = [(logits, caches)]
    for i, tok in enumerate(decoded):
        logits, _ = serve.fn(tp, caches, torch.from_numpy(tok),
                             torch.tensor(start + i, dtype=torch.int32))
        got.append((logits, caches))
        # the caches are updated in place: compare before the next step
        j_logits, j_caches = want[i + 1]
        _close(logits, j_logits, tol, f"{arch} decode {i}",
               want32[i + 1][0])
        _caches_close(caches, j_caches, tol, f"{arch} decode {i}",
                      want32[i + 1][1])
        if i == 0:
            idx = [x for p, x in tree_util.leaves(caches) if p[-1] == "idx"]
            assert all(bool((x == start + 1).all()) for x in idx)
    _close(got[0][0], want[0][0], tol, f"{arch} prefill", want32[0][0])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in MOE])
def test_decode_matches_teacher_forcing(arch, compute):
    """Greedy decoding in the port: each decoded token's logits equal the
    teacher-forced forward over prompt + decoded tokens at that
    position."""
    _, tcfg = _cfgs(arch, compute)
    params = transformer.init_lm_seeded(tcfg, 3, "cpu")
    nb, _ = _prompt(tcfg, seed=1)
    tb = _port_batch(nb, compute)
    start = PROMPT + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    caches = transformer.init_caches(tcfg, BATCH, start + N_DECODE,
                                     device="cpu")
    logits, _ = transformer.prefill(params, tcfg, tb["tokens"], caches,
                                    embeds=tb.get("embeds"),
                                    frames=tb.get("frames"))
    toks, steps_logits = [], []
    for i in range(N_DECODE):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
        logits, _ = transformer.decode_step(params, tcfg, tok, start + i,
                                            caches)
        steps_logits.append(logits)
    full = torch.cat([tb["tokens"]] + toks, dim=1)
    with torch.no_grad():
        forced, _ = transformer.forward_train(params, tcfg, full,
                                              embeds=tb.get("embeds"),
                                              frames=tb.get("frames"))
    tol = (dict(rtol=2e-4, atol=2e-5) if compute == "float32"
           else dict(rtol=0.1, atol=0.1))
    rel_bound = 1e-5 if compute == "float32" else 0.02
    for i, lg in enumerate(steps_logits):
        got, want = _np32(lg[:, 0]), _np32(forced[:, PROMPT + i])
        np.testing.assert_allclose(got, want, **tol,
                                   err_msg=f"{arch} token {i}")
        rel = (np.linalg.norm(got - want, axis=-1)
               / np.linalg.norm(want, axis=-1)).max()
        assert rel <= rel_bound, (arch, i, rel)


def test_serving_meta_matches_the_reference():
    for arch in ("qwen2.5-32b", "mamba2-370m", "whisper-base"):
        jcfg, tcfg = _cfgs(arch, "bfloat16")
        for seq in (64, 65_536):
            jp = jsteps.make_prefill_step(jcfg, JaxShape("p", seq, 2,
                                                         "prefill"), MESH)
            js = jsteps.make_serve_step(jcfg, JaxShape("d", seq, 2,
                                                       "decode"), MESH)
            tp = steps.make_prefill_step(tcfg, InputShape("p", seq, 2,
                                                          "prefill"))
            ts = steps.make_serve_step(tcfg, InputShape("d", seq, 2,
                                                        "decode"))
            assert tp.meta == jp.meta and ts.meta == js.meta, (arch, seq)
            assert ts.meta["ring"] == (seq > 32768
                                       and arch != "mamba2-370m")
