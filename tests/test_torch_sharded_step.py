"""The sharded train step (``repro_torch.launch.steps.make_train_step(cfg,
shape, mesh)``) on 8 gloo ranks against the reference's on 8 placeholder
host devices with ``Auto`` axes (``tests/shardstep.py`` runs both,
concurrently, from the port's seeded init as numpy).  Reduced
``qwen2.5-32b`` on a (2, 4) mesh in float32 compute, global batch 8 as 2
microbatches, sequence 64:

* the whole step, 3 steps, with ``sequence_parallel`` on and off, held
  after every step ``t`` to ``tests/test_torch_launch.py``'s float32
  tolerances per rank against the reference's values on the device at
  the rank's mesh coordinate (``addressable_shards``): the loss within
  rtol 1e-5 and equal on every rank; the rank's ages equal on at least
  99.9% of its coordinates; its parameters within 2.2e-3·(t + 1), and
  within 1e-6 on at least 99.9% of them, each leaf on at least 95% of
  its own (``shardstep.check_whole_step``).  Measured on the CPU: the
  loss within 3.6e-7, ages ≥ 99.997%, parameters ≥ 99.945% after the
  third step.  ``wk``'s bias is held to the 2.2e-3 bound only: its
  gradient is zero but for rounding (a shift of every key moves no
  softmax), which AdamW scales up to the learning rate, and 87.5% of it
  agrees after three steps;
* the update phase, given the reference's gradients (the function the
  reference hands ``shard_map``, captured and jitted, on global random
  gradients; each rank takes its block): the default route and one-bit +
  EF with vote noise (the reference's per-shard draws), 2 steps each —
  every rank's parameters, optimizer state and server buffers equal the
  reference's device's bit for bit, the copies of the replicated leaves
  that the per-shard noise drives apart included, but the carried θ
  (``theta[:2]``) within 2 ulps (XLA's float32 ``exp2``), as in
  ``tests/test_torch_launch.py``, and the carried magnitude histogram
  within an L1 distance of 1 (it counts ``floor(8·log2|g|)`` over the
  strided sample, averaged over the 8 shards, and XLA's float32 ``log2``
  is not correctly rounded either: at most 8 sampled coordinates may sit
  one bin apart); the age histogram and the counts exactly;
The other layer families and the noisy whole step:
``tests/test_torch_sharded_step_families.py``; the (1, 1) mesh against
the single-card step: ``tests/test_torch_sharding.py``.
"""

import pytest
import shardstep

pytestmark = pytest.mark.sharded

WK_BIAS = ["blocks/0/mixer/wk/b"]
CASES = {
    "qwen_sp": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=True,
                    noise_leaves=WK_BIAS),
    "qwen_no_sp": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=False,
                       noise_leaves=WK_BIAS),
}
UPDATES = {
    "update_default": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=True),
    "update_one_bit_ef": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=True,
                              oac=dict(one_bit=True, error_feedback=True,
                                       noise_std=0.5)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shardstep.run(str(tmp_path_factory.mktemp("sharded_step")),
                         CASES, UPDATES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_whole_step_matches_the_reference_per_rank(runs, name):
    work, ref_losses = runs
    shardstep.check_whole_step(work, ref_losses, name, CASES[name])


@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_phase_equals_the_reference_bit_for_bit(runs, name):
    shardstep.check_update(runs[0], name, UPDATES[name])
