"""The sharded train step on 8 gloo ranks against the reference's on 8
placeholder host devices with ``Auto`` axes (``tests/shardstep.py``),
for the other layer families and the noisy route: reduced configurations
in float32 compute, global batch 8 as 2 microbatches, sequence 64, 3
steps —

* ``granite-moe-3b-a800m`` on (4, 2): 4 experts on ``model`` = 2, so
  ``_with_expert_axis`` pins them and each rank runs its 2 experts;
* ``mamba2-370m`` on (2, 4) with sequence parallelism;
* ``qwen2.5-32b`` on (2, 4), one-bit + EF with vote noise, fed the
  reference's per-shard draws (``normal(fold_in(PRNGKey(seed), my))``).

Held after every step to ``tests/test_torch_sharded_step.py``'s
tolerances per rank (``shardstep.check_whole_step``: the loss within
rtol 1e-5 and equal on every rank, 99.9% of ages equal, parameters within
2.2e-3·(t + 1), 99.9% of them and 95% of each leaf within 1e-6), with
two exceptions, each measured on the CPU:

* ``granite_pin`` after the third step: 99.5% of parameters within 1e-6.
  Parameter agreement measured ≥ 99.991%, ≥ 99.969% and ≥ 99.690% after
  steps 1, 2 and 3 (the router 96.7%), and the loss gap grows from
  7.0e-7 to 4.2e-6 at step 3 (qwen2.5's stays below 3.6e-7): the
  reference's partitioned ops round otherwise than the port's whole ones,
  and once the routers differ in their last bits a top-2 choice or a
  capacity drop can flip, which AdamW carries into whole rows.
  ``tests/test_torch_launch.py`` holds the single-card MoE step for two
  steps.
* ``one_bit_ef`` from step 1 on: the loss within rtol 1e-3 (measured
  1.3e-5 and 1.1e-4).  Its per-shard draws make every shard's copy of a
  replicated leaf (norms, biases, ``wk`` / ``wv``) drift apart — in both
  packages, and equal per device: the update-phase case of
  ``tests/test_torch_sharded_step.py`` and these parameters (every
  replicated leaf equal to the reference's device bit for bit after three
  steps, ≥ 99.989% of all within 1e-6) show it — and the loss is the mean
  of the ranks' losses, which the reference's partitioned ops mix from
  the devices' copies otherwise than the port's ranks, each running the
  whole op with its own copy.
"""

import pytest
import shardstep

pytestmark = pytest.mark.sharded

CASES = {
    "granite_pin": dict(arch="granite-moe-3b-a800m", mesh=[4, 2], sp=True,
                        pin="model", agree=[0.999, 0.999, 0.995]),
    "mamba2": dict(arch="mamba2-370m", mesh=[2, 4], sp=True),
    "one_bit_ef": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=True,
                       oac=dict(one_bit=True, error_feedback=True,
                                noise_std=0.5),
                       loss_rtol=[1e-5, 1e-3, 1e-3]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shardstep.run(str(tmp_path_factory.mktemp("sharded_families")),
                         CASES, {})


@pytest.mark.parametrize("name", sorted(CASES))
def test_whole_step_matches_the_reference_per_rank(runs, name):
    work, ref_losses = runs
    shardstep.check_whole_step(work, ref_losses, name, CASES[name])
