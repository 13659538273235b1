"""The sharded train step with its parts split over ``model`` (tensor
parallelism, ``models.parallel.tp_split``) on 8 gloo ranks against the
reference's on 8 placeholder host devices with ``Auto`` axes
(``tests/shardstep.py``): reduced configurations in float32 compute,
global batch 8 as 2 microbatches, sequence 64, 3 steps, each on a
(2, 4) mesh —

* ``granite-34b``: heads that split whole over ``model`` (4 heads, one
  kv group read by every rank's head), the GeLU MLP by hidden units
  with its biases, the vocabulary by blocks, sequence parallel;
* ``mamba2-370m`` without sequence parallelism: the SSM heads split,
  the region entered through the column-parallel copy and left through
  the row-parallel sum;
* ``granite-moe-3b-a800m`` with 6 experts, which do not divide the 4
  ranks of ``model``: the reference's fallback spec splits the experts'
  hidden units (``wg`` / ``wu``) and ``wd``'s output columns, sequence
  parallel;
* ``qwen2.5-32b`` with 6 heads over 2 kv heads, which do not split
  evenly over the 4 ranks of ``model`` (384 columns of ``wq`` do):
  uneven runs of 1 / 2 / 1 / 2 whole heads (``parallel.head_range``),
  ``wq`` / ``wo`` gathered over ``model`` in the layer and narrowed to
  them, a kv group of 3 split between ranks, ``wq``'s bias cut to the
  run, sequence parallel; ``wk``'s bias is held to the 2.2e-3 bound only,
  as in ``tests/test_torch_sharded_step.py``'s qwen cases (its gradient
  is zero but for rounding, which AdamW scales up to the learning rate).

Held after every step to ``tests/test_torch_sharded_step.py``'s
tolerances per rank (``shardstep.check_whole_step``: the loss within
rtol 1e-5 and equal on every rank, 99.9% of ages equal, parameters within
2.2e-3·(t + 1), 99.9% of them and 95% of each leaf within 1e-6), and the
step's ``meta`` names the parts that split.  One expert a rank
(``granite-moe-3b-a800m`` as it is on (2, 4), which the reference does not
pin and the port runs split) is held in ``tests/test_torch_tp.py``
against the single process's gradients instead: against the reference
its third loss sat 9.0e-5 off on the CPU, a routing flip of the kind
``tests/test_torch_sharded_step_families.py`` describes for
``granite_pin``.
"""

import pytest
import shardstep

pytestmark = pytest.mark.sharded

CASES = {
    "granite_heads": dict(arch="granite-34b", mesh=[2, 4], sp=True,
                          split=["attn", "ffn", "vocab"]),
    "mamba2_heads_no_sp": dict(arch="mamba2-370m", mesh=[2, 4], sp=False,
                               split=["ssm", "vocab"]),
    "moe_hidden": dict(arch="granite-moe-3b-a800m", mesh=[2, 4], sp=True,
                       overrides={"n_experts": 6},
                       split=["attn", "moe", "vocab"]),
    "qwen_uneven_heads": dict(arch="qwen2.5-32b", mesh=[2, 4], sp=True,
                              overrides={"n_heads": 6, "n_kv_heads": 2},
                              noise_leaves=["blocks/0/mixer/wk/b"],
                              split=["attn", "ffn", "vocab"]),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shardstep.run(str(tmp_path_factory.mktemp("sharded_tp")),
                         CASES, {})


@pytest.mark.parametrize("name", sorted(CASES))
def test_whole_step_matches_the_reference_per_rank(runs, name):
    work, ref_losses = runs
    shardstep.check_whole_step(work, ref_losses, name, CASES[name])
