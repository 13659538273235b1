"""The port's launcher across ranks (``repro_torch.launch.train`` with
``WORLD_SIZE`` > 1, as ``torchrun`` starts it): 2 gloo ranks on the CPU,
the reference's ``(1, 2)`` ``("data", "model")`` mesh, reduced
``internvl2-1b`` and ``granite-moe-3b-a800m``.

* 4 steps straight, then 2 steps with ``--ckpt-every 2`` and 2 more with
  ``--resume``: the resumed run continues at step 2 and ends on the same
  parameters, optimizer state, server state and losses, bit for bit, on
  each rank.
* The checkpoint holds the reference's global layout: the server
  buffers are ``n_ranks × d_packed`` long (the per-shard layout recorded
  beside them), the parameters and optimizer moments have the global
  shapes, and they are the ranks' blocks put together.
"""

import json

import pytest
from rankutil import run_ranks

pytestmark = pytest.mark.sharded

RANK_CODE = r"""
import json, sys
import numpy as np
from repro_torch import tree as tu
from repro_torch.core import collectives
from repro_torch.launch import sharding, steps, train
from repro_torch.launch import mesh as mesh_lib

arch, work = sys.argv[1], sys.argv[2]
common = ["--arch", arch, "--batch", "2", "--seq", "32", "--device", "cpu",
          "--ef"]
straight = train.main(common + ["--steps", "4"])
ck = f"{work}/ck_{arch}"
first = train.main(common + ["--steps", "2", "--ckpt-every", "2",
                             "--ckpt-dir", ck])
resumed = train.main(common + ["--steps", "2", "--resume", "--ckpt-dir", ck])
out = {"start": resumed["start"],
       "losses": [straight["losses"], first["losses"] + resumed["losses"]]}
same = True
for key in ("params", "opt", "server"):
    for (p, a), (_, b) in zip(tu.leaves(straight[key]),
                              tu.leaves(resumed[key])):
        same = same and bool(torch.equal(a, b))
out["same"] = same
# the checkpoint: the global layout, made of the ranks' blocks
mesh = mesh_lib.make_mesh((1, WORLD), ("data", "model"), "cpu")
srv = np.load(f"{ck}/server_00000002.npz")
meta = json.loads(str(srv["__server_meta__"][()]))
out["g_len"] = int(srv["g"].shape[0])
out["d_packed"] = meta["layout"]["d_packed"]
step = np.load(f"{ck}/step_00000002.npz")
shapes = {k: list(step[k].shape) for k in step.files}
out["shapes"] = shapes
from repro_torch import checkpoint
from repro_torch.configs import get_config
cfg = get_config(arch, reduced_variant=True)
p_specs = sharding.param_pspecs(steps.abstract_params(cfg), cfg, mesh)
saved = checkpoint.restore(f"{ck}/step_00000002.npz", device="cpu")
mine = sharding.local_tree(saved["params"], p_specs, mesh)
out["blocks"] = all(bool(torch.equal(a, b)) for (_, a), (_, b) in zip(
    tu.leaves(mine), tu.leaves(first["params"])))
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch", ["internvl2-1b", "granite-moe-3b-a800m"])
def test_resume_across_two_ranks_continues_bit_for_bit(tmp_path, arch):
    outs = run_ranks(RANK_CODE, 2, str(tmp_path), args=[arch, str(tmp_path)],
                     timeout=300)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding, steps
    from repro_torch import tree as tree_util
    cfg = get_config(arch, reduced_variant=True)
    pa = steps.abstract_params(cfg)
    mesh = mesh_lib.AbstractMesh((1, 2), ("data", "model"))
    lay = steps.server_layout(pa, sharding.param_pspecs(pa, cfg, mesh), mesh)
    for r in res:
        assert r["start"] == 2
        assert r["same"]
        assert r["blocks"]
        assert r["losses"][0] == r["losses"][1]
        assert r["d_packed"] == lay.d_packed
        assert r["g_len"] == 2 * lay.d_packed
        shapes = sorted(tuple(v) for k, v in r["shapes"].items()
                        if "params" in k)
        assert shapes == sorted(tuple(x.shape)
                                for _, x in tree_util.leaves(pa))
    assert res[0]["losses"] == res[1]["losses"]
