"""The zoo's configs with MLA and recurrent mixers on a ``(data, model)``
mesh against the one-process model.

deepseek-v2-lite-16b-smoke (MLA), jamba-1.5-large-398b-smoke (Mamba) and
xlstm-125m-smoke (mLSTM, sLSTM) hold every leaf in its ``leaf_pspec``
block and run their mixers tensor parallel over ``model`` (MLA over the
rank's heads, the recurrences over its channels or heads, the latent
cache and the states in their ``cache_pspec`` blocks), the stream
batch-sharded over ``data`` and sequence-sharded over ``model``.  On a
gloo ``{data 2, model 2}`` world (one process a rank) they are held to
the port's one-process model, run in a process of its own, at
``tests/test_torch_zoo_mesh.py``'s tolerances: at capacity factor 16 no
pair drops, and without the router loss neither the experts' per-shard
capacity nor the mean of the shards' router losses changes a number.
``tests/test_torch_mixers_mesh.py`` holds the same configs at their own
MoE settings against the reference.  ``python
tests/test_torch_zoo_mesh_whole.py port|local ...`` are the two sides'
entry points.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_zoo_mesh import (  # noqa: E402
    WHOLE_MIXERS,
    _env,
    _match,
    join_mesh,
    run_all,
    run_case,
)


def port_main(rank, rdv, out):
    import torch.distributed as dist

    mesh = join_mesh(2, 2, rank, rdv)
    res = {}
    for name in WHOLE_MIXERS:
        res.update(run_case(name, mesh))
    np.savez(out, **res)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ``{2, 2}`` world and each config's one-process run, started
    together: ``port[(2, 2)][rank]`` and ``ref[name]``."""
    tmp = tmp_path_factory.mktemp("zoo_mesh_whole")
    here = os.path.abspath(__file__)
    procs = []
    for r in range(4):
        cmd = [sys.executable, here, "port", str(r), str(tmp / "rdv"),
               str(tmp / f"port_{r}.npz")]  # fmt: skip
        procs.append((f"port rank {r}", cmd, _env()))
    for name in WHOLE_MIXERS:
        cmd = [sys.executable, here, "local", name, str(tmp / f"local_{name}.npz")]
        procs.append((f"one process {name}", cmd, _env()))
    run_all(procs)
    port = {(2, 2): [dict(np.load(tmp / f"port_{r}.npz")) for r in range(4)]}
    ref = {name: dict(np.load(tmp / f"local_{name}.npz")) for name in WHOLE_MIXERS}
    return port, ref


@pytest.mark.parametrize("name", list(WHOLE_MIXERS))
def test_whole_mixer_configs_on_a_mesh_match_the_mesh_less_model(runs, name):
    """Every rank: the loss and token count of the loss and of 3 train
    steps' loss, total and grad norm (1e-5 relative), its block of every
    gradient (1e-5 of the leaf's scale), the whole params after the
    steps (1e-4), the prefill's and 4 decode steps' logits (1e-4).  The
    router loss itself (a mean of each shard's on the mesh, the whole
    batch's without one) is not compared: its weight is 0."""
    port, ref = runs
    _match(port, ref[name], name, metrics=("loss", "n_tokens"))


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        np.savez(sys.argv[3], **run_case(sys.argv[2], None))
