"""The faults of the port that its static analysis found, each held to
its repair (ROADMAP Queue 3):

* ``harness/mesh_mc.py::worker_draws`` read the worker ids back from the
  card inside the Monte-Carlo body (``worker_ids(mesh.device).tolist()``,
  a device sync the reference's ``gen_body`` does not have): it reads
  them on the host now, and the device-body purity pass holds it there;
* ``serving/index.py::ExactAucIndex._bg_merge_build`` (and the delta
  build's major and full tiers) re-placed a run under the index lock
  when a heal had replaced the mesh while the placement ran: the
  reference's compactor holds no lock across a placement. The compactor
  now places again with the lock released, until its placement is on
  the current mesh.
"""

import numpy as np
import torch

from tuplewise_tpu_torch.analysis import traced_purity
from tuplewise_tpu_torch.analysis.core import ModuleSet


def test_worker_draws_has_no_device_sync():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ms = ModuleSet.from_repo(repo)
    assert ("tuplewise_tpu_torch/harness/mesh_mc.py", "worker_draws") \
        in traced_purity.traced_roots(ms)
    fs = traced_purity.run(ms)
    assert not [f for f in fs
                if f.file == "tuplewise_tpu_torch/harness/mesh_mc.py"]


def test_worker_draws_reads_worker_ids_on_the_host(monkeypatch):
    from tuplewise_tpu_torch.harness.mesh_mc import worker_draws
    from tuplewise_tpu_torch.harness.variance import VarianceConfig
    from tuplewise_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(4, device="cpu")
    cfg = VarianceConfig(scheme="local", backend="mesh", n_pos=64,
                         n_neg=64, n_workers=4, n_reps=2)
    ref = worker_draws(cfg, mesh, ("mc_rep", 0))
    asked = []
    real = mesh.comm.worker_ids

    def spy(device):
        asked.append(device)
        return real(device)

    monkeypatch.setattr(mesh.comm, "worker_ids", spy)
    got = worker_draws(cfg, mesh, ("mc_rep", 0))
    assert asked == ["cpu"]
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_bg_merge_build_places_nothing_under_the_lock(monkeypatch):
    """A heal replaces the mesh while the compactor's placement runs with
    the lock released: the compactor places again, the lock again
    released, and swaps in a placement on the current mesh."""
    from tuplewise_tpu_torch import ExactAucIndex, make_stream
    from tuplewise_tpu_torch.parallel import sharded_counts
    from tuplewise_tpu_torch.parallel.mesh import make_mesh
    from tuplewise_tpu_torch.serving import index as index_mod

    scores, labels = make_stream(2000, seed=3)
    idx = ExactAucIndex(mesh=make_mesh(2, device="cpu"), delta_fraction=0,
                        compact_every=10 ** 9)
    idx.insert_batch(scores, labels)
    side = idx._pos
    with idx._cv:
        side.snap_buf, side.snap_tomb = len(side.buf), len(side.tomb)
        side.building = True

    held = []
    real_place = sharded_counts.place_base

    def place(mesh, arr, *a, **kw):
        held.append(idx._cv._is_owned())
        return real_place(mesh, arr, *a, **kw)

    monkeypatch.setattr(index_mod, "place_base", place)
    real_healed = idx._place_healed
    stale = []

    def place_healed(arr, prev=None):
        dev, cap, shipped, mesh = real_healed(arr, prev)
        if not stale:
            # a heal replaced the mesh while this placement ran
            stale.append(mesh)
            idx._mesh = make_mesh(2, device="cpu")
        return dev, cap, shipped, mesh

    monkeypatch.setattr(idx, "_place_healed", place_healed)
    idx._bg_merge_build(side, None)
    assert len(held) == 2 and not any(held), held
    assert not side.building and len(side.buf) == 0
    assert side.base_dev is not None and side.base_dev.shape[0] == 2
    pos, neg = idx.oracle_values()
    want = float(np.mean((pos[:, None] > neg[None, :])
                         + 0.5 * (pos[:, None] == neg[None, :])))
    assert abs(idx.auc() - want) < 1e-12
