"""Runs of every cell driven on the CPU at a size a test run holds, past
the harness's look for a card: sound, the comparison passes; with the
reference in the next lower precision in the program's place, or with
the timed path broken underneath, ``correct`` comes out false."""

import importlib

import pytest
import torch

from benchmark import manifest, run
from tuplewise_tpu_torch.backends.mesh_backend import MeshBackend
from tuplewise_tpu_torch.models import pairwise_sgd
from tuplewise_tpu_torch.ops import pair_grad_kernels, pair_kernels, pair_tiles
from tuplewise_tpu_torch.parallel import comm as comm_mod
from tuplewise_tpu_torch.parallel import device_partition, ring

SEED = 2**31 + 777
SIZES = {"auc_gauss_1e7_w8": {"n_pos": 4000, "n_neg": 4000},
         "sgd_adult14_1e6_w8": {"n_pos": 480, "n_neg": 1520}}
MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def _run(cell):
    config = manifest.cell(MAN, cell)["config"]
    return run.run_cell(cell, SEED, 0.3, False, device="cpu",
                        overrides=SIZES[config])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(cell):
    w = manifest.cell(MAN, cell)
    config = {**manifest.config(MAN, w["config"]), **SIZES[w["config"]]}
    traffic = manifest.traffic(w["traffic"])
    limits = manifest.limits(cell)["limits"]
    job = importlib.import_module(f"benchmark.jobs.{config['entry']}")
    out = job.controls(config, traffic, SEED, "cpu")
    assert set(out) == set(job.VARIANTS)
    for variant, gaps in out.items():
        assert any(max(gaps[k]) > limit for k, limit in limits.items()), (
            variant, gaps)


def _stale_rows(monkeypatch):
    # a step that returns its state unchanged: every rep gets the first
    # rep's rows
    from tuplewise_tpu_torch.harness import mesh_mc

    orig, cache = mesh_mc.worker_draws, []

    def stale(cfg, mesh, chain):
        if not cache:
            cache.append(orig(cfg, mesh, chain))
        return cache[0]

    monkeypatch.setattr(mesh_mc, "worker_draws", stale)


def _half_ring(monkeypatch):
    # half of the stops left out, the mean taken over the rest
    def half(stats_fn, a, visiting, *, comm, axis, acc):
        vis = list(visiting)
        for _ in range(comm.shape[axis] // 2):
            nxt = comm.start_rotate(vis, axis)
            ds, dc = stats_fn(a, *vis)
            acc = (acc[0] + ds, acc[1] + dc)
            vis = nxt.wait()
        return acc, vis

    monkeypatch.setattr(ring, "_ring_accumulate", half)


def _half_workers(monkeypatch):
    orig = MeshBackend.round_mean

    def half(self, As, Bs, n1, n2, gen, scheme, alive):
        alive = alive.clone()
        alive[alive.shape[0] // 2:] = 0
        return orig(self, As, Bs, n1, n2, gen, scheme, alive)

    monkeypatch.setattr(MeshBackend, "round_mean", half)


def _no_rotation(monkeypatch):
    # the exchange between workers left out: the blocks never move
    monkeypatch.setattr(comm_mod.LocalComm, "start_rotate",
                        lambda self, tensors, axis, step=1:
                        comm_mod._Ready(tensors))


def _no_regather(monkeypatch):
    # the exchange left out: a worker takes its rows from its own shard
    def local(self, shards, idx):
        cap = shards.shape[1]
        return torch.gather(shards, 1, idx % cap)

    monkeypatch.setattr(comm_mod.LocalComm, "regather", local)


def _altered_sums(monkeypatch):
    # an answer altered where it is produced: the first problem's pair sum
    orig = pair_kernels._plain

    def altered(a, b, ma, mb, kernel):
        out = orig(a, b, ma, mb, kernel).clone()
        out.reshape(-1)[0] *= 1.01
        return out

    monkeypatch.setattr(pair_kernels, "_plain", altered)


def _frozen_step(monkeypatch):
    orig = pairwise_sgd.sgd_step

    def frozen(scorer, kernel, cfg, params, *a, **kw):
        _, loss = orig(scorer, kernel, cfg, params, *a, **kw)
        return {k: v.detach() for k, v in params.items()}, loss

    monkeypatch.setattr(pairwise_sgd, "sgd_step", frozen)


def _frozen_after_first_step(monkeypatch):
    # a call that stops updating after its first step
    orig = pairwise_sgd.sgd_step

    def frozen(scorer, kernel, cfg, params, Ab, Bb, seeds, t, *a, **kw):
        new, loss = orig(scorer, kernel, cfg, params, Ab, Bb, seeds, t,
                         *a, **kw)
        if t == 0:
            return new, loss
        return {k: v.detach() for k, v in params.items()}, loss

    monkeypatch.setattr(pairwise_sgd, "sgd_step", frozen)


def _no_regather_in_a_call(monkeypatch):
    # a call that keeps its first worker blocks for all its steps
    orig = pairwise_sgd._blocks

    def first(cfg, seeds, Xp, Xn, t):
        return orig(cfg, seeds, Xp, Xn, 0)

    monkeypatch.setattr(pairwise_sgd, "_blocks", first)


def _half_batch(monkeypatch):
    orig = pair_tiles.pair_mean_for_grad

    def half(kernel, s1, s2, impl=None):
        h = s1.shape[0] // 2
        v = orig(kernel, s1[:h], s2[:h], impl)
        return torch.cat([v, v.mean().expand(s1.shape[0] - h)])

    monkeypatch.setattr(pair_tiles, "pair_mean_for_grad", half)


def _own_shard_rows(monkeypatch):
    def local(self, idx):
        cap = self.shards.shape[1]
        w = torch.arange(idx.shape[-2]).reshape(1, -1, 1)
        return self.shards[w, idx % cap]

    monkeypatch.setattr(device_partition.ShardedRows, "__getitem__", local)


def _altered_loss(monkeypatch):
    orig = pair_grad_kernels.pair_loss_grad

    def altered(a, b, kernel, impl=None):
        loss, row, col = orig(a, b, kernel, impl)
        return loss * 1.01, row, col

    monkeypatch.setattr(pair_grad_kernels, "pair_loss_grad", altered)


FAULTS = {
    "auc_gauss_1e7_w8.complete": [_stale_rows, _half_ring, _no_rotation,
                                  _altered_sums],
    "auc_gauss_1e7_w8.complete_ragged": [_stale_rows, _half_ring,
                                         _no_rotation, _altered_sums],
    "auc_gauss_1e7_w8.repart_t4": [_stale_rows, _half_workers, _no_regather,
                                   _altered_sums],
    "sgd_adult14_1e6_w8.logistic_full": [_frozen_step,
                                         _frozen_after_first_step,
                                         _half_batch, _own_shard_rows,
                                         _no_regather_in_a_call,
                                         _altered_loss],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_comes_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0


def test_every_cell_has_its_faults():
    assert set(FAULTS) == set(CELLS)
