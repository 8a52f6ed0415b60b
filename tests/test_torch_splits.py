"""The port's numpy-only data splits, metrics and checkpoint helpers are
copies of the JAX package's: the same seed and the same arrays give
equal results."""

import numpy as np
import pytest

from tuplewise_tpu.data import splits as js
from tuplewise_tpu.models.metrics import auc_score as j_auc
from tuplewise_tpu.utils import checkpoint as jck
from tuplewise_tpu_torch.data import splits as ts
from tuplewise_tpu_torch.models.metrics import auc_score as t_auc
from tuplewise_tpu_torch.utils import checkpoint as tck


@pytest.mark.parametrize("args", [
    (64, 32, 5, 1.0, 0), (500, 125, 3, 0.8, 7), (10, 1000, 10, 0.0, 3),
])
def test_make_gaussian_splits_equal(args):
    for a, b in zip(ts.make_gaussian_splits(*args),
                    js.make_gaussian_splits(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("frac,seed", [(0.25, 0), (0.5, 3), (0.01, 9)])
def test_stratified_split_and_standardize_equal(frac, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((301, 4))
    y = (rng.random(301) < 0.3).astype(int)
    got = ts.stratified_split(X, y, test_fraction=frac, seed=seed)
    want = js.stratified_split(X, y, test_fraction=frac, seed=seed)
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(gb, wb)
    for a, b in zip(ts.standardize_pair(got[0][0], got[1][0]),
                    js.standardize_pair(want[0][0], want[1][0])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="test_fraction"):
        ts.stratified_split(X, y, test_fraction=1.0)


def test_auc_score_equal():
    rng = np.random.default_rng(2)
    pos = np.round(rng.normal(1, 1, 400), 1)
    neg = np.round(rng.normal(0, 1, 300), 1)
    assert t_auc(pos, neg) == j_auc(pos, neg)


def test_checkpoints_cross_packages(tmp_path):
    p = str(tmp_path / "ck.npz")
    cfg = {"kernel": "hinge", "steps": 5, "lr": 0.1}
    tck.save_checkpoint(p, step=5, params={"w": np.arange(3.0)},
                        extra={"loss": np.ones(5)}, config=cfg)
    a, b = tck.load_checkpoint(p), jck.load_checkpoint(p)
    assert a["step"] == b["step"] == 5 and a["config"] == b["config"] == cfg
    np.testing.assert_array_equal(a["params"]["w"], b["params"]["w"])
    start, ck = tck.resume_progress(p, dict(cfg, steps=9),
                                    progress_key="steps", requested=9)
    assert start == 5 and ck["extra"]["loss"].shape == (5,)
    assert list(tck.iter_chunks(5, 12, 3)) == list(jck.iter_chunks(5, 12, 3))
    assert tck.params_digest({"w": np.arange(3.0)}) == \
        jck.params_digest({"w": np.arange(3.0)})
    with pytest.raises(ValueError, match="mismatch"):
        tck.check_config(cfg, dict(cfg, lr=0.2))
