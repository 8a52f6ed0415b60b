"""The port's Adult loaders, its flagship entry, its top-level exports and
its results-file rule, against the JAX package's, on the CPU.

The loaders are numpy copies: every array equals the reference's bit for
bit, on CSVs this test writes (rows with '?', adult.test's trailing '.',
a non-canonical category that falls back to a file-local vocabulary with
a warning), on an .npz, on the canonical adult.data + adult.test split
and on the built-in surrogate. The entry's forward (float32 scores, the
logistic pair mean over 2048 x 2048 pairs) equals the JAX entry's within
rel 1e-5: float32 terms summed in different orders.
"""

import warnings

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import tuplewise_tpu as J
from tuplewise_tpu.data import loaders as JL
from tuplewise_tpu.data import splits as JSp
from tuplewise_tpu.utils import results_io as Jio
import tuplewise_tpu_torch as T
from tuplewise_tpu_torch import graft_entry
from tuplewise_tpu_torch.data import loaders as TL
from tuplewise_tpu_torch.data import splits as TSp
from tuplewise_tpu_torch.ops import pair_kernels
from tuplewise_tpu_torch.utils import results_io as Tio

_ROWS = [
    "39, State-gov, 77516, Bachelors, 13, Never-married, Adm-clerical, "
    "Not-in-family, White, Male, 2174, 0, 40, United-States, <=50K",
    "50, Self-emp-not-inc, 83311, Bachelors, 13, Married-civ-spouse, "
    "Exec-managerial, Husband, White, Male, 0, 0, 13, United-States, >50K",
    "38, Private, 215646, HS-grad, 9, Divorced, Handlers-cleaners, "
    "Not-in-family, Black, Female, 0, 0, 40, ?, <=50K",
    "53, Private, 234721, 11th, 7, Married-civ-spouse, Handlers-cleaners, "
    "Husband, Black, Male, 0, 0, 40, Holand-Netherlands, >50K",
    "28, ?, 338409, Bachelors, 13, Married-civ-spouse, Prof-specialty, "
    "Wife, Black, Female, 0, 0, 40, Cuba, <=50K",
    "37, Private, 284582, Masters, 14, Married-civ-spouse, "
    "Exec-managerial, Wife, White, Female, 0, 0, 40, United-States, >50K",
    "short, row",
]


def _write(path, rows, test_file=False):
    lines = [r + "." if test_file else r for r in rows]
    if test_file:
        lines.insert(0, "|1x3 Cross validator")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("test_file", [False, True])
def test_parse_adult_csv_equals_reference(tmp_path, test_file):
    path = _write(tmp_path / "adult.csv", _ROWS, test_file)
    Xj, yj = JL.parse_adult_csv(path)
    Xt, yt = TL.parse_adult_csv(path)
    _same(Xj, Xt)
    _same(yj, yt)
    # '?' rows and the short row dropped; canonical one-hot width
    assert Xt.shape == (4, 6 + sum(map(len, TL._ADULT_CATEGORIES.values())))
    assert yt.tolist() == [0, 1, 1, 1]


def test_parse_adult_csv_non_canonical_category_warns(tmp_path):
    rows = [r.replace("State-gov", "Space-agency") for r in _ROWS[:2]]
    path = _write(tmp_path / "toy.csv", rows)
    with pytest.warns(UserWarning, match="non-canonical"):
        Xt, yt = TL.parse_adult_csv(path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Xj, yj = JL.parse_adult_csv(path)
    _same(Xj, Xt)
    _same(yj, yt)
    with pytest.raises(ValueError, match="no parseable rows"):
        TL.parse_adult_csv(_write(tmp_path / "empty.csv", ["a, b"]))


@pytest.mark.parametrize("n,seed,standardize", [(2000, 0, True),
                                                (777, 3, False)])
def test_load_adult_surrogate_equals_reference(tmp_path, monkeypatch, n,
                                               seed, standardize):
    monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path))
    Xj, yj, mj = JL.load_adult(n=n, seed=seed, standardize=standardize)
    Xt, yt, mt = TL.load_adult(n=n, seed=seed, standardize=standardize)
    _same(Xj, Xt)
    _same(yj, yt)
    assert mj == mt and mt["synthetic"]


def test_load_adult_files_equal_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    X, y = rng.normal(size=(50, 5)), (rng.random(50) < 0.3).astype(int)
    npz = tmp_path / "blob.npz"
    np.savez(npz, X=X, y=y)
    for kw in (dict(path=str(npz)), dict(path=str(npz), n=20, seed=2)):
        out_j, out_t = JL.load_adult(**kw), TL.load_adult(**kw)
        _same(out_j[0], out_t[0])
        _same(out_j[1], out_t[1])
        assert out_j[2] == out_t[2] and not out_t[2]["synthetic"]
    monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path))
    _write(tmp_path / "adult.data", _ROWS)
    out_j, out_t = JL.load_adult(), TL.load_adult()
    _same(out_j[0], out_t[0])
    assert out_t[2]["source"].endswith("adult.data")


def test_load_adult_splits_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("TUPLEWISE_DATA_DIR", str(tmp_path))
    for kw in (dict(), dict(n=3000, seed=5, test_fraction=0.4)):
        a, b = JSp.load_adult_splits(**kw), TSp.load_adult_splits(**kw)
        for x, y in zip(a[:4], b[:4]):
            _same(x, y)
        assert a[4] == b[4] and b[4]["split"] == "stratified"
    # the canonical split: adult.data + adult.test, column-aligned
    _write(tmp_path / "adult.data", _ROWS)
    _write(tmp_path / "adult.test", _ROWS[1:], test_file=True)
    a, b = JSp.load_adult_splits(), TSp.load_adult_splits()
    for x, y in zip(a[:4], b[:4]):
        _same(x, y)
    assert a[4] == b[4] and b[4]["split"] == "adult.test"
    assert b[0].shape[1] == b[2].shape[1]


def test_graft_entry_forward_equals_reference():
    fj, aj = jentry.entry()
    ft, at = graft_entry.entry(device="cpu")
    params, xp, xn = at
    assert xp.shape == xn.shape == (2048, 16) and xp.dtype == torch.float32
    np.testing.assert_array_equal(xp.numpy(), np.asarray(aj[1]))
    np.testing.assert_array_equal(params["w"].numpy(), np.asarray(aj[0]["w"]))
    want = float(fj(*aj))
    got = ft(*at)
    assert got.dtype == torch.float64 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-5)
    fp, ap = graft_entry.entry(device="cpu", impl="plain")
    assert float(fp(*ap)) == float(got)


def test_top_level_exports_match_reference():
    for name in ("auc_kernel", "hinge_kernel", "logistic_kernel",
                 "triplet_indicator_kernel", "triplet_hinge_kernel"):
        assert name in T.__all__ and name in J.__all__
        assert getattr(T, name).name == getattr(J, name).name
        assert getattr(T, name) is T.get_kernel(getattr(T, name).name)


@pytest.mark.parametrize("name", ["northstar.jsonl", "a/b.c.json",
                                  "plain", "x_quick.jsonl"])
def test_results_io_rule_matches_reference(name):
    for quick in (False, True):
        sib = Tio.quick_sibling(name, quick)
        assert sib == Jio.quick_sibling(name, quick)
        assert Tio.is_quick(sib) == Jio.is_quick(sib)
        assert Tio.strip_quick(sib) == Jio.strip_quick(sib)
    assert Tio.QUICK_SUFFIX == Jio.QUICK_SUFFIX


@pytest.mark.cuda
def test_graft_entry_on_the_card_launches_kernel_1():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = pair_kernels.LAUNCHES["pair_sum[logistic]"]
    f, args = graft_entry.entry()
    got = float(f(*args))
    fp, ap = graft_entry.entry(impl="plain")
    assert got == pytest.approx(float(fp(*ap)), rel=1e-5)
    assert pair_kernels.LAUNCHES["pair_sum[logistic]"] == before + 1
