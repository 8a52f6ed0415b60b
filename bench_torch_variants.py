#!/usr/bin/env python3
"""Times variants of the fleet's tenant count kernel (kernel 7,
``tuplewise_tpu_torch/csrc/tenant_count.cu``), or with ``--masked`` of
kernel 2's masked auc and hinge routes (``csrc/rank_count.cu``), in one
run, on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bench_torch_variants.py [OTHER_CHECKOUT]
    python3 bench_torch_variants.py --masked

Each variant is this checkout's source with some of its compile-time
constants replaced (``VARIANTS``: the halvings a block takes from shared
memory, the halvings a round below them, the cells a thread, the threads
a block); OTHER_CHECKOUT adds that checkout's source as it is. All are
built with nvcc in parallel (ptxas -v printed), held against the batched
``torch.searchsorted`` route, and timed by torch.profiler's device time a
launch over 200 launches (chip_smoke.timed_on_device) at chip_smoke.py
phase 20's headline (T_bucket 1024, the packs of make_tenant_stream(10^6,
1024, skew 1.1, seed 0) at caps 2^17, the last 256-event apply's query
block) and with a dense block (every cell a distinct N(0, 1) query), in
two turns. It prints one line a variant and turn, one JSON object of the
times and the card's name and power limit. Without a CUDA device it
exits nonzero.

With ``--masked`` the variants (``MASKED_VARIANTS``) change the chunk of
a that one search block of the masked routes takes (``kSumSweeps``
rounds of kIlp searches a thread, shared with the unmasked hinge); each
is held against the plain version (auc equal, hinge within rel 1e-9) and
timed at chip_smoke.py phase 5's masked shape (W = 8, 125001 x 125000,
N(0, 1) scores, the last value of 3 workers' a weighted 0) by
torch.profiler's device time a call over 50 calls and split by kernel
(sort, search, finish), in two turns.
"""

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "tuplewise_tpu_torch", "csrc")
SOURCE = os.path.join(CSRC, "tenant_count.cu")
# name: the constants replaced in the committed source
VARIANTS = {
    "committed": {},
    "binary search (no top, 1 halving a round, 1 cell)": {
        "kTopLevels": 1, "kLevels": 1, "kCells": 1, "kThreads": 256},
    "top 5, 1 halving a round": {"kLevels": 1},
    "top 5, 3 halvings a round": {"kLevels": 3},
    "top 3": {"kTopLevels": 3},
    "top 8": {"kTopLevels": 8},
    "1 cell a thread": {"kCells": 1, "kThreads": 256},
}


# kernel 2's masked routes: the rounds of kIlp searches a thread in one
# search block, so its chunk of a (the committed source: 32)
MASKED_VARIANTS = {
    "committed": {},
    "2 sweeps": {"kSumSweeps": 2},
    "8 sweeps": {"kSumSweeps": 8},
    "16 sweeps": {"kSumSweeps": 16},
}


def variant_source(tmp, name, subs, source=SOURCE):
    """This checkout's source with ``constexpr int <key> = ...;`` set to
    each value of subs, written under tmp."""
    import re

    src = open(source).read()
    for key, value in subs.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;",
                         f"constexpr int {key} = {value};", src)
        assert n == 1, (name, key)
    path = os.path.join(tmp, f"v{len(os.listdir(tmp))}.cu")
    with open(path, "w") as f:
        f.write(src)
    return path


def build(path):
    from tuplewise_tpu_torch.ops import _build

    out = path[:-3] + ".so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas",
                           "-v", "-o", out, path], capture_output=True,
                          text=True, timeout=600, check=True)
    ptxas = " | ".join(line.split(":", 1)[-1].strip()
                       for line in (proc.stdout + proc.stderr).splitlines()
                       if "Used" in line or "spill" in line)
    return out, ptxas


def launcher(lib_path, pos, neg, qn, qp):
    import torch

    lib = ctypes.CDLL(lib_path)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tw_tenant_count.argtypes = [p, ll, p, ll, p, p, i, i, p, p]
    lib.tw_tenant_count.restype = i
    T, qb = qn.shape

    def run():
        out = torch.empty((4, T, qb), dtype=torch.int32, device="cuda")
        err = lib.tw_tenant_count(
            neg.data_ptr(), neg.shape[1], pos.data_ptr(), pos.shape[1],
            qn.data_ptr(), qp.data_ptr(), T, qb, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run


def masked_main(card):
    """The --masked run (see the module note)."""
    import torch

    import chip_smoke as cs
    from tuplewise_tpu_torch.ops import _build, rank_count
    from tuplewise_tpu_torch.ops import pair_kernels as pk
    from tuplewise_tpu_torch.ops.kernels import get_kernel

    tmp = tempfile.mkdtemp()
    source = os.path.join(CSRC, "rank_count.cu")
    sources = {name: variant_source(tmp, name, subs, source)
               for name, subs in MASKED_VARIANTS.items()}
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        built = dict(zip(sources, ex.map(build, sources.values())))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    ab = torch.randn(8, 125001, generator=g, device="cuda")
    bb = torch.randn(8, 125000, generator=g, device="cuda")
    ma, mb = torch.ones_like(ab), torch.ones_like(bb)
    ma[5:, -1] = 0.0
    want = {name: pk.masked_pair_sum(ab, bb, ma, mb, get_kernel(name),
                                     impl="plain")
            for name in ("auc", "hinge")}
    times = {}
    for turn in (1, 2):
        for vname, (lib_path, _) in built.items():
            # the variant's library in place of the built one
            _build._LIBS["rank_count.cu"] = ctypes.CDLL(lib_path)
            for name in ("auc", "hinge"):
                def run():
                    return rank_count.masked_pair_sums(
                        ab, bb, ma, mb, hinge=name == "hinge")
                got = run()
                if name == "auc":
                    assert torch.equal(got, want[name]), vname
                else:
                    rel = ((got - want[name]).abs() / want[name].abs()).max()
                    assert float(rel) < 1e-9, (vname, float(rel))
                call_ms, ms, _ = cs.timed_on_device(run, 50)
                split = cs.device_ms_by_kernel(run, 20)
                key = f"{vname} [{name}]"
                times.setdefault(key, []).append(ms)
                times.setdefault(f"{key} by kernel", []).append(split)
                print(f"[turn {turn}] {key}: {ms:.4f} ms of device time a "
                      f"call ({call_ms:.4f} ms by CUDA events); by kernel "
                      f"{json.dumps(split)}", flush=True)
    _build._LIBS.pop("rank_count.cu", None)
    print(json.dumps({"ms": times, "card": card}), flush=True)
    print(card, flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("bench_torch_variants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    card = cs.card_line()
    if sys.argv[1:2] == ["--masked"]:
        return masked_main(card)
    tmp = tempfile.mkdtemp()
    sources = {name: variant_source(tmp, name, subs)
               for name, subs in VARIANTS.items()}
    for other in sys.argv[1:]:
        sources[f"{other} as it is"] = os.path.join(
            os.path.abspath(other), "tuplewise_tpu_torch", "csrc",
            "tenant_count.cu")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        built = dict(zip(sources, ex.map(build, sources.values())))
    for name, (_, ptxas) in built.items():
        print(f"[ptxas] {name}: {ptxas}", flush=True)

    scores, labels, tids = cs.fleet_stream(cs.FLEET_EVENTS, cs.FLEET_TENANTS)
    pos, neg, _, _ = cs.fleet_packs(scores, labels, tids, cs.FLEET_TENANTS)
    last = cs.fleet_chunks(scores[-cs.FLEET_CHUNK:], labels[-cs.FLEET_CHUNK:],
                           tids[-cs.FLEET_CHUNK:], cs.FLEET_CHUNK)[0]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    blocks = {"headline": cs.apply_queries(last, cs.FLEET_TENANTS)}
    blocks["dense"] = tuple(torch.randn(q.shape, generator=g, device="cuda")
                            for q in blocks["headline"])
    times = {}
    for turn in (1, 2):
        for name, (lib_path, _) in built.items():
            for tag, (qn, qp) in blocks.items():
                run = launcher(lib_path, pos, neg, qn, qp)
                run()                                         # warm-up
                call_ms, ms, got = cs.timed_on_device(run, 200)
                assert torch.equal(got, sc.tenant_count_searchsorted(
                    pos, neg, qn, qp)), (name, tag)
                times.setdefault(f"{name} [{tag}]", []).append(ms * 1e3)
                print(f"[turn {turn}] {name} [{tag}]: {ms * 1e3:.3f} us of "
                      f"device time a launch ({call_ms * 1e3:.2f} us a call)",
                      flush=True)
    print(json.dumps({"us": times, "card": card}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
