#!/usr/bin/env python3
"""Times variants of the fleet's tenant count kernel (kernel 7,
``tuplewise_tpu_torch/csrc/tenant_count.cu``), with ``--masked`` of
kernel 2's masked auc and hinge routes (``csrc/rank_count.cu``), or with
``--flat`` of the index's signed count kernel (kernel 6,
``csrc/signed_count.cu``), in one run, on one GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 bench_torch_variants.py [OTHER_CHECKOUT]
    python3 bench_torch_variants.py --masked
    python3 bench_torch_variants.py --flat [OTHER_CHECKOUT]

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

With ``--flat`` the variants (``FLAT_VARIANTS``) are the two designs of
kernel 6's search: (b), the committed one (``csrc/signed_count.cu``), a
group of kLanes lanes a bound, the lower and upper bounds side by side,
at 16 and 8 lanes and two tops; and (a), kernel 7's shape
(``bench_signed_count_thread.cu``, built for this bench only), one thread
a (query, run) cell with kProbes splitters a round (2 and 3 halvings a
round: kProbes 3 and 7) and the upper bound searched again only at a
tie, at tops of 5 and 8 halvings. OTHER_CHECKOUT adds that
checkout's kernel as it is. Each is held against the searchsorted route
and timed by torch.profiler's device time a launch over 1000 launches at
chip_smoke.py phase 16's headline (two runs of 500000 values on a 1/64
grid at cap 2^19, 512 queries a set) and at the index's shape (two runs
of 250000 N(0, 1) values at cap 2^18, 255 and 257 queries), each with
half-tied queries (half of them run values) and untied ones (N(0, 1)),
in two turns. Beside each time: the longest dependent chain of a cell
for those queries, from the CPU emulation of
``signed_search.py`` (the other checkout's binary search:
chip_smoke.searched). Beside them, the floor of a launch: the
device time of zeroing the [4, 512] int32 block (one PyTorch fill
kernel), timed the same way.
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


# kernel 6's designs: the source, its constants replaced, and the (top
# levels, lanes a bound, splitters a lane) the CPU emulation takes. Design
# (a) runs one thread a cell in 32-thread blocks, so the blocks of a
# 512-query set are 16, not 2
FLAT_SOURCE = os.path.join(CSRC, "signed_count.cu")
FLAT_THREAD_SOURCE = os.path.join(ROOT, "bench_signed_count_thread.cu")
FLAT_VARIANTS = {
    "committed: (b) 16 lanes, top 8": (FLAT_SOURCE, {}, (8, 16, 1)),
    "(b) 8 lanes, top 8": (FLAT_SOURCE, {"kLanes": 8}, (8, 8, 1)),
    "(b) 16 lanes, top 5": (FLAT_SOURCE, {"kTopLevels": 5}, (5, 16, 1)),
    "(a) top 5, 2 halvings a round": (
        FLAT_THREAD_SOURCE, {"kProbes": 3, "kTopLevels": 5}, (5, 1, 3)),
    "(a) top 8, 2 halvings a round": (
        FLAT_THREAD_SOURCE, {"kProbes": 3}, (8, 1, 3)),
    "(a) top 5, 3 halvings a round": (
        FLAT_THREAD_SOURCE, {"kProbes": 7, "kTopLevels": 5}, (5, 1, 7)),
    "(a) top 8, 3 halvings a round": (
        FLAT_THREAD_SOURCE, {"kProbes": 7}, (8, 1, 7)),
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


def flat_launcher(lib_path, runs, signs, sets, qa, qb):
    """A call of a signed-count library's kernel on these inputs, its
    arguments marshalled once."""
    import torch

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tw_signed_count.argtypes = [
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        i, p, i, p, i, p, i, p]
    lib.tw_signed_count.restype = i
    k = len(runs)
    ptrs = (ctypes.c_ulonglong * k)(*(r.data_ptr() for r in runs))
    lens = (ctypes.c_longlong * k)(*(r.numel() for r in runs))
    c_signs, c_sets = (ctypes.c_int * k)(*signs), (ctypes.c_int * k)(*sets)
    qcols = max(len(qa), len(qb))

    def run():
        out = torch.empty((4, qcols), dtype=torch.int32, device="cuda")
        err = lib.tw_signed_count(
            ptrs, lens, c_signs, c_sets, k, qa.data_ptr(), len(qa),
            qb.data_ptr(), len(qb), out.data_ptr(), qcols,
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return run


def flat_chain(design, runs, sets, qs):
    """The longest dependent chain of a cell of these inputs: the CPU
    emulation's for a design, the binary search's replay for None."""
    import chip_smoke as cs
    from signed_search import flat_search

    chain = 0
    for run, a in zip(runs, sets):
        if design is None:
            chain = max(chain, cs.searched(run, qs[a])[2])
            continue
        _, _, c, tie = flat_search(run.cpu(), qs[a].cpu(), design)
        chain = max(chain, int((c + tie).max()))
    return chain


def flat_main(card, others):
    """The --flat run (see the module note)."""
    import torch

    import chip_smoke as cs
    from tuplewise_tpu_torch.parallel import sharded_counts as sc

    tmp = tempfile.mkdtemp()
    sources = {name: variant_source(tmp, name, subs, source)
               for name, (source, subs, _) in FLAT_VARIANTS.items()}
    designs = {name: d for name, (_, _, d) in FLAT_VARIANTS.items()}
    for other in others:
        name = f"{other} as it is"
        sources[name] = os.path.join(os.path.abspath(other),
                                     "tuplewise_tpu_torch", "csrc",
                                     "signed_count.cu")
        designs[name] = None
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        built = dict(zip(sources, ex.map(build, sources.values())))
    for name, (_, ptxas) in built.items():
        print(f"[ptxas] {name}: {ptxas}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)

    def grid_run(n, shift):
        v = torch.round(torch.randn(n, generator=g, device="cuda") * 64) / 64
        return torch.sort(v + shift).values

    def normal_run(n, shift):
        return torch.sort(torch.randn(n, generator=g, device="cuda")
                          + shift).values

    shapes = {}
    for tag, make, n, (la, lb) in (
            ("headline", grid_run, cs.COUNT_BASE, (cs.COUNT_Q, cs.COUNT_Q)),
            ("index", normal_run, 250_000, (255, 257))):
        vals = [make(n, 0.0), make(n, 1.0)]
        cap = sc.next_bucket(n)
        runs = [cs.padded(v, cap) for v in vals]
        shapes[f"{tag}, tied"] = (runs, cs.tied_queries(g, la, vals[0]),
                                  cs.tied_queries(g, lb, vals[1]))
        shapes[f"{tag}, untied"] = (
            runs, torch.randn(la, generator=g, device="cuda"),
            torch.randn(lb, generator=g, device="cuda"))
    chains = {(name, tag): flat_chain(designs[name], runs, [0, 1], (qa, qb))
              for name in built for tag, (runs, qa, qb) in shapes.items()}
    times = {}
    block = torch.empty((4, cs.COUNT_Q), dtype=torch.int32, device="cuda")
    for turn in (1, 2):
        _, ms, _ = cs.timed_on_device(block.zero_, 1000)
        times.setdefault("floor: zero a [4, 512] int32 block", []).append(
            ms * 1e3)
        print(f"[turn {turn}] floor: zero a [4, 512] int32 block: "
              f"{ms * 1e3:.3f} us of device time a launch", flush=True)
        for name, (lib_path, _) in built.items():
            for tag, (runs, qa, qb) in shapes.items():
                run = flat_launcher(lib_path, runs, [1, 1], [0, 1], qa, qb)
                run()                                         # warm-up
                call_ms, ms, got = cs.timed_on_device(run, 1000)
                assert torch.equal(got, sc.signed_count_searchsorted(
                    runs, [1, 1], [0, 1], qa, qb)), (name, tag)
                key = f"{name} [{tag}]"
                times.setdefault(key, []).append(ms * 1e3)
                print(f"[turn {turn}] {key}: {ms * 1e3:.3f} us of device "
                      f"time a launch ({call_ms * 1e3:.2f} us a call); "
                      f"chain {chains[name, tag]} dependent rounds",
                      flush=True)
    print(json.dumps({"us": times, "chain": {f"{n} [{t}]": c for (n, t), c
                                             in chains.items()},
                      "card": card}), flush=True)
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
    if sys.argv[1:2] == ["--flat"]:
        return flat_main(card, sys.argv[2:])
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
