"""Pass 2 — device-body purity.

The reference enforces its integer-exactness and determinism contracts
inside every function reached by ``jax.jit`` / ``pl.pallas_call`` /
``shard_map``. Torch eager has no trace, so nothing marks the port's
device bodies: the pass takes its roots from two places instead.

* :data:`TRACED_ROOTS` — a declared table: each port function that is
  the counterpart of a function the reference's pass reaches from a
  traced root (the device design draws, the mesh Monte-Carlo body, the
  kernel launchers, the trainers' steps, the rng chain), with the
  reference functions it stands for. ``tests/test_torch_analysis_
  parity.py`` keeps it complete: every reference function reached from
  a traced root whose same-named counterpart exists in the port is a
  root here.
* every ``torch.autograd.Function``'s ``forward`` and ``backward``:
  autograd replays them, as a trace replays a traced body.

Inside those roots, and everything they call within the corpus
(confidently resolved bare-name calls, as in the reference), forbid:

* wall-clock reads (``time.time`` / ``perf_counter`` / ``monotonic``,
  ``datetime.now``) — rule ``traced-wall-clock``;
* host RNG: ``np.random.*``, ``random.*``, and torch's global generator
  (a ``torch.rand*`` / ``randint`` / ``randperm`` / ``normal`` / ...
  call, or an in-place ``uniform_`` / ``normal_`` / ..., without
  ``generator=``) — rule ``traced-host-rng``; every draw comes from a
  ``utils.rng.generator`` of its chain;
* ``float()`` / ``int()`` of a tensor — rule ``traced-float-coercion``
  (the exact count path must not detour through host floats);
* device syncs: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``torch.cuda.synchronize()`` — rule ``traced-device-sync``. The
  design draws run under ``torch.cuda.set_sync_debug_mode("error")`` on
  the card; this rule is that contract, held statically everywhere.

Tensor-ness is inferred locally (parameters annotated ``torch.Tensor``,
values of ``torch.*`` calls and of tensor methods, arithmetic and
subscripts of those): ``int(x.shape[0])`` is a host int, not a sync. A
read of a tensor made on the host in the same expression
(``comm.worker_ids("cpu").tolist()``) is no sync either.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from tuplewise_tpu_torch.analysis.core import (
    Finding, ModuleSet, call_name, dotted,
)

_P = "tuplewise_tpu_torch/"
_R = "tuplewise_tpu/"

#: port function (path, qualname) -> the reference functions reached
#: from a traced root that it stands for
TRACED_ROOTS: Dict[Tuple[str, str], Tuple[str, ...]] = {
    # the device design draws (same names)
    (_P + "ops/device_design.py", "_check_design"):
        (_R + "ops/device_design.py::_check_design",),
    (_P + "ops/device_design.py", "_distinct_design"):
        (_R + "ops/device_design.py::_distinct_design",),
    (_P + "ops/device_design.py", "_overdraw"):
        (_R + "ops/device_design.py::_overdraw",),
    (_P + "ops/device_design.py", "draw_pair_design_device"):
        (_R + "ops/device_design.py::draw_pair_design_device",),
    (_P + "ops/device_design.py", "draw_triplet_design_device"):
        (_R + "ops/device_design.py::draw_triplet_design_device",),
    (_P + "ops/device_design.py", "shard_design_blocks"):
        (_R + "ops/device_design.py::shard_design_blocks",),
    (_P + "ops/kernels.py", "builtin_triplet_spec"):
        (_R + "ops/kernels.py::builtin_triplet_spec",),
    (_P + "ops/pair_tiles.py", "sample_pair_indices"):
        (_R + "ops/pair_tiles.py::sample_pair_indices",),
    (_P + "ops/rank_auc.py", "rank_auc"):
        (_R + "ops/rank_auc.py::rank_auc",),
    (_P + "ops/scatter_exact.py", "is_builtin_scatter"):
        (_R + "ops/scatter_exact.py::is_builtin_scatter",),
    (_P + "ops/scatter_exact.py", "scatter_mesh_stats"):
        (_R + "ops/scatter_exact.py::scatter_mesh_stats",),
    (_P + "ops/scatter_exact.py", "scatter_pair_stats"):
        (_R + "ops/scatter_exact.py::scatter_pair_stats",
         _R + "ops/scatter_exact.py::_dup_pair_count"),
    (_P + "parallel/device_partition.py", "draw_blocks"):
        (_R + "parallel/device_partition.py::draw_blocks",
         _R + "parallel/device_partition.py::linear_shard_index"),
    (_P + "parallel/partition.py", "design_pad_len"):
        (_R + "parallel/partition.py::design_pad_len",),
    # the rng chain: the reference folds keys inside traced code
    (_P + "utils/rng.py", "derive_seed"):
        (_R + "utils/rng.py::fold", _R + "utils/rng.py::_purpose_id",
         _R + "utils/rng.py::_record_fold",
         _R + "utils/rng.py::_concrete"),
    (_P + "utils/rng.py", "generator"): (_R + "utils/rng.py::fold",),
    # the mesh Monte-Carlo body
    (_P + "harness/mesh_mc.py", "worker_draws"):
        (_R + "harness/mesh_mc.py::make_mesh_mc_runner.gen_body",),
    # the kernel launchers (the Pallas kernels' wrappers)
    (_P + "ops/pair_kernels.py", "pair_sum"):
        (_R + "ops/pallas_pairs.py::pallas_pair_sum",),
    (_P + "ops/pair_kernels.py", "masked_pair_sum"):
        (_R + "ops/pallas_pairs.py::pallas_masked_pair_sum",),
    (_P + "ops/pair_kernels.py", "pair_sum_any"):
        (_R + "ops/pallas_pairs.py::pallas_pair_sum_any",
         _R + "ops/pallas_pairs.py::pallas_pair_sum_any.masked_rows"),
    (_P + "ops/pair_grad_kernels.py", "pair_loss_grad"):
        (_R + "ops/pallas_pairs.py::pallas_pair_loss_grad",),
    (_P + "ops/pair_grad_kernels.py", "pair_grad_sums"):
        (_R + "ops/pallas_pairs.py::pallas_pair_grad_sums",),
    (_P + "ops/triplet_kernels.py", "batched_masked_pair_sum"):
        (_R + "ops/pallas_triplets.py::_batched_masked_pair_sum",),
    (_P + "ops/triplet_kernels.py", "triplet_combine_kernel"):
        (_R + "ops/pallas_triplets.py::triplet_combine_kernel",
         _R + "ops/pallas_triplets.py::_combine_kernel"),
    (_P + "ops/triplet_kernels.py", "sqdist_matrix"):
        (_R + "ops/pallas_triplets.py::_sqdist_matrix",),
    (_P + "ops/triplet_kernels.py", "triplet_stats_best"):
        (_R + "ops/pallas_triplets.py::triplet_stats_best",),
    (_P + "ops/triplet_kernels.py", "grouped_triplet_stats"):
        (_R + "ops/pallas_triplets.py::pallas_triplet_stats",
         _R + "ops/pallas_triplets.py::pallas_triplet_stats._clamp"),
    (_P + "ops/triplet_kernels.py", "anchor_chunk"):
        (_R + "ops/pallas_triplets.py::preferred_anchor_chunk",),
    (_P + "ops/count_kernels.py", "signed_count"):
        (_R + "ops/pallas_counts.py::sharded_signed_count_fn.f",),
    (_P + "ops/count_kernels.py", "signed_count_mesh"):
        (_R + "ops/pallas_counts.py::sharded_signed_count_fn.f",),
    (_P + "ops/count_kernels.py", "tenant_count"):
        (_R + "ops/pallas_counts.py::_tenant_call.call",
         _R + "ops/pallas_counts.py::_tenant_call.pack_spec"),
    (_P + "ops/count_kernels.py", "tenant_count_mesh"):
        (_R + "ops/pallas_counts.py::tenant_signed_count_fn.f",
         _R + "ops/pallas_counts.py::tenant_signed_count_fn.body"),
    # the count layer's device bodies (the reference's jitted XLA twins)
    (_P + "parallel/sharded_counts.py", "signed_count_searchsorted_mesh"):
        (_R + "parallel/sharded_counts.py::_xla_signed_pair_fn.f",
         _R + "parallel/sharded_counts.py::sharded_count_fn.f",
         _R + "parallel/sharded_counts.py::sharded_multi_count_fn.f"),
    (_P + "parallel/sharded_counts.py", "signed_count_searchsorted"):
        (_R + "serving/index.py::_jit_count_fn.f",),
    (_P + "parallel/sharded_counts.py", "tenant_count_searchsorted_mesh"):
        (_R + "parallel/sharded_counts.py::tenant_count_fn.f",
         _R + "parallel/sharded_counts.py::tenant_count_fn.body"),
    (_P + "parallel/sharded_counts.py", "tenant_count_searchsorted"):
        (_R + "parallel/sharded_counts.py::tenant_count_local_fn.f",
         _R + "parallel/sharded_counts.py::tenant_count_local_fn._rows"),
    (_P + "parallel/sharded_counts.py", "delta_append"):
        (_R + "parallel/sharded_counts.py::delta_append_fn.f",),
    (_P + "parallel/sharded_counts.py", "sharded_major_merge"):
        (_R + "parallel/sharded_counts.py::_merge_chunk_fn.f",
         _R + "parallel/sharded_counts.py::_merge_window_fn.f",
         _R + "parallel/sharded_counts.py::_merge_delta_fn.f",
         _R + "parallel/sharded_counts.py::_merge_assemble_fn.f"),
    # the backends' device bodies
    (_P + "backends/torch_backend.py", "TorchBackend._pair_sum"):
        (_R + "backends/jax_backend.py::JaxBackend.__init__.complete_fn",),
    (_P + "backends/torch_backend.py", "TorchBackend._round_from_blocks"):
        (_R + "backends/jax_backend.py::JaxBackend.__init__.local_round",),
    (_P + "backends/torch_backend.py", "TorchBackend.block_means"):
        (_R + "backends/jax_backend.py::JaxBackend.__init__.local_round",),
    (_P + "backends/torch_backend.py", "TorchBackend._round"):
        (_R + "backends/jax_backend.py::JaxBackend.__init__."
              "repartitioned_fn",
         _R + "backends/jax_backend.py::JaxBackend.__init__.draw_blocks"),
    (_P + "backends/mesh_backend.py", "MeshBackend.complete_stats"):
        (_R + "backends/mesh_backend.py::MeshBackend.__init__.complete_fn",),
    (_P + "backends/mesh_backend.py", "MeshBackend.round_mean"):
        (_R + "backends/mesh_backend.py::MeshBackend.__init__.one_round",
         _R + "backends/mesh_backend.py::MeshBackend.__init__."
              "local_mean_body",
         _R + "backends/mesh_backend.py::MeshBackend.__init__.repart_fn",
         _R + "backends/mesh_backend.py::MeshBackend.__init__.draw_blocks"),
    (_P + "backends/mesh_backend.py", "MeshBackend.incomplete_designed"):
        (_R + "backends/mesh_backend.py::MeshBackend.__init__.designed_fn",
         _R + "backends/mesh_backend.py::MeshBackend.__init__."
              "designed_body",
         _R + "backends/mesh_backend.py::MeshBackend.__init__."
              "designed_triplet_body"),
    (_P + "backends/mesh_backend.py", "MeshBackend.incomplete_swr"):
        (_R + "backends/mesh_backend.py::MeshBackend.__init__."
              "incomplete_fn",),
    # the trainers' compiled steps
    (_P + "models/pairwise_sgd.py", "sgd_step"):
        (_R + "models/pairwise_sgd.py::_compiled_trainer.sgd_body",
         _R + "models/pairwise_sgd.py::_compiled_trainer.sgd_body."
              "loss_fn"),
    (_P + "models/pairwise_sgd.py", "_blocks"):
        (_R + "models/pairwise_sgd.py::_compiled_trainer.draw_blocks",),
    (_P + "models/pairwise_sgd.py", "_sampled_pairs"):
        (_R + "models/pairwise_sgd.py::_compiled_trainer.draw_blocks",),
    (_P + "models/triplet_sgd.py", "sgd_step"):
        (_R + "models/triplet_sgd.py::_compiled_triplet_trainer.sgd_body",),
    (_P + "models/triplet_sgd.py", "sample_triplets"):
        (_R + "models/triplet_sgd.py::_compiled_triplet_trainer.draw",),
    (_P + "models/triplet_sgd.py", "_blocks"):
        (_R + "models/triplet_sgd.py::_compiled_triplet_trainer.draw",),
    (_P + "models/sim_learner.py", "_test_aucs"):
        (_R + "models/sim_learner.py::_compiled_auc_eval.ev",),
    (_P + "parallel/faults.py", "_collective_probe"):
        (_R + "parallel/faults.py::_collective_probe.probe",),
}

_AUTOGRAD_BASES = {"torch.autograd.Function", "autograd.Function",
                   "Function"}

_WALL_CLOCK = {"time.time", "time.perf_counter", "time.monotonic",
               "time.time_ns", "time.perf_counter_ns",
               "datetime.now", "datetime.datetime.now",
               "datetime.utcnow"}
#: torch draws that take the global generator unless given one
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "rand_like", "randn_like", "randint_like", "bernoulli",
                "multinomial", "poisson"}
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "exponential_",
                  "bernoulli_", "geometric_", "cauchy_", "log_normal_"}
_SYNC_LEAVES = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"torch.cuda.synchronize"}

#: torch calls that return host values, not tensors
_TORCH_HOST = {"device", "Generator", "Size", "dtype", "finfo", "iinfo",
               "is_tensor", "is_floating_point", "get_default_dtype",
               "no_grad", "inference_mode", "enable_grad"}
#: tensor methods and attributes that return host values
_HOST_METHODS = {"size", "dim", "numel", "item", "tolist", "element_size",
                 "is_contiguous", "data_ptr", "stride", "nelement",
                 "get_device", "is_floating_point"}
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda",
               "requires_grad", "layout"}


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    return any(dotted(b) in _AUTOGRAD_BASES for b in cls.bases)


class _Tensors:
    """Local tensor-ness of the names of one function."""

    def __init__(self, fn: ast.AST):
        self.names: Set[str] = set()
        args = getattr(fn, "args", None)
        if args is not None:
            for a in args.args + args.kwonlyargs:
                if a.annotation is not None and (dotted(a.annotation) or "") \
                        .split(".")[-1] == "Tensor":
                    self.names.add(a.arg)
        # two sweeps: a name assigned from a tensor later in the body
        for _ in range(2):
            for st in ast.walk(fn):
                if isinstance(st, ast.Assign) and self.is_tensor(st.value):
                    for t in st.targets:
                        for n in ast.walk(t):
                            if isinstance(n, ast.Name):
                                self.names.add(n.id)
                elif isinstance(st, ast.AugAssign) \
                        and isinstance(st.target, ast.Name) \
                        and self.is_tensor(st.value):
                    self.names.add(st.target.id)

    def is_tensor(self, e: ast.AST) -> bool:
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, ast.Call):
            cn = call_name(e)
            if cn is not None and cn.startswith("torch."):
                return cn.split(".")[1] not in ("cuda", "distributed") \
                    and cn.split(".")[-1] not in _TORCH_HOST
            if isinstance(e.func, ast.Attribute):
                return e.func.attr not in _HOST_METHODS \
                    and self.is_tensor(e.func.value)
            return False
        if isinstance(e, ast.Attribute):
            return e.attr not in _HOST_ATTRS and self.is_tensor(e.value)
        if isinstance(e, ast.Subscript):
            return self.is_tensor(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_tensor(e.left) or self.is_tensor(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_tensor(e.operand)
        return False


def _host_made(e: ast.AST) -> bool:
    """A tensor made on the host: a call given the device ``"cpu"``
    (``worker_ids("cpu")``, ``torch.zeros(n, device="cpu")``). Reading
    it back is no device sync."""
    if not isinstance(e, ast.Call):
        return False
    vals = list(e.args) + [k.value for k in e.keywords
                           if k.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu"
               for v in vals)


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def traced_roots(ms: ModuleSet) -> Set[Tuple[str, str]]:
    """The declared roots present in the corpus, plus every
    ``torch.autograd.Function``'s ``forward`` / ``backward``."""
    roots: Set[Tuple[str, str]] = set()
    for path, mi in ms.modules.items():
        quals = {fi.qualname for fi in mi.iter_functions()}
        for (p, q) in TRACED_ROOTS:
            if p == path and q in quals:
                roots.add((p, q))
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.ClassDef) \
                    and _is_autograd_function(node):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and sub.name in ("forward", "backward"):
                        q = f"{node.name}.{sub.name}"
                        if q in quals:
                            roots.add((path, q))
    return roots


def reached(ms: ModuleSet) -> Tuple[Set[Tuple[str, str]],
                                    Dict[Tuple[str, str], ast.AST]]:
    """(every function reached from the roots, the function nodes)."""
    funcs: Dict[Tuple[str, str], ast.AST] = {}
    by_name: Dict[str, List[Tuple[str, str]]] = {}
    for path, mi in ms.modules.items():
        for fi in mi.iter_functions():
            funcs[(path, fi.qualname)] = fi.node
            by_name.setdefault(fi.qualname.split(".")[-1], []).append(
                (path, fi.qualname))

    def local_lookup(path: str, name: str
                     ) -> Optional[Tuple[str, str]]:
        mi = ms.modules[path]
        cands = [k for k in by_name.get(name, ()) if k[0] == path]
        if cands:
            return cands[0]
        resolved = ms.resolve_import(mi, name)
        if resolved is not None:
            tpath, sym = resolved
            cands = [k for k in by_name.get(sym or name, ())
                     if k[0] == tpath]
            if cands:
                return cands[0]
        return None

    calls: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
    for (path, qn), node in funcs.items():
        out: Set[Tuple[str, str]] = set()
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                cn = call_name(sub)
                if cn and "." not in cn:
                    k = local_lookup(path, cn)
                    if k is not None and k != (path, qn):
                        out.add(k)
        calls[(path, qn)] = out

    seen: Set[Tuple[str, str]] = set()
    frontier = list(traced_roots(ms))
    while frontier:
        k = frontier.pop()
        if k in seen:
            continue
        seen.add(k)
        frontier.extend(calls.get(k, ()))
    return seen, funcs


def run(ms: ModuleSet) -> List[Finding]:
    reach, funcs = reached(ms)
    findings: List[Finding] = []

    def scan(path: str, qn: str, node: ast.AST) -> None:
        tensors = _Tensors(node)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            cn = call_name(sub)
            leaf = (cn.split(".")[-1] if cn else
                    sub.func.attr if isinstance(sub.func, ast.Attribute)
                    else None)
            if leaf is None:
                continue
            if cn in _WALL_CLOCK:
                findings.append(Finding(
                    "traced-wall-clock", path, sub.lineno,
                    f"{qn}::{cn}",
                    f"wall-clock read {cn}() inside a device body "
                    f"({qn}): its value differs between a run and its "
                    "replay"))
            elif cn is not None and (
                    cn.startswith("np.random.")
                    or cn.startswith("numpy.random.")
                    or cn.startswith("random.")
                    or (cn.startswith("torch.") and leaf in _TORCH_DRAWS
                        and not _has_generator(sub))):
                findings.append(Finding(
                    "traced-host-rng", path, sub.lineno,
                    f"{qn}::{cn}",
                    f"host or global RNG {cn}() inside a device body "
                    f"({qn}): draw from a utils.rng.generator of the "
                    "body's chain"))
            elif isinstance(sub.func, ast.Attribute) \
                    and leaf in _INPLACE_DRAWS and not _has_generator(sub):
                findings.append(Finding(
                    "traced-host-rng", path, sub.lineno,
                    f"{qn}::{leaf}",
                    f"in-place draw .{leaf}() on the global generator "
                    f"inside a device body ({qn}): pass generator="))
            elif cn in ("float", "int") and sub.args \
                    and tensors.is_tensor(sub.args[0]):
                findings.append(Finding(
                    "traced-float-coercion", path, sub.lineno,
                    f"{qn}::{cn}",
                    f"host {cn}() of a tensor inside a device body "
                    f"({qn}): a sync, and the exact count path must not "
                    "detour through host scalars (DESIGN §15)"))
            elif cn in _SYNC_CALLS or (
                    isinstance(sub.func, ast.Attribute)
                    and leaf in _SYNC_LEAVES and not sub.args
                    and not _host_made(sub.func.value)):
                findings.append(Finding(
                    "traced-device-sync", path, sub.lineno,
                    f"{qn}::{leaf}",
                    f"device sync {cn or leaf}() inside a device body "
                    f"({qn})"))

    for (path, qn) in sorted(reach):
        scan(path, qn, funcs[(path, qn)])

    seen: Set[str] = set()
    out: List[Finding] = []
    for f in findings:
        if f.fingerprint not in seen:
            seen.add(f.fingerprint)
            out.append(f)
    return out
