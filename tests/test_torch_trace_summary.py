"""scripts_torch/trace_summary.py against the JAX package's
scripts/trace_summary.py.

The span JSONL, the Chrome export and the collapsed-stack samples are
host formats: the port's tables equal the reference's on the committed
fixtures. A trace directory is a torch.profiler trace: its device work
(the categories kernel, gpu_memcpy, gpu_memset) is digested by kernel
name, and a trace without device work raises.
"""

import gzip
import importlib.util
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SPANS = os.path.join(DATA, "trace_summary_spans.jsonl")
COLLAPSED = os.path.join(DATA, "trace_summary_prof.collapsed")


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("scripts/trace_summary.py", "ref_trace_summary")
PORT = _load("scripts_torch/trace_summary.py", "port_trace_summary")


@pytest.mark.parametrize("top_n", [3, 15])
def test_span_tables_equal_the_reference(top_n):
    assert PORT.summarize_spans(SPANS, top_n) == REF.summarize_spans(
        SPANS, top_n)
    assert PORT.digest(SPANS, top_n) == REF.summarize_spans(SPANS, top_n)


def test_chrome_export_tables_equal_the_reference(tmp_path):
    spans = PORT.load_spans(SPANS)
    doc = {"traceEvents": [
        {"ph": "X", "name": s["name"], "ts": s["t0_s"] * 1e6,
         "dur": s["dur_s"] * 1e6,
         "args": {k: s[k] for k in ("trace_id", "span_id", "parent_id")}}
        for s in spans]}
    path = str(tmp_path / "spans.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    assert PORT.summarize_spans(path) == REF.summarize_spans(path)


@pytest.mark.parametrize("top_n", [2, 15])
def test_host_tax_tables_equal_the_reference(top_n):
    assert PORT.summarize_collapsed(COLLAPSED, top_n) == \
        REF.summarize_collapsed(COLLAPSED, top_n)
    assert PORT.load_collapsed(COLLAPSED) == REF.load_collapsed(COLLAPSED)


def _profiler_trace(events):
    """A torch.profiler Chrome trace: a CPU op, a runtime call, and the
    given device events."""
    base = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 900.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 10.0, "dur": 5.0},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
    ]
    return {"schemaVersion": 1, "traceEvents": base + events}


KERNELS = [
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 100.0,
     "dur": 300.0,
     "name": "void (anonymous namespace)::grad_count_kernel<1, 10>("
             "float const*, float const*, int*, long, long)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 500.0,
     "dur": 100.0,
     "name": "void (anonymous namespace)::grad_count_kernel<1, 10>("
             "float const*, float const*, int*, long, long)"},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 700.0,
     "dur": 50.0, "name": "void at::native::vectorized_elementwise_kernel"
                          "<4, at::native::FillFunctor<float>>(int)"},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8, "ts": 800.0,
     "dur": 50.0, "name": "Memcpy DtoH (Device -> Pageable)"},
]


def test_profiler_trace_digests_the_device_work(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    with open(d / "trace.json", "w") as f:
        json.dump(_profiler_trace(KERNELS), f)
    out = PORT.digest(str(d), 14)
    lines = out.splitlines()
    assert lines[1].startswith("device events: 4  span: 0.001s")
    assert "summed op time: 0.001s" in lines[1]
    assert lines[3].split() == ["grad_count_kernel", "0.40", "80.0%"]
    assert lines[4].split() == ["vectorized_elementwise_kernel", "0.05",
                                "10.0%"]
    assert "Memcpy DtoH (Device -> Pageable)" in out
    assert "aten::sort" not in out and "cudaLaunchKernel" not in out


def test_gzipped_traces_below_the_directory_are_read(tmp_path):
    d = tmp_path / "trace" / "plugins" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump(_profiler_trace(KERNELS[:1]), f)
    out = PORT.summarize(str(tmp_path / "trace"))
    assert "device events: 1" in out and "grad_count_kernel" in out


def test_a_trace_without_device_work_raises(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    with open(d / "trace.json", "w") as f:
        json.dump(_profiler_trace([]), f)
    with pytest.raises(ValueError, match="no kernel"):
        PORT.summarize(str(d))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        PORT.summarize(str(empty))  # no trace json at all


def test_a_cpu_profiler_trace_raises(tmp_path):
    """A real torch.profiler trace of CPU work (utils.profiling.trace):
    host events only, so the digest refuses it."""
    import torch

    from tuplewise_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)):
        torch.sort(torch.randn(1000))
    assert os.path.exists(tmp_path / "trace.json")
    assert PORT.load_events(str(tmp_path))
    with pytest.raises(ValueError, match="CPU-only"):
        PORT.digest(str(tmp_path))


def test_kernel_names():
    assert PORT.kernel_name(KERNELS[0]["name"]) == "grad_count_kernel"
    assert PORT.kernel_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
    assert PORT.kernel_name("void sort_tiles_kernel(float const*)") == \
        "sort_tiles_kernel"
