"""tools/profile_step.py's reduction from a profiler trace to device
metrics, on a small hand-written trace."""

import gzip
import json
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import profile_step  # noqa: E402


def _write_trace(tmp_path, events, hlo=None):
    if hlo is not None:
        (tmp_path / "hlo.txt").write_text(hlo)
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    meta = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 2, "name": "process_name",
         "args": {"name": "/device:GPU:0 (pid 2)"}},
    ]
    with gzip.open(d / "x.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": meta + events}, f)
    return str(tmp_path)


def _kernel(ts, dur, name, tf_op):
    return {"ph": "X", "pid": 2, "tid": 1, "ts": ts, "dur": dur, "name": name,
            "args": {"tf_op": tf_op}}


def test_busy_idle_and_scopes(tmp_path):
    events = [
        _kernel(0, 10, "fusion.1", "jit(serve)/attention/dot_general"),
        _kernel(5, 10, "fusion.2", "jit(serve)/mlp/dot_general"),   # overlaps
        _kernel(30, 10, "gemm.3", "jit(serve)/layer_norm/mul"),
        _kernel(50, 10, "copy.4", "jit(serve)/reshape"),
        # host events never count as device time
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 100, "name": "host"},
    ]
    out = profile_step.parse(_write_trace(tmp_path, events), steps=2, top=5)
    # busy = [0, 15] + [30, 40] + [50, 60] = 35 us over a 60 us window
    assert out["device_busy_ms_per_step"] == pytest.approx(35 / 1000 / 2)
    assert out["idle_share"] == pytest.approx(1 - 35 / 60)
    assert out["kernel_ms_per_step"] == pytest.approx(40 / 1000 / 2)
    scopes = out["scopes_ms_per_step"]
    assert scopes["attention"] == scopes["mlp"] == scopes["layer_norm"] \
        == pytest.approx(10 / 1000 / 2)
    assert scopes["other"] == pytest.approx(10 / 1000 / 2)


def test_scope_matches_whole_path_components():
    sc = profile_step._scope_of
    assert sc("jit(f)/transpose(jvp(mlp))/dot") == "mlp"
    assert sc("jit(f)/jvp(layer_norm)/mul") == "layer_norm"
    assert sc("jit(f)/mlp_extra/dot") == "other"
    assert sc("jit(f)/mlp/dot") == "mlp"
    assert sc("jit(f)/chunk_placement/scatter-add") == "chunk_placement"


def test_command_buffer_kernels_scoped_through_hlo(tmp_path):
    """Kernels replayed from a CUDA graph carry no op name in the trace;
    their fusion name maps to the compiled HLO's op metadata."""
    hlo = "\n".join([
        '  %loop_multiply_fusion.3 = bf16[8]{0} fusion(%p), kind=kLoop, '
        'calls=%f, metadata={op_name="jit(s)/layer_norm/mul" source_file="x.py"}',
        '  ROOT %custom-call.7 = bf16[8]{0} custom-call(%a), '
        'metadata={op_name="jit(s)/attention/dot_product_attention"}',
    ])
    cb = {"hlo_op": "command_buffer", "tf_op": "XlaModule:"}
    events = [
        {"ph": "X", "pid": 2, "ts": 0, "dur": 4, "name": "loop_multiply_fusion_3", "args": cb},
        {"ph": "X", "pid": 2, "ts": 4, "dur": 6, "name": "sdpa_kernel",
         "args": {"hlo_op": "custom-call.7", "tf_op": "XlaModule:"}},
        {"ph": "X", "pid": 2, "ts": 10, "dur": 1, "name": "Memset", "args": cb},
    ]
    assert profile_step.hlo_op_names(hlo) == {
        "loop_multiply_fusion.3": "jit(s)/layer_norm/mul",
        "custom-call.7": "jit(s)/attention/dot_product_attention"}
    out = profile_step.parse(_write_trace(tmp_path, events, hlo), steps=1, top=3)
    scopes = out["scopes_ms_per_step"]
    assert scopes["layer_norm"] == pytest.approx(0.004)
    assert scopes["attention"] == pytest.approx(0.006)
    assert scopes["other"] == pytest.approx(0.001)
