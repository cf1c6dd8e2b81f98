"""The profiling entry point of porepy_tpu_torch on the CPU
(``applications/profiling/run_profiling.py``, on ``torch.profiler``)
against porepy_tpu's (on ``jax.profiler``): both command lines at the
coarsest refinement of geometry 0 (Flemisch et al. case 1 at 1/16) report
the same dofs and Newton iterations; ``profile_run`` ends at porepy_tpu's
pressures within 1e-10; ``--trace`` writes a Chrome trace that
``read_trace`` reads (host events only on the CPU: the card's busy share is
0); and without a card the entry exits non-zero unless ``--device cpu``
is given. The port's command runs in a process in which ``import jax``
fails."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Runs a module as ``python -m`` does, in a process where jax cannot be imported.
_NO_JAX = "import runpy, sys; sys.modules['jax'] = None; sys.argv[0] = {m!r}; runpy.run_module({m!r}, run_name='__main__', alter_sys=True)"
PORT_ENTRY = "porepy_tpu_torch.applications.profiling.run_profiling"


def _run(argv, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=600)


def _port(*args):
    return _run([sys.executable, "-c", _NO_JAX.format(m=PORT_ENTRY), *args], env={"CUDA_VISIBLE_DEVICES": ""})


def _line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    trace = tmp_path_factory.mktemp("trace")
    port = _line(_port("--device", "cpu", "--geometry", "0", "--grid-refinement", "0", "--trace", str(trace)))
    jax = _line(_run([sys.executable, "-m", "porepy_tpu.applications.profiling.run_profiling", "--platform", "cpu",
                      "--geometry", "0", "--grid-refinement", "0"], env={"JAX_PLATFORMS": "cpu"}))
    return port, jax, trace


def test_same_line_as_porepy_tpu(lines):
    port, jax, _trace = lines
    for key in ("physics", "geometry", "refinement", "num_dofs", "iterations"):
        assert port[key] == jax[key], key
    assert port["num_dofs"] == 463 and port["iterations"] >= 1
    assert set(jax) <= set(port)
    assert port["assembly_ms_median"] > 0 and port["solve_ms_median"] > 0


def test_trace_is_read(lines):
    """The Chrome trace exists and ``read_trace`` reads it: a window, host
    events, and on the CPU no device work (a busy share of 0 is what the
    CPU gives, not an error)."""
    from porepy_tpu_torch.applications.profiling.run_profiling import RUN_RANGE, read_trace

    port, _jax, trace = lines
    path = os.path.join(trace, "trace.json")
    assert port["trace"]["path"] == path and os.path.getsize(path) > 0
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == RUN_RANGE for e in events)
    assert any(e.get("cat") == "cpu_op" for e in events)
    got = read_trace(path)
    assert got["window_ms"] > 0 and got["window_ms"] <= 1e3 * port["run_s"] + 1.0
    assert got["busy_ms"] == 0.0 and got["busy_share"] == 0.0 and got["kernel_launches"] == 0
    assert {k: port["trace"][k] for k in got} == json.loads(json.dumps(got))


def test_pressures_as_porepy_tpu():
    """``profile_run`` on the model of the command line ends at porepy_tpu's
    pressures (its own entry's model, run by ``run_time_dependent_model``)
    within 1e-10 of the largest."""
    import torch

    import porepy_tpu as pt_jax
    from porepy_tpu.applications.profiling import run_profiling as rp_jax
    from porepy_tpu_torch.applications.profiling import run_profiling as rp

    torch.set_num_threads(1)
    model, params = rp.build_model("flow", 0, 0, device="cpu")
    out = rp.profile_run(model, params)
    assert out["iterations"] >= 1 and out["num_dofs"] == 463
    model_jax, params_jax = rp_jax.build_model("flow", 0, 0)
    pt_jax.run_time_dependent_model(model_jax, params_jax)
    p = model.equation_system.get_variable_values(["pressure"], time_step_index=0)
    p_jax = model_jax.equation_system.get_variable_values(["pressure"], time_step_index=0)
    assert p.shape == p_jax.shape
    assert np.max(np.abs(p - p_jax)) <= 1e-10 * np.max(np.abs(p_jax))


def test_no_card_no_run():
    """Without a card the entry does not fall back to the CPU: with no
    ``--device`` it exits non-zero and prints no line."""
    proc = _port("--geometry", "0")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not proc.stdout.strip()


def test_read_trace_ranges(tmp_path):
    """``read_trace`` on a hand-made trace: the busy union (overlapping
    kernels count once), the ranges' busy share, the device ms by family
    (a kernel by the range open at its launch, else by its name), the idle
    time by the
    innermost op or range open and the longest gap."""
    from porepy_tpu_torch.applications.profiling.run_profiling import RUN_RANGE, read_trace

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur, "args": args}

    events = [
        x("user_annotation", RUN_RANGE, 0, 100),
        x("user_annotation", "fused_time_block", 10, 60),
        x("user_annotation", "newton.assemble", 10, 20),
        x("cpu_op", "aten::mul", 12, 4),
        x("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=7),
        x("cuda_runtime", "cudaLaunchKernel", 17, 1, correlation=8),
        x("user_annotation", "newton.solve", 30, 30),
        x("user_annotation", "newton.flags", 60, 10),
        x("cpu_op", "aten::item", 61, 8),
        x("kernel", "dual_ew", 20, 10),
        x("kernel", "void at::native::vectorized_elementwise_kernel<4, at::native::MulFunctor>", 25, 10,
          correlation=7),
        x("kernel", "ell_spmv_kernel", 30, 5, correlation=8),  # a K1 launch of the assembly
        x("kernel", "amg_vcycle_kernel", 40, 20),
        x("gpu_memcpy", "Memcpy DtoH", 64, 2),
        x("kernel", "ell_spmv", 90, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = read_trace(str(path), ranges=("fused_time_block",))
    assert got["window_ms"] == pytest.approx(0.1)
    assert got["busy_ms"] == pytest.approx(0.042)  # [20, 35] + [40, 60] + [64, 66] + [90, 95]
    assert got["kernel_launches"] == 5
    r = got["ranges"]
    assert r["count"] == 1 and r["ms"] == pytest.approx(0.06)
    assert r["busy_ms"] == pytest.approx(0.037) and r["busy_share"] == pytest.approx(37 / 60)
    assert r["family_ms"]["assembly (K8, K15)"] == pytest.approx(0.025)
    assert r["family_ms"]["solve (K1, K3, K4, K2, K6)"] == pytest.approx(0.020)
    assert r["family_ms"]["other"] == pytest.approx(0.002)
    assert r["idle_ms"] == pytest.approx(0.023)  # [10, 20], [35, 40], [60, 64], [66, 70]
    assert r["idle_by_range"] == pytest.approx({"newton.assemble": 0.010, "newton.solve": 0.005,
                                                "newton.flags": 0.008})
    assert r["idle_by_op"]["aten::item"] == pytest.approx(0.006)
    assert r["idle_by_op"]["aten::mul"] == pytest.approx(0.004)
    assert [g["ms"] for g in r["longest_gaps"]] == pytest.approx([0.010, 0.005, 0.004, 0.004])
    assert r["longest_gaps"][0]["range"] == "newton.assemble"
