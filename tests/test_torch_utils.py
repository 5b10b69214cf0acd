"""The port's ``utils/debug.py`` and ``utils/profiling.py`` against the JAX
package's on the CPU: the same checks pass and fail on the same inputs, the
same relative error, the same timer summaries and report lines."""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from diffsbdd_tpu.geom.com import mean_zero_relative_error as jax_mean_zero_error
from diffsbdd_tpu.utils import debug as jax_debug
from diffsbdd_tpu.utils import profiling as jax_profiling
from diffsbdd_tpu_torch.utils import debug, profiling


def coords(seed, centred):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 6, 3)).astype(np.float32)
    mask = np.ones((2, 6), np.float32)
    mask[1, 4:] = 0.0
    if centred:
        x -= (x * mask[..., None]).sum(1, keepdims=True) / mask.sum(1)[:, None, None]
    return x * mask[..., None], mask


@pytest.mark.parametrize("centred", [True, False])
def test_mean_zero_checks_match_jax(centred):
    x, mask = coords(0, centred)
    want = float(jax_mean_zero_error(jnp.asarray(x), jnp.asarray(mask)))
    got = float(debug.mean_zero_relative_error(torch.tensor(x), torch.tensor(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    outcomes = []
    for check in (lambda: jax_debug.check_mean_zero(jnp.asarray(x), jnp.asarray(mask)),
                  lambda: debug.check_mean_zero(torch.tensor(x), torch.tensor(mask)),
                  lambda: debug.checkify_mean_zero(torch.tensor(x), torch.tensor(mask))):
        try:
            check()
            outcomes.append("pass")
        except AssertionError:
            outcomes.append("fail")
    # JAX's in-graph check, through checkify
    err, _ = checkify.checkify(lambda a, m: jax_debug.checkify_mean_zero(a, m))(
        jnp.asarray(x), jnp.asarray(mask))
    outcomes.append("pass" if err.get() is None else "fail")
    assert outcomes == ["pass" if centred else "fail"] * 4


def test_check_finite_matches_jax():
    x, _ = coords(1, True)
    tree = {"a": x, "b": {"c": x[0]}}
    jax_debug.check_finite(jax.tree_util.tree_map(jnp.asarray, tree))
    debug.check_finite(jax.tree_util.tree_map(torch.tensor, tree))
    bad = {"a": x, "b": {"c": x[0] / 0.0}}
    with pytest.raises(AssertionError):
        jax_debug.check_finite(jax.tree_util.tree_map(jnp.asarray, bad))
    with pytest.raises(AssertionError, match=r"\['b/c'\]"):
        debug.check_finite(jax.tree_util.tree_map(torch.tensor, bad))
    model = torch.nn.Linear(3, 2)
    debug.check_finite(model)
    with torch.no_grad():
        model.bias[0] = float("nan")
    with pytest.raises(AssertionError, match=r"\['bias'\]"):
        debug.check_finite(model)


def one_over(v):
    return 1.0 / v


@pytest.mark.parametrize("fn,value", [("log", 2.0), ("log", -1.0), ("one_over", 0.0)])
def test_checked_reports_what_checkify_reports(fn, value):
    """A finite result, a NaN (log of a negative number) and a division by
    zero: an error exactly where JAX's float checks report one.  (An
    infinity from overflow is an error here and not there: an eager check
    sees the outputs, not the operation that made them.)"""
    jax_fn, port_fn = (one_over, one_over) if fn == "one_over" else (jnp.log, torch.log)
    err, out = jax_debug.checked(jax_fn)(jnp.asarray(value))
    got_err, got = debug.checked(port_fn)(torch.tensor(value))
    assert (got_err.get() is None) == (err.get() is None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))
    if err.get() is None:
        got_err.throw()
    else:
        with pytest.raises(debug.NonFiniteError):
            got_err.throw()


def test_timers_match_jax(tmp_path, monkeypatch):
    for mod in (jax_profiling, profiling):
        with pytest.raises(RuntimeError):
            mod.StepTimer().stop()
        with pytest.raises(RuntimeError):
            mod.PocketTimer().stop("p")
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary()
    # the same clock readings on both sides
    readings = {"perf_counter": [1.0, 1.5, 2.0, 2.25], "time": [10.0, 13.0, 20.0, 21.5]}
    out = {}
    for name, mod in (("jax", jax_profiling), ("port", profiling)):
        clock = {k: list(v) for k, v in readings.items()}
        monkeypatch.setattr(mod, "time", SimpleNamespace(
            perf_counter=lambda: clock["perf_counter"].pop(0),
            time=lambda: clock["time"].pop(0)))
        st, pt = mod.StepTimer(), mod.PocketTimer()
        for pocket in ("1abc", "2xyz"):
            st.start()
            st.stop(torch.ones(2) if mod is profiling else jnp.ones(2))
            pt.start()
            pt.stop(pocket)
        pt.write(tmp_path / f"{name}.txt")
        out[name] = (st.summary(), pt.report(), (tmp_path / f"{name}.txt").read_text())
        monkeypatch.undo()
    assert out["port"] == out["jax"]
    assert out["port"][0] == {"mean_s": 0.375, "std_s": 0.125, "min_s": 0.25, "n": 2}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())
