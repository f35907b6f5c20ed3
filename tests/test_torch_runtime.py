"""The port's runtime (``repro_torch.runtime``): checkpoint/restore, retention,
background writes, heartbeat/straggler detection, the host scan and the
failure injector, on the CPU.  The cases of ``tests/test_runtime.py`` for
these, plus round trips of every dtype the serve layer's journal and a
bf16 state hold.  The file imports no JAX (the cross-package round trips
are in ``tests/test_torch_serve_ref.py``)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.monitor import (
    FailureInjector,
    Heartbeat,
    SimulatedFailure,
    _read_heartbeat,
    scan_hosts,
    write_host_heartbeat,
)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layers": {"w": torch.randn((4, 8), generator=g, dtype=torch.float32),
                   "b": torch.zeros((8,), dtype=torch.bfloat16)},
        "step": torch.tensor(17, dtype=torch.int32),
    }


def _leaves(tree):
    return [leaf for _, leaf in ckpt._paths(tree)]


def _bits(t):
    t = t.detach().cpu()
    view = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}
    return t.contiguous().view(view[t.element_size()]) if t.dim() else t.view(1).view(
        view[t.element_size()])


def test_checkpoint_roundtrip_bitwise(tmp_path):
    s = _state()
    ckpt.save(s, str(tmp_path), step=5)
    restored, step = ckpt.restore(s, str(tmp_path))
    assert step == 5
    for a, b in zip(_leaves(s), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(_bits(a), _bits(b))


def test_checkpoint_retention(tmp_path):
    s = _state()
    for step in (1, 2, 3, 4, 5):
        ckpt.save(s, str(tmp_path), step=step, keep=2)
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_checkpoint_background_write(tmp_path):
    t = ckpt.save(_state(), str(tmp_path), step=9, background=True)
    t.join(timeout=30)
    assert ckpt.latest_step(str(tmp_path)) == 9


def test_restore_specific_step(tmp_path):
    ckpt.save(_state(0), str(tmp_path), step=1, keep=5)
    ckpt.save(_state(1), str(tmp_path), step=2, keep=5)
    r1, _ = ckpt.restore(_state(), str(tmp_path), step=1)
    assert torch.equal(r1["layers"]["w"], _state(0)["layers"]["w"])


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int64, np.int32],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_checkpoint_roundtrip_dtypes(tmp_path, dtype, kind):
    """f64, f32 and int leaves, 0-d ones included, in dicts, lists and
    tuples: back bitwise, in the template's dtype and kind (numpy stays
    numpy, a tensor comes back a tensor on the template's device)."""
    rng = np.random.default_rng(2)
    arrs = [(rng.standard_normal((3, 4, 5)) * 100).astype(dtype),
            np.asarray(rng.standard_normal() * 100).astype(dtype)]
    leaf = (lambda a: torch.from_numpy(a.copy())) if kind == "tensor" else (lambda a: a)
    state = {"z": [leaf(arrs[0]), (leaf(arrs[1]),)], "a": leaf(arrs[1])}
    ckpt.save(state, str(tmp_path), step=0)
    template = {"z": [leaf(np.zeros_like(arrs[0])), (leaf(np.zeros_like(arrs[1])),)],
                "a": leaf(np.zeros_like(arrs[1]))}
    restored, _ = ckpt.restore(template, str(tmp_path))
    got = _leaves(restored)
    assert [type(g) for g in got] == [type(t) for t in _leaves(template)]
    for g, a in zip(got, [arrs[1], arrs[0], arrs[1]]):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == a.dtype and g.shape == a.shape
        assert g.tobytes() == a.tobytes()


def test_checkpoint_bf16_is_its_uint16_view(tmp_path):
    """A bf16 tensor is stored as its uint16 bits and restores bitwise into
    the template's bf16."""
    x = torch.randn(5, 7, dtype=torch.float32).to(torch.bfloat16)
    ckpt.save({"x": x}, str(tmp_path), step=3)
    raw = np.load(os.path.join(tmp_path, "step_00000003", "x.npy"))
    assert raw.dtype == np.uint16
    assert raw.tobytes() == x.view(torch.int16).numpy().tobytes()
    back, _ = ckpt.restore({"x": torch.zeros(5, 7, dtype=torch.bfloat16)}, str(tmp_path))
    assert back["x"].dtype == torch.bfloat16 and torch.equal(_bits(back["x"]), _bits(x))


def test_checkpoint_leaf_names_and_manifest(tmp_path):
    """Leaf files are the key paths joined by ``__`` (dict keys sorted,
    sequence indices), the manifest lists them and prints the structure."""
    state = {"b": [np.zeros(2), {"y": np.ones(1), "x": np.ones(1)}], "a": np.zeros(3)}
    ckpt.save(state, str(tmp_path), step=0)
    d = os.path.join(tmp_path, "step_00000000")
    assert sorted(os.listdir(d)) == ["a.npy", "b__0.npy", "b__1__x.npy", "b__1__y.npy",
                                     "manifest.json"]
    import json
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    assert man["keys"] == ["a", "b__0", "b__1__x", "b__1__y"] and man["step"] == 0
    assert man["treedef"] == "PyTreeDef({'a': *, 'b': [*, {'x': *, 'y': *}]})"


def test_checkpoint_restore_refuses_shardings(tmp_path):
    """``shardings`` is accepted: a ``None`` placement restores the leaf as
    saved, a ``(mesh, layout)`` placement as this rank's block (a tensor;
    on a one-rank mesh the whole grid), and a tree that is no prefix of the
    template is refused; a missing directory still raises."""
    from repro_torch.launch.mesh import Mesh
    grid = np.arange(2 * 3 * 4, dtype=np.float64).reshape(2, 3, 4)
    ckpt.save({"a": np.zeros(2), "g": grid}, str(tmp_path), step=0)
    tmpl = {"a": np.ones(2), "g": np.zeros((2, 3, 4))}
    got, _ = ckpt.restore(tmpl, str(tmp_path), shardings={"a": None})
    assert isinstance(got["g"], np.ndarray) and np.array_equal(got["g"], grid)
    got, _ = ckpt.restore(tmpl, str(tmp_path), shardings={"g": (Mesh.one_rank(), None)})
    assert isinstance(got["g"], torch.Tensor) and torch.equal(got["g"], torch.as_tensor(grid))
    assert isinstance(got["a"], np.ndarray)
    with pytest.raises(ValueError, match="prefix"):
        ckpt.restore(tmpl, str(tmp_path), shardings=[None])
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"a": np.zeros(2)}, str(tmp_path / "none"))


def test_heartbeat_straggler_detection():
    hb = Heartbeat(straggler_factor=3.0)
    for _ in range(20):
        hb.times.append(0.1)
    assert hb.check(0.1)["straggler"] is False
    assert hb.check(1.0)["straggler"] is True


def test_heartbeat_cold_start_returns_wellformed_record():
    hb = Heartbeat()
    first = hb.tick()
    assert first == {"step_time": None, "straggler": False, "warmup": True}
    second = hb.tick()
    assert second["straggler"] is False
    assert second["step_time"] >= 0.0


def test_heartbeat_identical_window_does_not_flag_median():
    hb = Heartbeat(straggler_factor=3.0)
    for _ in range(20):
        hb.times.append(0.1)
    rep = hb.check(0.1)
    assert rep["mad"] == 0.0 and rep["straggler"] is False
    hb0 = Heartbeat(straggler_factor=3.0)
    for _ in range(20):
        hb0.times.append(0.0)
    assert hb0.check(0.0)["straggler"] is False
    assert hb0.check(0.1)["straggler"] is True


def test_host_scan(tmp_path):
    d = str(tmp_path)
    write_host_heartbeat(d, 0, step=10, step_time=0.5)
    write_host_heartbeat(d, 1, step=12, step_time=0.5)
    rep = scan_hosts(d, timeout_s=60)
    assert rep["alive"] == [0, 1]
    assert rep["min_step"] == 10 and rep["max_step"] == 12
    rec = _read_heartbeat(os.path.join(d, "host_0.json"))
    assert rec["step"] == 10 and rec["step_time"] == 0.5
    assert scan_hosts(str(tmp_path / "none")) == {"alive": [], "dead": [], "min_step": None}


def test_host_scan_reads_flat_records_and_finds_dead_hosts(tmp_path):
    """The older flat heartbeat shape still scans; a stale host is dead."""
    import json
    import time
    with open(os.path.join(tmp_path, "host_3.json"), "w") as f:
        json.dump({"host": 3, "step": 4, "t": time.time() - 120, "step_time": 0.1}, f)
    write_host_heartbeat(str(tmp_path), 1, step=7, step_time=0.2)
    rep = scan_hosts(str(tmp_path), timeout_s=60)
    assert rep["alive"] == [1] and rep["dead"] == [3]
    assert rep["min_step"] == 4 and rep["max_step"] == 7


def test_heartbeat_is_a_schema_metric_record(tmp_path):
    """A heartbeat file is a ``repro.obs/v1`` metric record, also written to
    an enabled trace."""
    import json

    from repro_torch.obs import trace as obs
    path = str(tmp_path / "t.jsonl")
    obs.enable(path)
    try:
        write_host_heartbeat(str(tmp_path / "hb"), 2, step=5, step_time=0.25)
    finally:
        obs.disable()
    with open(os.path.join(tmp_path, "hb", "host_2.json")) as f:
        rec = json.load(f)
    assert obs.validate_record(rec) == [] and rec["kind"] == "metric"
    assert rec["name"] == "heartbeat" and rec["host"] == 2
    assert rec["attrs"] == {"step": 5, "step_time": 0.25}
    assert [r["name"] for r in obs.read_trace(path)] == ["heartbeat"]


def test_failure_injector():
    inj = FailureInjector(3)
    inj.maybe_fail(2)
    with pytest.raises(SimulatedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)  # fires once
    inj.maybe_fail_compile("any")   # the base injector never fails a build
