"""Structural rules of the PyTorch port, checked on its sources:

* ``detmatch_tpu_torch/``, ``tools/port_probes/`` and ``chip_smoke.py``
  import no ``jax``/``flax`` and nothing of the JAX package
  ``detmatch_tpu``;
* the port's config loader, utilities (synthetic frames, visualisation)
  and numpy geometry import only the standard library, numpy and each
  other;
* on CPU tensors each kernel wrapper (the model ops of ``Ops`` and the
  one-hot ops K6 and K8) runs its plain twin and leaves its launch
  counter at 0; on any other non-CUDA device it raises, the backward
  wrappers included;
* no wrapper wraps a launch in ``try``/``except`` (no silent fallback).
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from detmatch_tpu_torch.ops import cuda as cuda_ops  # noqa: E402
from detmatch_tpu_torch.ops import spconv  # noqa: E402
from detmatch_tpu_torch.ops.cuda import build  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_gather  # noqa: E402
from detmatch_tpu_torch.ops.cuda import onehot_rows  # noqa: E402

PORT_FILES = (sorted((ROOT / "detmatch_tpu_torch").rglob("*.py"))
              + sorted((ROOT / "tools" / "port_probes").glob("*.py"))
              + [ROOT / "chip_smoke.py"])
NUMPY_ONLY_FILES = (
    sorted((ROOT / "detmatch_tpu_torch" / "config").glob("*.py"))
    + sorted((ROOT / "detmatch_tpu_torch" / "utils").glob("*.py"))
    + [ROOT / "detmatch_tpu_torch" / "data" / "np_geometry.py"])
WRAPPER_FILES = sorted((ROOT / "detmatch_tpu_torch" / "ops" / "cuda")
                       .glob("*.py"))


def _module_name(path):
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def imported_modules(path):
    """Absolute names of every module a file imports (relative imports
    resolved against the file's package)."""
    tree = ast.parse(path.read_text())
    pkg = _module_name(path).split(".")
    if path.name != "__init__.py":
        pkg = pkg[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            if node.module:
                yield mod
            else:
                for alias in node.names:
                    yield f"{mod}.{alias.name}"


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for name in imported_modules(path):
        assert _top(name) not in ("jax", "jaxlib", "flax", "detmatch_tpu"), (
            path, name)


@pytest.mark.parametrize("path", NUMPY_ONLY_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_config_and_synth_modules_need_only_numpy(path):
    numpy_only = {_module_name(p) for p in NUMPY_ONLY_FILES}
    for name in imported_modules(path):
        top = _top(name)
        assert (top in sys.stdlib_module_names or top == "numpy"
                or name.startswith(_module_name(path.parent))
                or name in numpy_only), (path, name)


def test_port_imports_with_jax_blocked():
    """Every port module, probe and chip_smoke.py imports in a process
    where jax, flax and the JAX package cannot."""
    mods = [_module_name(p) for p in PORT_FILES if p.name != "chip_smoke.py"]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'detmatch_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _cpu_inputs():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand(2, 64, 3, generator=g) * 4
    valid = torch.ones(2, 64, dtype=torch.bool)
    keys = torch.arange(0, 128, 2, dtype=torch.int32).expand(2, -1)
    keys = keys.contiguous()
    nkeys = (keys[..., None] + torch.arange(-1, 2, dtype=torch.int32)
             ).contiguous()
    return {
        "window_key_conv_batched": (
            torch.rand(2, 64, 4, generator=g), keys, nkeys, keys,
            torch.rand(3, 4, 8, generator=g), 1000),
        "fps_batched": (xyz, valid, 8),
        "ball_query_batched": (xyz[:, :8].contiguous(),
                               torch.ones(2, 8, dtype=torch.bool), xyz, valid,
                               1.0, 4),
        "solve_masked_batched": (torch.rand(2, 6, 6, generator=g),
                                 torch.arange(6).expand(2, -1) < 4),
        "key_conv_batched": (torch.rand(2, 64, 4, generator=g), keys, nkeys,
                             torch.rand(3, 4, 8, generator=g), 1000),
        "gather_conv_batched": (torch.rand(2, 64, 4, generator=g),
                                spconv.rulebook_batched(keys, nkeys),
                                torch.rand(3, 4, 8, generator=g)),
        "onehot_gather_conv": (torch.rand(64, 4, generator=g),
                               spconv.rulebook_batched(keys, nkeys)[0],
                               torch.rand(3, 4, 8, generator=g)),
        "onehot_take_rows_batched": (
            torch.rand(2, 64, 4, generator=g),
            torch.randint(-1, 70, (2, 30), generator=g, dtype=torch.int32)),
    }


# wrapper name -> (wrapper, its plain twin); the launch counter has the
# wrapper's name
WRAPPERS = {
    **{name: (getattr(cuda_ops.KERNELS, name), getattr(cuda_ops.PLAIN, name))
       for name in cuda_ops.Ops._fields},
    "onehot_gather_conv": (onehot_gather.onehot_gather_conv,
                           onehot_gather.onehot_gather_conv_plain),
    "onehot_take_rows_batched": (onehot_rows.onehot_take_rows_batched,
                                 onehot_rows.onehot_take_rows_plain),
}


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_takes_plain_path_on_cpu(name):
    args = _cpu_inputs()[name]
    kernel, plain = WRAPPERS[name]
    cuda_ops.reset_launch_counts()
    out, ref = kernel(*args), plain(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert torch.equal(a, b)
    assert cuda_ops.launch_counts()[name] == 0


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_off_cpu_without_cuda(name):
    """A tensor that is not on the CPU never reaches the plain twin: here
    (no card) the wrapper must raise rather than compute."""
    args = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _cpu_inputs()[name]]
    cuda_ops.reset_launch_counts()
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        WRAPPERS[name][0](*args)
    assert cuda_ops.launch_counts()[name] == 0


@pytest.mark.parametrize("path", WRAPPER_FILES, ids=lambda p: p.name)
def test_no_try_around_launches(path):
    tree = ast.parse(path.read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), path


def test_backward_wrapper_raises_off_cuda():
    """The sparse conv's backward kernel has no CPU path: its wrapper
    raises on any tensor that is not on the card and counts nothing."""
    args = _cpu_inputs()["window_key_conv_batched"]
    feats, keys, nkeys, _, weights, _ = args
    rb = spconv.rulebook_batched(keys, nkeys)
    dout = torch.zeros(2, 64, 8)
    cuda_ops.reset_launch_counts()
    for dev in ("cpu", "meta"):
        with pytest.raises((ValueError, TypeError, RuntimeError)):
            cuda_ops.window_key_conv_bwd(
                dout.to(dev), feats.to(dev), rb.to(dev), weights.to(dev))
    assert cuda_ops.launch_counts()["window_key_conv_bwd"] == 0


def test_key_conv_backward_wrapper_raises_off_cuda():
    """The key-compare conv's backward kernel has no CPU path either."""
    _, keys, nkeys, _, _ = _cpu_inputs()["key_conv_batched"]
    rb = spconv.rulebook_batched(keys, nkeys)
    dout = torch.zeros(2, 64, 8)
    cuda_ops.reset_launch_counts()
    for dev in ("cpu", "meta"):
        with pytest.raises((ValueError, TypeError, RuntimeError)):
            cuda_ops.key_conv_bwd(dout.to(dev), rb.to(dev), keys.shape[1])
    assert cuda_ops.launch_counts()["key_conv_bwd"] == 0


@pytest.mark.parametrize("name", ["onehot_gather_scatter",
                                  "onehot_scatter_rows"])
def test_onehot_backward_wrappers_raise_off_cuda(name):
    """The backward kernels of K6 and K8 have no CPU path either."""
    fn = getattr(cuda_ops, name)
    if name == "onehot_gather_scatter":
        _, rb, _ = _cpu_inputs()["onehot_gather_conv"]
        args = (torch.zeros(64, 8), rb)
    else:
        _, idx = _cpu_inputs()["onehot_take_rows_batched"]
        args = (torch.zeros(2, 30, 4), idx)
    cuda_ops.reset_launch_counts()
    for dev in ("cpu", "meta"):
        with pytest.raises((ValueError, TypeError, RuntimeError)):
            fn(*(a.to(dev) for a in args), 64)
    assert cuda_ops.launch_counts()[name] == 0


def test_build_is_keyed_by_sources_and_fails_loudly(monkeypatch, tmp_path):
    lib = build.library_path()
    assert lib.parent == ROOT / "build" / "kernels"
    assert lib == build.library_path()  # stable for an unchanged tree
    assert {p.name for p in build.CSRC_DIR.glob("*.cu")} >= {
        "window_key_conv.cu", "window_key_conv_bwd.cu", "fps.cu",
        "ball_query.cu", "hungarian_jv.cu", "key_conv.cu", "gather_conv.cu",
        "onehot_gather.cu", "onehot_rows.cu", "segment_sum.cu"}
    assert (build.CSRC_DIR / "gather_gemm.cuh").exists()
    assert "gather_gemm.cuh" in {p.name for p in build._sources()}
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()
