"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or ``repro`` (checked by importing every
module in a fresh interpreter and by an AST scan), device resolution
refuses a missing card, and ``chip_smoke.py`` fails without printing a
result when there is no card or no repo beside it."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return env


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]


def test_every_module_imports_without_jax_or_repro():
    modules = _port_modules()
    assert len(modules) >= 25
    assert {"repro_torch.bench.common", "repro_torch.bench.figures",
            "repro_torch.bench.paper_validation", "repro_torch.bench.serving_load",
            "repro_torch.bench.scenario_matrix", "repro_torch.runtime.load",
            "repro_torch.runtime.rescore", "repro_torch.models.moe", "repro_torch.dist",
            "repro_torch.dist.sched_bridge", "repro_torch.dist.elastic",
            "repro_torch.dist.straggler"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "sys.exit('imported: ' + ', '.join(bad) if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=_env(), capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_file_imports_jax_or_repro():
    # chip_smoke.py draws its placement and episode cases from tests/
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tests" / name for name in ("_place_cases.py", "_episode_cases.py")]
    assert len(files) >= 25
    assert {"common.py", "figures.py", "paper_validation.py", "serving_load.py",
            "scenario_matrix.py"} <= {f.name for f in files if f.parent.name == "bench"}
    assert {"load.py", "rescore.py"} <= {f.name for f in files if f.parent.name == "runtime"}
    assert "moe.py" in {f.name for f in files if f.parent.name == "models"}
    assert {"__init__.py", "sched_bridge.py", "elastic.py", "straggler.py"} <= {
        f.name for f in files if f.parent.name == "dist"}
    offenders = {
        str(f.relative_to(ROOT)): sorted(
            r for r in set(_imported_roots(f)) if r in ("jax", "jaxlib", "repro")
        )
        for f in files
    }
    assert {f: r for f, r in offenders.items() if r} == {}


def test_resolve_device(monkeypatch):
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], env=_env(),
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=env, capture_output=True,
        text=True, timeout=120, cwd=tmp_path,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_kernel_source_is_in_the_package():
    from repro_torch.kernels import sched_score

    src = sched_score._SRC
    assert src.is_file() and src.is_relative_to(PORT)
    text = src.read_text()
    assert "sched_score.py:121" in text  # names the TPU kernel it replaces
    assert "use_fast_math" not in " ".join(sched_score.NVCC_FLAGS)
    assert "sm_90a" in " ".join(sched_score.NVCC_FLAGS)


def test_gemm_kernel_source_is_in_the_package():
    from repro_torch.kernels import _build, tile_gemm

    src = tile_gemm._SRC
    assert src.is_file() and src.is_relative_to(PORT)
    text = src.read_text()
    assert "tile_gemm.py:53" in text  # names the TPU kernel it replaces
    assert "extern \"C\" int repro_gemm_update" in text
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "use_fast_math" not in flags


@pytest.mark.parametrize(
    "module,replaces,entry",
    [("flash_attention", "flash_attention.py:71", "repro_flash_attention"),
     ("flash_decode", "flash_decode.py:65", "repro_flash_decode")],
)
def test_attention_kernel_sources_are_in_the_package(module, replaces, entry):
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = mod._SRC
    assert src.is_file() and src.is_relative_to(PORT)
    text = src.read_text()
    assert replaces in text  # names the TPU kernel it replaces
    assert f'extern "C" int {entry}' in text
    assert mod._lib is None or torch.cuda.is_available()  # built at first use, not at import


@pytest.mark.parametrize(
    "module,attr,replaces,entry",
    [("flash_attention", "_SRC_TC", "flash_attention.py:71", "repro_flash_attention_sm90"),
     ("flash_decode", "_SRC_SPLIT", "flash_decode.py:65", "repro_flash_decode_split")],
)
def test_tensor_core_kernel_sources_are_in_the_package(module, attr, replaces, entry):
    """The tensor-core routes' sources sit beside the SIMT ones, are built
    with them, and name the TPU kernel they replace."""
    import importlib

    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = getattr(mod, attr)
    assert src.is_file() and src.is_relative_to(PORT) and src in mod.SOURCES
    text = src.read_text()
    assert replaces in text
    assert f'extern "C" int {entry}' in text


def test_build_helper_needs_nvcc(monkeypatch, tmp_path):
    """The shared nvcc helper raises where there is no compiler."""
    from repro_torch.kernels import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// empty\n")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(src)
    assert not list(tmp_path.glob("*.so"))


def test_place_kernel_source_is_in_the_package():
    """The placement kernels' source sits in the package, names the
    reference functions it replaces and exports both C entries; it is
    built at first use, not at import."""
    from repro_torch.kernels import sched_place

    src = sched_place._SRC
    assert src.is_file() and src.is_relative_to(PORT) and src in sched_place.SOURCES
    text = src.read_text()
    for name in ("backend.py:633", "backend.py:877", "dada.py:452-490"):
        assert name in text
    for entry in ("repro_dada_place", "repro_heft_select"):
        assert f'extern "C" int {entry}' in text
    assert sched_place._lib is None or torch.cuda.is_available()
