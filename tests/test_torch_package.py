"""The PyTorch port stands alone and never hides the device it runs on.

* Importing every module of `neural_speed_tpu_torch` (and `chip_smoke.py`)
  pulls in neither `jax` nor `neural_speed_tpu`, and no source file of the
  port imports them (AST walk).
* Importing builds nothing.
* Entry points default to the card: without one they raise instead of
  continuing on the CPU.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "neural_speed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "neural_speed_tpu")


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PKG.rglob("*.py"))


def _is_forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from neural_speed_tpu_torch import _build\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "                  'built': _build.kernels._libs is not None}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(REPO), env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    leaked = [m for m in out["mods"] if _is_forbidden(m)]
    assert leaked == []
    assert out["built"] is False


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_source_imports_jax(path):
    tree = ast.parse((REPO / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _is_forbidden(n)] == []


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_engine_without_device_raises_without_a_card(monkeypatch):
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.runtime.engine import Engine

    _no_card(monkeypatch)
    cfg = ArchConfig(name="llama", vocab_size=64, hidden_size=64, n_layers=1,
                     n_heads=2, n_kv_heads=2, intermediate_size=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine({}, cfg)
    for comp in (None, "int8", "int8t"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine({}, cfg, comp=comp)
        assert Engine({"layers": []}, cfg, device="cpu", comp=comp).comp == comp
    with pytest.raises(ValueError, match="comp must be one of"):
        Engine({"layers": []}, cfg, device="cpu", comp="int4")


def test_engine_comp_default_reads_the_environment_once(monkeypatch):
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.runtime.engine import Engine

    cfg = ArchConfig(name="llama", vocab_size=64, hidden_size=64, n_layers=1,
                     n_heads=2, n_kv_heads=2, intermediate_size=128)
    monkeypatch.setenv("NST_COMP", "int8t")
    eng = Engine({"layers": []}, cfg, device="cpu")
    monkeypatch.setenv("NST_COMP", "int8")
    assert eng.comp == "int8t"             # pinned at construction
    assert Engine({"layers": []}, cfg, device="cpu", comp=None).comp is None
    monkeypatch.delenv("NST_COMP")
    assert Engine({"layers": []}, cfg, device="cpu").comp is None


def test_other_entry_points_raise_without_a_card(monkeypatch):
    import numpy as np

    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.models.params import params_from_numpy
    from neural_speed_tpu_torch.ops.kv_cache import init_cache
    from neural_speed_tpu_torch.ops.paged_kv import init_paged_cache
    from neural_speed_tpu_torch.ops.qtypes import QSpec, named_qspec
    from neural_speed_tpu_torch.ops.sampling import init_state
    from neural_speed_tpu_torch.runtime.engine import PagedEngine
    from neural_speed_tpu_torch.utils.synthetic import synth_params

    _no_card(monkeypatch)
    cfg = ArchConfig(name="llama", vocab_size=64, hidden_size=64, n_layers=1,
                     n_heads=2, n_kv_heads=2, intermediate_size=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synth_params(cfg, QSpec())
    for name in ("nf4", "int5", "fp8_e4m3", "int8"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synth_params(cfg, named_qspec(name, 32))
        p = synth_params(cfg, named_qspec(name, 32), device="cpu")
        assert p["lm_head"]["w"].data[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(1, 1, 128, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros((2,), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_paged_cache(1, 1, 128, 2, 32, 3, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedEngine({}, cfg, max_len=128, page_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(0, 1, 64)
    # asking for the CPU is always allowed
    assert init_cache(1, 1, 128, 2, 32, device="cpu").k.device.type == "cpu"
    pool = init_paged_cache(1, 1, 128, 2, 32, 3, 16, device="cpu")
    assert pool.k_pages.device.type == "cpu" and pool.max_len == 128
    eng = PagedEngine({"layers": []}, cfg, max_len=128, page_size=16,
                      device="cpu")
    assert eng.cache.page_tables.device.type == "cpu"
    assert eng.n_pages == 128 // 16 + 1         # the trash page on top
    assert init_state(0, 1, 64, device="cpu").counts.device.type == "cpu"


def test_convert_subpackage_falls_under_the_import_checks():
    assert "neural_speed_tpu_torch.convert.quant_config" in _modules()
    assert any(p.endswith("convert/quant_config.py") for p in (
        str(q.relative_to(REPO)) for q in PKG.rglob("*.py")))


def test_chip_smoke_refuses_without_a_card():
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
