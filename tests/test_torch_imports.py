"""The port stands alone: nothing under ``src/repro_torch`` (nor
``chip_smoke.py``, nor the port's examples and tools) imports JAX or the
reference package, and its modules import on a box with no ``nvcc``, no
``triton`` and no GPU — kernels are built when they are first launched,
never at import."""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
    ROOT / "examples" / "tsne_torch.py",
    ROOT / "examples" / "meanshift_torch.py",
    ROOT / "examples" / "stream_torch.py",
    ROOT / "examples" / "serve_clusterkv_torch.py",
    ROOT / "examples" / "krr_torch.py",
    ROOT / "examples" / "spectral_torch.py",
    ROOT / "examples" / "train_lm_torch.py",
    ROOT / "tools" / "time_decode.py",
    ROOT / "tools" / "profile_stream.py",
    ROOT / "tools" / "profile_service.py",
    ROOT / "tools" / "profile_train.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {root}"
           for root, line in _imported_roots(path) if root in FORBIDDEN]
    assert not bad, "\n".join(bad)
    text = path.read_text()
    assert "importlib.import_module(\"repro." not in text
    assert "__import__(" not in text


def test_port_has_the_expected_modules():
    names = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for must in ("api.py", "convert.py", "_device.py", "core/registry.py",
                 "core/blocksparse.py", "core/interact.py", "core/knn.py",
                 "core/embedding.py", "core/hierarchy.py",
                 "core/ordering.py", "core/measures.py", "kernels/_build.py",
                 "kernels/bsr_spmv.py", "kernels/gamma_score.py",
                 "kernels/tsne_force.py", "kernels/ops.py",
                 "kernels/ref.py", "data/pipeline.py",
                 "configs/paper_spmv.py", "configs/base.py",
                 "configs/qwen2_0_5b.py", "core/clusterkv.py",
                 "kernels/block_attention.py", "kernels/decode_attend.py",
                 "models/attention.py", "models/param.py",
                 "models/model_api.py", "models/transformer.py",
                 "train/serve_loop.py", "serve/__init__.py",
                 "serve/session.py", "serve/streaming.py",
                 "serve/engine.py", "core/doublebuf.py",
                 "solvers/__init__.py", "solvers/cg.py",
                 "solvers/precond.py", "solvers/krr.py",
                 "solvers/lanczos.py", "solvers/spectral.py",
                 "core/costmodel.py", "core/autotune.py",
                 "checkpoint/__init__.py", "checkpoint/ckpt.py",
                 "launch/mesh.py", "core/shardplan.py", "core/dist.py",
                 "models/sharding.py", "models/moe.py", "models/mla.py",
                 "configs/granite_moe_3b_a800m.py",
                 "configs/h2o_danube_3_4b.py", "configs/minicpm3_4b.py",
                 "configs/llava_next_34b.py",
                 "configs/mistral_large_123b.py",
                 "configs/llama4_maverick_400b_a17b.py",
                 "models/mamba.py", "models/ssm_lm.py", "models/hybrid.py",
                 "models/encdec.py", "launch/serve.py",
                 "configs/falcon_mamba_7b.py", "configs/zamba2_1_2b.py",
                 "configs/whisper_medium.py", "optim/__init__.py",
                 "optim/optimizers.py", "train/trainer.py",
                 "launch/ft.py", "launch/analytic.py", "launch/train.py"):
        assert must in names, must
    cu = {p.name for p in (PORT / "kernels" / "csrc").glob("*.cu")}
    assert cu == {"bsr_spmv.cu", "gamma_pairs.cu", "tsne_force.cu",
                  "block_attention.cu", "decode_attend.cu"}


def test_modules_import_without_toolchain_or_jax():
    """A fresh interpreter imports every module of the port; afterwards
    neither JAX nor the reference package nor triton has been loaded, and
    no kernel has been built."""
    mods = [".".join(p.relative_to(PORT.parent).with_suffix("").parts)
            for p in PORT.rglob("*.py") if p.name != "__init__.py"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import repro_torch.kernels._build as b\n"
        "assert b._lib is None, 'a kernel was built at import'\n"
        "bad = [m for m in ('jax', 'jaxlib', 'repro', 'triton') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_launching_without_nvcc_raises_not_falls_back(monkeypatch):
    """Only *launching* needs the toolchain: with no nvcc the loader raises
    a clear error (a CUDA tensor never quietly takes the plain version)."""
    build = importlib.import_module("repro_torch.kernels._build")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", ROOT / "nonexistent_build_dir")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load()
    assert not (ROOT / "nonexistent_build_dir").exists()


def test_paper_config_matches_the_reference():
    from repro.configs import paper_spmv as ref_cfg
    from repro_torch.configs import paper_spmv as t_cfg
    assert t_cfg.MICRO == ref_cfg.MICRO
    for name in ("TABLE1", "FIG3"):
        ours, theirs = getattr(t_cfg, name), getattr(ref_cfg, name)
        assert [vars(e) for e in ours] == [vars(e) for e in theirs]
