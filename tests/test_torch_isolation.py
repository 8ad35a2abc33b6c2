"""The port stands alone: no module of ``videollm_online_tpu_torch`` and no
line of ``chip_smoke.py`` imports JAX or the JAX package, and every module
imports with JAX made unimportable."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "videollm_online_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "videollm_online_tpu"}
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    bad = FORBIDDEN.intersection(_imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_relative_imports_stay_inside_the_package():
    for path in PORT.rglob("*.py"):
        depth = len(path.relative_to(PORT).parts) - 1
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level <= depth + 1, (path, node.level)


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'videollm_online_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import videollm_online_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 13


def test_entry_points_take_the_cpu_only_when_asked():
    """Without a card, the cli's ``--device cpu`` (or ``device="cpu"``) is
    the only way onto the CPU: every entry point of the demo path refuses
    a silent fallback."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")

    from videollm_online_tpu_torch.core.config import (live1_plus_config,
                                                       tiny_live_config)
    from videollm_online_tpu_torch.models import builder, convert
    from videollm_online_tpu_torch.serve import cli
    from videollm_online_tpu_torch.serve.engine import LiveInferEngine
    from videollm_online_tpu_torch.serve.multistream import MultiStreamEngine
    from videollm_online_tpu_torch.tokenizer.live_tokenizer import (
        LiveTokenizer)
    from videollm_online_tpu_torch.tokenizer.tiny import ByteTokenizer

    args = cli.parse_args(["--video", "x.avi", "--with_vision"])
    assert args.device == ""
    tok = LiveTokenizer(ByteTokenizer(), tiny_live_config())
    calls = [
        lambda: cli.build_engine(args),
        lambda: builder.build_vision_params(live1_plus_config()),
        lambda: convert.llama_params_from_state_dict({}, tok.cfg.llama),
        lambda: LiveInferEngine({}, tok),
        lambda: MultiStreamEngine({}, tok),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
