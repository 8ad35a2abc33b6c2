"""Nothing in portbench/ imports JAX or the JAX package (top-level names
compared whole), and nothing in portbench/reference/, where every family's
reference decoder lives, reaches the port."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "videollm_online_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


def test_no_jax_anywhere():
    for path in ROOT.rglob("*.py"):
        for name, level in _imports(path):
            if level == 0:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_whole_name_comparison():
    # the port's name begins with the JAX package's and is allowed
    assert "videollm_online_tpu_torch".split(".")[0] not in FORBIDDEN


def _portbench_module(name: str, level: int, path: Path):
    """The portbench file an import resolves to, or None outside it."""
    if level:
        base = path.parent
        for _ in range(level - 1):
            base = base.parent
        parts = name.split(".") if name else []
    elif name.split(".")[0] == "portbench":
        base, parts = ROOT.parent, name.split(".")
    else:
        return None
    target = base.joinpath(*parts)
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def test_reference_reaches_nothing_of_the_port():
    from portbench import registry
    for path in sorted((ROOT / "families").glob("[!_]*.py")):
        ref = Path(registry._load(path, "families").reference.__file__)
        assert ref.parent == ROOT / "reference", (path, ref)
    seen, todo = set(), list((ROOT / "reference").glob("*.py"))
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for name, level in _imports(path):
            top = name.split(".")[0] if level == 0 else ""
            assert top != "videollm_online_tpu_torch", (path, name)
            assert top not in FORBIDDEN, (path, name)
            dep = _portbench_module(name, level, path)
            if dep is not None:
                todo.append(dep)
            if level and not name:
                # ``from . import x``: the sibling modules
                tree = ast.parse(path.read_text())
                for node in ast.walk(tree):
                    if isinstance(node, ast.ImportFrom) and \
                            node.level == level and not node.module:
                        for a in node.names:
                            d = _portbench_module(a.name, level, path)
                            if d is not None:
                                todo.append(d)
    # the walk follows imports out of reference/ (dialogue.py's tokenizer)
    assert {"common.py", "tokenizer.py"} <= {p.name for p in seen}
