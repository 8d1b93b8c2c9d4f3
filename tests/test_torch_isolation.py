"""The port stands alone: no module of ``flipcomplexityempirical_tpu_torch``
(nor ``chip_smoke.py``, ``dense_turns.py`` and ``fold_turns.py``, nor
``tests/_parity.py`` and ``tests/_torch_enumeration.py``, which it
imports) imports jax, flax, the JAX package, matplotlib or networkx (the
card's machine has neither plotting nor graph library), and importing the
whole port with those made unimportable never loads the JAX package."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "flipcomplexityempirical_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "flipcomplexityempirical_tpu",
             "matplotlib", "networkx")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "dense_turns.py",
        ROOT / "fold_turns.py",
        ROOT / "tests" / "_parity.py",
        ROOT / "tests" / "_torch_enumeration.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_without_jax():
    code = textwrap.dedent("""
        import pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "matplotlib", "networkx"):
            sys.modules[name] = None
        import flipcomplexityempirical_tpu_torch as port
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            __import__(mod.name)
        import flipcomplexityempirical_tpu_torch.convert
        loaded = sorted(m for m in sys.modules
                        if m == "flipcomplexityempirical_tpu"
                        or m.startswith("flipcomplexityempirical_tpu."))
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
