"""The port stands alone: no jax, no `repro`, and no silent CPU fallback.

`repro_torch` and `chip_smoke.py` must import with `jax` and `repro`
blocked, and an entry point given no device must insist on the card.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py")
    if p.name != "__init__.py"
)

_BLOCKED_IMPORT = r"""
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "repro"):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["repro"] = None
"""


def _run_blocked(body: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT + body],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )


def test_port_imports_with_jax_and_repro_blocked():
    body = f"""
import importlib
for mod in {PORT_MODULES!r} + ["repro_torch"]:
    importlib.import_module(mod)
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", len({PORT_MODULES!r}))
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                f"{path}:{node.lineno} imports {name}")


def test_manager_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    body = """
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
try:
    ResourceManager(paper_ec2_catalog(), paper_profile_table())
except RuntimeError as exc:
    print("raised:", exc)
else:
    raise SystemExit("no error without a CUDA device")
m = ResourceManager(paper_ec2_catalog(), paper_profile_table(), device="cpu")
print("cpu:", m.device)
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised:" in proc.stdout and "cpu: cpu" in proc.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    # Alone in a directory, without the package beside it, it fails too.
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, str(alone)], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
