"""The port stands alone: no jax, no `repro`, and no silent CPU fallback.

`repro_torch`, `chip_smoke.py` and the port's examples must import with
`jax`, `repro` and the reference's `benchmarks` blocked, and an entry
point given no device must insist on the card.  The training launcher,
`examples/torch_train_small.py` and the three ported examples (quickstart,
allocation demo, camera serving) run on the CPU with the three blocked;
the launcher's ``--production-mesh`` fails in one process, naming the
ranks it needs.  Sharded execution (`sharding/execute.py`) and the
entry module of `tests/test_torch_sharded.py`'s ranks run with the three
blocked.  The sharded controller (`core/shard.py`) and
`chip_smoke.py`'s phase 4c, which runs `benchmarks/shard.py`'s scenarios
from its own copy of their builders, run with the three blocked.  Of the
port's scripts only the two that compute `chip_smoke.py`'s goldens import
the reference.
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
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in list(sys.modules):
    if name.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks"):
        del sys.modules[name]
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["benchmarks"] = None
"""


def _run_blocked(body: str, timeout: int = 120) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT + body],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_port_imports_with_jax_and_repro_blocked():
    body = f"""
import importlib
for mod in {PORT_MODULES!r} + ["repro_torch"]:
    importlib.import_module(mod)
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
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
    + ["chip_smoke.py", "examples/torch_train_small.py", "examples/torch_quickstart.py",
       "examples/torch_allocation_demo.py", "examples/torch_serve_cameras.py",
       "tests/torch_sharded_ranks.py"],
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
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro", "benchmarks"), (
                f"{path}:{node.lineno} imports {name}")


def _imports_reference(path: pathlib.Path) -> bool:
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n.split(".")[0] in ("repro", "benchmarks") for n in names):
            return True
    return False


def test_only_the_golden_scripts_import_the_reference():
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert {p.name for p in scripts if _imports_reference(p)} == {
        "torch_live_loop_goldens.py", "torch_shard_goldens.py"}


def test_shard_and_phase_4c_run_with_the_reference_blocked():
    """`core/shard.py` and `chip_smoke.py`'s phase-4c replays, cut small and
    on the CPU, with jax, `repro` and `benchmarks` blocked."""
    body = f"""
import functools
import torch
torch.set_num_threads(1)
sys.path.insert(0, {str(ROOT)!r})
import chip_smoke as cs
from repro_torch.core import shard
from repro_torch.core.manager import ResourceManager
pkg = cs.port_package()
pkg.ResourceManager = functools.partial(ResourceManager, device="cpu")
cs.SHARD_STREAMS, cs.SHARD_CELLS, cs.SHARD_EVENTS = 120, 2, 6
cs.PARITY_STREAMS, cs.PARITY_EVENTS = 10, 2
cs.CHURN_STREAMS, cs.CHURN_CELLS, cs.CHURN_EVENTS = 8, 2, 2
big, batched = cs.big_replay(pkg, lambda label: None)
assert big["delta"] == 0.0 and big["workers_equal"] and big["cells"] == 2, big
rep = cs.shard_repack(pkg, batched, lambda label: None)
par = cs.cost_parity(pkg, lambda label: None)
churn = cs.sharded_churn(pkg, lambda label: None)
assert par["one_cell_delta"] == 0.0 and churn["events"] > 0
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", big["cells"], rep["mode"], churn["events"])
"""
    proc = _run_blocked(body, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok 2")


def test_training_entry_points_run_with_the_reference_blocked(tmp_path):
    """`python -m repro_torch.launch.train` and the port's training example,
    a few steps each on the CPU, both writing their checkpoints."""
    body = f"""
import runpy
sys.argv = ["train", "--arch", "internlm2-1.8b", "--smoke", "--steps", "2", "--batch", "2",
            "--seq-len", "32", "--device", "cpu", "--ckpt", {str(tmp_path / "launch")!r}]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
sys.argv = ["torch_train_small.py", "--steps", "2", "--batch", "2", "--seq-len", "32",
            "--device", "cpu", "--ckpt", {str(tmp_path / "example")!r}]
runpy.run_path({str(ROOT / "examples" / "torch_train_small.py")!r}, run_name="__main__")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok")
    assert "checkpoint -> " in proc.stdout and "checkpoint written to " in proc.stdout
    for name in ("launch", "example"):
        assert (tmp_path / f"{name}.npz").is_file()
        assert (tmp_path / f"{name}.manifest.json").is_file()


def test_sharded_execution_runs_with_the_reference_blocked():
    """`sharding/execute.py`, `sharding/parallel.py` and the entry module of
    `tests/test_torch_sharded.py`'s ranks import with the three blocked, and
    a sharded train, prefill and decode step run on meta shards under a fake
    (2, 2) group (the dry-run's collective count)."""
    body = f"""
sys.path.insert(0, {str(ROOT / "tests")!r})
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch_sharded_ranks as ranks
from repro_torch.launch import dryrun
from repro_torch.sharding import execute, parallel
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
totals = []
for kind in ("train", "prefill", "decode"):
    for arch in ranks.ARCHS:
        coll = dryrun.count_collectives(ranks.config(arch), kind, mesh, multi_pod=False,
                                        batch=ranks.B, seq_len=ranks.S)
        totals.append(coll["total"]["count"])
dist.destroy_process_group()
assert min(totals) > 0, totals
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok", len(totals))
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok 12")


def test_examples_run_with_the_reference_blocked():
    """The three ported examples on the CPU with `jax`, `repro` and
    `benchmarks` blocked: the quickstart's 61% saving, the allocation
    demo's three backends agreeing, and the camera fleet served."""
    body = f"""
import runpy
out = {{}}
for name in ("torch_quickstart", "torch_allocation_demo", "torch_serve_cameras"):
    mod = runpy.run_path({str(ROOT / "examples")!r} + "/" + name + ".py", run_name=name)
    out[name] = mod["main"](["--device", "cpu"])
assert abs(out["torch_quickstart"]["savings"] - 0.61) < 0.005
demo = out["torch_allocation_demo"]
assert abs(demo["exact"] - demo["arcflow"]) < 1e-6 and demo["ffd"] >= demo["exact"]
assert sum(n for n, _ in out["torch_serve_cameras"]["served"].values()) == 9
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")
       and sys.modules[m] is not None]
assert not bad, bad
print("ok")
"""
    proc = _run_blocked(body, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("ok")


def test_production_mesh_needs_its_ranks():
    """``--production-mesh`` (and with ``--multi-pod``) in one process
    fails at once, naming the ranks the mesh needs and the ranks there
    are, and leaves no process group behind."""
    body = """
import torch.distributed as dist
from repro_torch.launch import train
for flags, need in (([], 256), (["--multi-pod"], 512)):
    try:
        train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1", "--device", "cpu",
                    "--production-mesh", *flags])
    except RuntimeError as exc:
        assert f"needs {need} ranks" in str(exc) and "has 1" in str(exc), exc
        print("raised:", exc)
    else:
        raise SystemExit("no error with one rank")
    assert not dist.is_initialized()
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert proc.stdout.count("raised: the ") == 2


def test_training_launcher_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    body = """
from repro_torch.device import KernelError
from repro_torch.launch import train
try:
    train.main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "1"])
except KernelError as exc:
    print("raised:", exc)
else:
    raise SystemExit("no error without a CUDA device")
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised: device cuda:0 requested" in proc.stdout


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


def test_sharded_controller_without_device_needs_the_card():
    """The sharded path raises `KernelError` without a card, from a manager
    given no device and from one whose device is the card: its batched
    pack and pricing run on the manager's device, never quietly on the
    host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    body = """
import torch
from repro_torch.core.catalog import paper_ec2_catalog
from repro_torch.core.manager import ResourceManager
from repro_torch.core.profiler import paper_profile_table
from repro_torch.core.shard import hash_cells
from repro_torch.core.streams import AnalysisProgram, StreamSpec
from repro_torch.device import KernelError
fleet = [StreamSpec(f"s{i}", AnalysisProgram("ZF", "zf"), 0.5) for i in range(12)]
try:
    ResourceManager(paper_ec2_catalog(), paper_profile_table()).sharded_controller(
        cell_key=hash_cells(3)).reset(fleet, pack="batched")
except KernelError as exc:
    print("raised:", exc)
else:
    raise SystemExit("no error without a CUDA device")
m = ResourceManager(paper_ec2_catalog(), paper_profile_table(), device="cpu")
sc = m.sharded_controller(cell_key=hash_cells(3))
sc.reset(fleet, pack="batched")
print("cpu:", sc.n_cells)
m.device = torch.device("cuda:0")
for call in (sc.repack, sc.refresh_prices, sc.rebalance,
             lambda: sc.reset(fleet, pack="batched")):
    try:
        call()
    except KernelError as exc:
        print("card:", exc)
"""
    proc = _run_blocked(body)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert "raised:" in proc.stdout and "cpu: 3" in proc.stdout
    assert proc.stdout.count("card: device cuda:0 requested") == 4


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
