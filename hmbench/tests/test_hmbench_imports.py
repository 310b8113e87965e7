"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from hmbench.run import FORBIDDEN

HM = Path(__file__).resolve().parents[1]
PORT = "haghighatshoarmuir2024_tpu_torch"


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    for p in HM.rglob("*.py"):
        assert not (_imports(p) & set(FORBIDDEN)), p


def test_reference_imports_nothing_of_the_program():
    for p in (HM / "reference").rglob("*.py"):
        assert PORT not in _imports(p), p
        assert "hmbench" not in _imports(p), p  # nor the harness, which drives the program


REHEARSAL = """
import json, sys, torch
sys.path.insert(0, {root!r})
from hmbench import run as R
for wl, over in {small!r}.items():
    ctx = R.make_context(wl, 3, 0.05, False)
    ctx.devices = [torch.device("cpu")] * int(ctx.cell["chips"])
    ctx.traffic.update(over)
    R.execute(ctx)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_rehearsal_loads_no_jax(small):
    code = REHEARSAL.format(root=str(HM.parent), small=small)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
