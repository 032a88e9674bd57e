"""Nothing the benchmark loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the reference loads nothing
of the port."""

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tdal"}

CELL = """
import sys, json, tempfile, torch
from pathlib import Path
sys.path.insert(0, {root!r})
from portbench import common, run
from portbench.tests import tiny
base = tiny.make_copy(Path(tempfile.mkdtemp()))
b = common.load_json(Path({root!r}) / "BENCHMARK.json")
for name in ("tiny_pp_train", "tiny_vn_detect"):
    r = common.Run(cell=common.load_cell(name, base), seed=7, seconds=0.5, trace=False,
                   device=torch.device("cpu"), workdir=Path(tempfile.mkdtemp()))
    run.execute(r, b, 0.0)
import portbench.controls
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import sys, json
sys.path.insert(0, {root!r})
import portbench.reference.data, portbench.reference.models, portbench.reference.sparse
import portbench.reference.judge, portbench.reference.optim
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def tops(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                       text=True, timeout=900, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_a_cell_loads_no_jax():
    loaded = tops(CELL)
    assert "tdal_torch" in loaded and "portbench" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = tops(REFERENCE)
    assert not loaded & (FORBIDDEN | {"tdal_torch"}), loaded & (FORBIDDEN | {"tdal_torch"})
