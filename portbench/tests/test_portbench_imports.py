"""What the benchmark runs imports neither JAX nor the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]

RUN_A_CELL = """
import json, sys, torch
sys.path[:0] = [{src!r}, {root!r}]
sys.path.insert(0, {tests!r})
from conftest import _tiny
from portbench import harness
torch.set_num_threads(2)
cell, cfg, driver = _tiny("yi34b_l4_int8")
harness.run_cell(cell, cfg, driver, 5, 0.2, False, torch.device("cpu"), 0.0,
                 harness.benchmark(), "yi34b_l4_int8")
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import portbench.reference.cnn, portbench.reference.lm, portbench.reference.keys
import portbench.reference.int8, portbench.yardstick.compare, portbench.yardstick.flops
import portbench.yardstick.costs, portbench.yardstick.peaks, portbench.traffic
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(
        src=str(ROOT / "src"), root=str(ROOT), tests=str(ROOT / "portbench" / "tests"))],
        capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(RUN_A_CELL)
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "repro_torchlike", sys)
    assert "repro_torchlike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()
