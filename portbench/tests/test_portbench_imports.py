"""Nothing the harness runs loads JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's);
and nothing it runs reads the JAX-era benchmark."""

import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

PROBE = r"""
import runpy, sys
sys.argv = ["run.py"]
sys.path.insert(0, {root!r})
g = runpy.run_path({run!r}, run_name="portbench_probe")
from portbench import harness
bench = harness.manifest()
for w in bench["workloads"]:
    harness.load_cell(w["name"], bench)
for m in bench["per_layer"]:
    harness.load_module(harness.BENCH / "metrics" / (m["name"] + ".py"))
import portbench.calibrate
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_and_no_jax_package_loaded():
    code = PROBE.format(root=str(ROOT), run=str(BENCH / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "slr_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "slr"}


def test_forbidden_names_compared_whole():
    from portbench import harness

    assert harness.forbidden_modules(["slr_torch", "slr_torch.pipeline", "jaxtyping"]) == []
    assert harness.forbidden_modules(["slr.codec", "jax.numpy", "flax"]) == ["flax", "jax", "slr"]


def test_no_source_reads_the_jax_era_benchmark():
    pat = re.compile(r"\bbench\.py\b|\bbenchmarks/|\bchip_smoke\b|^\s*(import|from)\s+(jax|slr)\b")
    for path in BENCH.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            if pat.search(line):
                # only comments and docstrings may name them, as sources cited
                stripped = line.strip()
                assert not re.match(r"^(import|from)\s+(jax|slr)\b", stripped), (path, line)
                assert "open(" not in line and "read_text" not in line, (path, line)
