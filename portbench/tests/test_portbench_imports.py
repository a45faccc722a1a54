"""Nothing the benchmark loads is JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port.  Each check runs in a fresh
interpreter so that no other test's imports count."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ["jax", "jaxlib", "flax", "effectivediffusivityfvm_tpu"]


def loaded_tops(code: str) -> set:
    script = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    tops = loaded_tops(
        "from pathlib import Path\n"
        "from portbench import harness, control, trace, work, gen\n"
        "for f in sorted(Path('portbench/metrics').glob('*.py')):\n"
        "    harness.load_metric(f.stem)\n"
        "plan = harness.cell_plan(harness.benchmark(), 'jacobi128-b256')\n"
        "plan.traffic.update(images_per_call=2, size=32, pool_calls=1)\n"
        "harness.run_cell(plan, 3, 0.01, False, 'cpu', 0.0)\n"
        "plan = harness.cell_plan(harness.benchmark(), 'mgcg512-b64')\n"
        "plan.traffic.update(batch=2, size=32, pool_batches=1)\n"
        "harness.run_cell(plan, 3, 0.01, True, 'cpu', 0.0)\n")
    assert "effectivediffusivityfvm_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_tops("from portbench.reference import fvm2d, "
                       "jacobi\n")
    assert not tops & set(FORBIDDEN + ["effectivediffusivityfvm_tpu_torch"])
