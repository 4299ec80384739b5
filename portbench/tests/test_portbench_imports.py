"""The import check: whole top-level names, and nothing of JAX or the JAX
package loaded by the harness, its drivers or the reference."""

import os
import re
import subprocess
import sys

from conftest import PB, ROOT

from pblib.harness import banned_modules

IMPORT = re.compile(r"^\s*(from|import)\s+(surtr_tpu|jax|flax)\b", re.M)


def test_top_level_names_compared_whole():
    assert banned_modules(["surtr_tpu_torch", "surtr_tpu_torch.ops.clip", "plainref"]) == []
    assert banned_modules(["surtr_tpu.ops"]) == ["surtr_tpu"]
    assert banned_modules(["jaxlib.xla_client", "flax.linen", "jax"]) == ["flax", "jax", "jaxlib"]
    assert banned_modules(["jaxtyping", "flaxen", "surtr_tpux"]) == []


def test_harness_drivers_and_reference_load_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import pblib.harness as h\n"
        "for d in ('decompose', 'impact', 'frames'):\n"
        "    h.load_file(%r + '/drivers/' + d + '.py', d)\n"
        "import control, plainref.scene, plainref.fracture.pipeline\n"
        "import surtr_tpu_torch.scene, surtr_tpu_torch.fracture.pipeline\n"
        "print(h.banned_modules())\n" % (PB, ROOT, PB))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_never_names_the_program():
    for d, _, files in os.walk(os.path.join(PB, "plainref")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    text = fh.read()
                assert not IMPORT.search(text), f
