"""The port stands alone: no JAX and no ``surtr_tpu`` import in its source
(the package, ``chip_smoke.py`` and its kernel timing tools), and importing
it pulls in neither."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "surtr_tpu_torch")


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    tools = os.path.join(REPO, "tools")
    for f in os.listdir(tools):
        if f.startswith("time_b") and f.endswith(".py"):
            yield os.path.join(tools, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_neither_jax_nor_surtr_tpu(path):
    with open(path) as fh:
        src = fh.read()
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|surtr_tpu)(\.|\s|$)", re.M)
    assert not bad.search(src), bad.search(src).group(0)


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import surtr_tpu_torch, surtr_tpu_torch.fracture.pipeline, surtr_tpu_torch.convert\n"
        "import surtr_tpu_torch.ops.clip_cuda, surtr_tpu_torch.ops.hull_cuda\n"
        "import surtr_tpu_torch.ops.labels_cuda, surtr_tpu_torch.ops.refit_cuda\n"
        "import surtr_tpu_torch.ops.soup_clip_cuda, surtr_tpu_torch.ops.mesh_clip\n"
        "import surtr_tpu_torch.physics.step, surtr_tpu_torch.physics.pack_cuda\n"
        "import surtr_tpu_torch.physics.narrowphase_cuda, surtr_tpu_torch.physics.prep_cuda\n"
        "import surtr_tpu_torch.physics.solver_cuda, surtr_tpu_torch.physics.slots\n"
        "import surtr_tpu_torch.workload, surtr_tpu_torch.scene, surtr_tpu_torch.checkpoint\n"
        "import surtr_tpu_torch.render.camera, surtr_tpu_torch.render.raster\n"
        "import surtr_tpu_torch.render.raster_cuda, surtr_tpu_torch.physics.queries\n"
        "import surtr_tpu_torch.__main__, surtr_tpu_torch.profiling\n"
        "import surtr_tpu_torch.fracture.batch, surtr_tpu_torch.physics.batch\n"
        "import surtr_tpu_torch.ops.delaunay, surtr_tpu_torch.ops.delaunay2d\n"
        "import surtr_tpu_torch.ops.hull, surtr_tpu_torch.ops.moments, surtr_tpu_torch.io.models\n"
        "import surtr_tpu_torch.io.obj\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'surtr_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_kernel_build_is_lazy():
    # Importing every module must not build or load the CUDA library (this
    # machine may have no nvcc); the build happens at the first launch.
    from surtr_tpu_torch import _build

    assert _build._lib is None
    assert _build.BUILD_DIR.endswith(os.path.join("build", "surtr_tpu_torch"))
