"""Importing posebyte_tpu_torch must stay light (mirrors
tests/test_import_hygiene.py): no JAX, no optax, no JAX package, no
safetensors, no cv2, no triton; no CUDA context, no process group; no
kernel build and no native build. The operator posebyte::conv_w8a8, which
an exported engine calls (models/aot.py), is registered by the import,
with the same conditions. Run in a fresh interpreter, since this
test process has imported JAX already.

cv2 is absent on the card's host: a module-level `import cv2` is forbidden
everywhere in the port, and an import inside a function only in the two
modules whose functions read or write images with it, utils/video.py and
models/quant.py (_load_calibration_images), as the JAX package has them.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_import_is_light(tmp_path):
    build = tmp_path / "build"
    code = (
        "import sys, torch;"
        "import posebyte_tpu_torch, posebyte_tpu_torch.core,"
        " posebyte_tpu_torch.ops, posebyte_tpu_torch.models,"
        " posebyte_tpu_torch.tracker, posebyte_tpu_torch.pipeline,"
        " posebyte_tpu_torch.pipeline.serving,"
        " posebyte_tpu_torch.pipeline.frontend,"
        " posebyte_tpu_torch.models.oracle,"
        " posebyte_tpu_torch.utils.synthetic,"
        " posebyte_tpu_torch.cli.demo, posebyte_tpu_torch.cli.evaluate,"
        " posebyte_tpu_torch.cli.export, posebyte_tpu_torch.cli.benchmark,"
        " posebyte_tpu_torch.utils.video,"
        " posebyte_tpu_torch.utils.evaluation,"
        " posebyte_tpu_torch.utils.native,"
        " posebyte_tpu_torch.utils.profiling,"
        " posebyte_tpu_torch.models.train, posebyte_tpu_torch.models.optim,"
        " posebyte_tpu_torch.parallel, posebyte_tpu_torch.parallel.train,"
        " posebyte_tpu_torch.parallel.sharding,"
        " posebyte_tpu_torch.scripts.train_synthetic,"
        " posebyte_tpu_torch.scripts.train_reid,"
        " posebyte_tpu_torch.models.engine, posebyte_tpu_torch.models.aot,"
        " posebyte_tpu_torch.ops.legacy_nms, posebyte_tpu_torch.ops.topk,"
        " posebyte_tpu_torch.tracker.debug;"
        "import torch.distributed as dist;"
        "assert hasattr(torch.ops.posebyte, 'conv_w8a8');"
        "assert posebyte_tpu_torch.models.YoloPoseEngine.__name__"
        " == 'YoloPoseEngine';"
        "bad = [m for m in ('jax', 'flax', 'optax', 'posebyte_tpu',"
        " 'safetensors', 'cv2', 'triton') if m in sys.modules];"
        "assert not bad, bad;"
        "assert not torch.cuda.is_initialized();"
        "assert not dist.is_initialized();"
        "print('CLEAN')"
    )
    env = {**os.environ, "POSEBYTE_CUDA_BUILD_DIR": str(build / "cuda"),
           "POSEBYTE_NATIVE_BUILD_DIR": str(build / "native")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "CLEAN" in r.stdout, r.stderr[-2000:]
    assert not build.exists()


@pytest.mark.parametrize("module", [
    "posebyte_tpu_torch.tracker", "posebyte_tpu_torch.tracker.output",
    "posebyte_tpu_torch.ops.tracker_chunk", "posebyte_tpu_torch.cli.demo",
    "posebyte_tpu_torch.parallel", "posebyte_tpu_torch.parallel.train",
    "posebyte_tpu_torch.scripts.train_synthetic",
    "posebyte_tpu_torch.scripts.train_reid",
    "posebyte_tpu_torch.models.engine", "posebyte_tpu_torch.models.aot",
    "posebyte_tpu_torch.ops.legacy_nms", "posebyte_tpu_torch.tracker.debug",
    "posebyte_tpu_torch.ops.decode"])
def test_module_imports_first(module):
    """Each module imports in a fresh interpreter before any other part of
    the port (tracker.step imports ops, whose package imports
    ops.tracker_chunk: its own import of the tracker must wait for a
    call)."""
    r = subprocess.run([sys.executable, "-c", f"import {module}"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


# A module-level import of any of these, or PyTorch's extension headers,
# anywhere in the port; cv2 inside a function only in CV2_MODULES.
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|posebyte_tpu|"
                       r"safetensors|cv2)\b|cpp_extension|"
                       r"torch/extension\.h")
TOP_LEVEL_CV2 = re.compile(r"^(import|from)\s+cv2\b")
CV2_MODULES = ("posebyte_tpu_torch/utils/video.py",
               "posebyte_tpu_torch/models/quant.py")


def refused(line: str, rel: str) -> bool:
    """Whether the rule refuses `line` of the port's file `rel`."""
    m = FORBIDDEN.search(line)
    return bool(m) and not (m.group(2) == "cv2" and rel in CV2_MODULES
                            and not TOP_LEVEL_CV2.match(line))


def test_port_sources_name_no_jax():
    """No module of the port imports JAX, optax, the JAX package,
    safetensors or cv2 at module level, and no kernel source pulls in
    PyTorch's extension headers; cv2 is imported inside a function only
    in CV2_MODULES."""
    roots = [os.path.join(REPO, "posebyte_tpu_torch"),
             os.path.join(REPO, "chip_smoke.py")]
    hits = []
    for root in roots:
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith((".py", ".cu", ".cuh"))]
        for path in files:
            rel = os.path.relpath(path, REPO)
            with open(path) as fh:
                hits += [f"{path}:{i}" for i, line in enumerate(fh, 1)
                         if refused(line, rel)]
    assert not hits, hits


def test_cv2_rule_catches_what_it_forbids():
    """The rule on lines it must refuse and lines it must allow."""
    video, demo = CV2_MODULES[0], "posebyte_tpu_torch/cli/demo.py"
    assert not refused("        import cv2\n", video)
    assert refused("import cv2\n", video)
    assert refused("from cv2 import imread\n", video)
    assert refused("    import cv2\n", demo)
    assert refused("    import jax\n", video)
    assert refused("    import optax\n", demo)
    assert refused("#include <torch/extension.h>\n", video)
    assert not refused("x = _cv2()\n", demo)
